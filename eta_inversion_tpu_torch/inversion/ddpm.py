"""Edit-friendly DDPM inversion (registry keys "ddpminv", "cyclediff").

Counterpart of eta_inversion_tpu/inversion/ddpm.py (Huberman-Spiegelglas et
al.): sample the noised trajectory {x_t}, extract each step's noisemap z,
and replay them while denoising with eta 1; skip_steps 0.36, forward CFG 3.5
/ backward CFG 9, and per-branch guidance [fwd, bwd] over the [sources,
targets] rows.  cyclediff is the markovian trajectory (x_t from x_{t-1}).

The trajectory is drawn before any UNet call, so the S UNet evaluations of
the inversion are independent: they run batched over timesteps, `fwd_chunk`
(10, or the largest divisor of S below it) steps of B rows, both CFG
branches, per-row timesteps, in one UNet call (2 chunk B rows), which gives
the results of a sequential forward.  The first noisemap is zeroed.

Draws: the trajectory's standard-normal noise comes from the engine's
`_drawer` seeded with `forward_seed` (an injected `noise_fn` takes its
place): ddpminv makes one draw of (S, B, c, h, w), cyclediff one of (B, c,
h, w) a step, step j of the ascending timesteps as draw j.  The backward
draws nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..schedulers import ddim_backward_step, ddpm_inverse_step, sample_trajectory
from .base import DiffusionInversion


class DDPMInversion(DiffusionInversion):
    name = "ddpminv"

    dft_skip_steps = 0.36
    dft_forward_seed = 0

    def __init__(self, model, scheduler=None, num_inference_steps=None,
                 guidance_scale_bwd=None, guidance_scale_fwd=None, verbose: bool = False,
                 forward_seed: Optional[int] = 0, skip_steps: Optional[float] = None,
                 markovian_forward: bool = False, fwd_chunk: int = 10, seed: int = 0,
                 noise_fn=None):
        scheduler = scheduler or "ddpm"
        guidance_scale_fwd = guidance_scale_fwd or 3.5
        guidance_scale_bwd = guidance_scale_bwd or 9
        self.skip_steps = skip_steps or self.dft_skip_steps
        self.forward_seed = forward_seed if (forward_seed is None or forward_seed >= 0) else None
        self.markovian_forward = markovian_forward
        if fwd_chunk < 1:
            raise ValueError(f"fwd_chunk {fwd_chunk}: at least 1")
        self.fwd_chunk = fwd_chunk
        super().__init__(model, scheduler, num_inference_steps, guidance_scale_bwd,
                         guidance_scale_fwd, verbose=verbose, seed=seed, noise_fn=noise_fn)

    # --------------------------------------------------------------- forward

    def diffusion_forward(self, latent, context, guidance_scale_fwd=None,
                          ctrl=None) -> Dict[str, Any]:
        gs = self.guidance_scale_fwd if guidance_scale_fwd is None else guidance_scale_fwd
        S = self.num_inference_steps
        ts_asc = self.schedule.timesteps_forward()
        # steps of one batched UNet call: the largest divisor of S up to fwd_chunk
        chunk = max(c for c in range(1, min(self.fwd_chunk, S) + 1) if S % c == 0)
        draw = self._drawer(None, self.seed if self.forward_seed is None else self.forward_seed)
        shape = tuple(latent.shape)
        if self.markovian_forward:
            noise = torch.stack([draw(j, shape) for j in range(S)])
        else:
            noise = draw(0, (S,) + shape)
        xts = sample_trajectory(self.schedule, latent, noise, markovian=self.markovian_forward)
        # step i (ascending t): x_t = xts[S-1-i], x_{t-1} = xts[S-i]
        xt_all = torch.flip(xts[:S], dims=[0])
        xtm1_all = torch.flip(xts[1:], dims=[0])
        b = latent.shape[0]
        n = context.shape[0] // 2
        ctx = torch.cat([context[:n].repeat(chunk, 1, 1), context[n:].repeat(chunk, 1, 1)])
        new_latents, eps_steps, z_steps = [], [], []
        for c0 in range(0, S, chunk):
            # the chunk's independent steps through one UNet call, full CFG
            # (the reference's is_fwd=False call), per-row timesteps
            xt = xt_all[c0:c0 + chunk].reshape((chunk * b,) + shape[1:])
            t = torch.as_tensor(ts_asc[c0:c0 + chunk], device=latent.device)
            t = t.repeat_interleave(b)
            eps_all = self.model.unet(torch.cat([xt, xt]), torch.cat([t, t]), ctx)
            eps_u, eps_c = eps_all[:chunk * b], eps_all[chunk * b:]
            # a v-prediction converts after the CFG combination, with which it
            # commutes, against each row's own x_t and t
            eps = self.to_eps(eps_u + gs * (eps_c - eps_u), xt, t).reshape((chunk,) + shape)
            for j in range(chunk):
                i = c0 + j
                xtm1, z = ddpm_inverse_step(self.schedule, eps[j], int(ts_asc[i]), xt_all[i],
                                            xtm1_all[i])
                new_latents.append(xtm1)
                eps_steps.append(eps[j])
                z_steps.append(z)
        z_steps[0] = torch.zeros_like(z_steps[0])  # the first (t = min) noisemap
        return {"latents": torch.stack(new_latents + [xts[0]]),
                "noise_preds": torch.stack(eps_steps),
                "variance_noises": torch.stack(z_steps),
                "etas": torch.ones(S, device=latent.device), "zT_inv": xts[0]}

    # -------------------------------------------------------------- backward

    def get_bwd_skip(self) -> int:
        return int(self.skip_steps * self.num_inference_steps)

    def skip_inv_result(self, inv_result: Dict[str, Any]) -> Dict[str, Any]:
        """The inversion result without its last `get_bwd_skip()` steps."""
        skip = self.get_bwd_skip()
        out = dict(inv_result)
        for k in ("latents", "noise_preds", "variance_noises", "etas"):
            out[k] = inv_result[k][:-skip] if skip else inv_result[k]
        return out

    @torch.inference_mode()
    def sample(self, inv_result, prompt=None, context=None, ctrl=None, rng=None):
        if inv_result is None:
            return None
        if self.skip_steps is not None:
            inv_result = self.skip_inv_result(inv_result)
        return super().sample(inv_result, prompt=prompt, context=context, ctrl=ctrl, rng=rng)

    def backward_timesteps(self, inv_result):
        return self.schedule.timesteps_backward[self.get_bwd_skip():]

    def backward_extras(self, inv_result):
        extras = super().backward_extras(inv_result)
        extras["eta"] = torch.flip(inv_result["etas"], dims=[0])
        extras["variance_noise"] = torch.flip(inv_result["variance_noises"], dims=[0])
        return extras

    def combine_guidance(self, eps_u, eps_c, guidance_scale, latent, t, is_fwd=False):
        # per-branch guidance over [source(s), target(s)]: the sources keep
        # the forward scale
        n = eps_u.shape[0]
        if not is_fwd and n >= 2 and n % 2 == 0:
            half = n // 2
            gs = torch.tensor([self.guidance_scale_fwd] * half + [self.guidance_scale_bwd] * half,
                              dtype=eps_u.dtype, device=eps_u.device).reshape(n, 1, 1, 1)
            return eps_u + gs * (eps_c - eps_u)
        return eps_u + guidance_scale * (eps_c - eps_u)

    def step_backward(self, eps, t, latent, i=0, extras=None, draw=None):
        vn = extras["variance_noise"][i]
        if vn.shape[0] > 1 and latent.shape[0] == 2 * vn.shape[0]:
            vn = torch.cat([vn, vn])  # each [s_i, t_i] pair replays its own noisemap
        return ddim_backward_step(self.schedule, latent, eps, t, eta=extras["eta"][i], noise=vn)
