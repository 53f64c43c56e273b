"""Null-text inversion (registry key "nti").

Counterpart of eta_inversion_tpu/inversion/nti.py: after a DDIM inversion,
optimize the *unconditional* embedding per timestep so that the CFG denoising
step reproduces the recorded forward trajectory.  Adam with lr =
1e-2 * (1 - i/100), betas (0.9, 0.999), eps 1e-8 and bias correction, up to
`num_inner_steps` (10) inner iterations; the loop stops when the pre-update
loss drops below `early_stop_epsilon + i * 2e-5`, and the update of the
iteration that triggered the stop is still applied; the optimized embedding
warm-starts the next timestep, then one denoise step with it gives the next
latent.  The UNet's output goes through `to_eps` (v-prediction).  With added
conditioning (SDXL) the packed row past the 77 text rows is fixed
conditioning, not a parameter: it is put back after every update, as JAX's
`opt_rows` does.

The JAX `lax.scan` / `lax.while_loop` / `jax.grad` become Python loops and
`torch.autograd.grad` with respect to the embedding alone (the nets keep
`requires_grad=False`).  On the card the gradient runs through the flash
attention kernels' backward (K4a / K4b, ops/flash_attention.py).  The
engine's public calls run under `torch.inference_mode()`, whose tensors
cannot be saved for backward: the optimization leaves it and works on
clones.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .base import DiffusionInversion


class NullTextInversion(DiffusionInversion):
    name = "nti"

    dft_num_inner_steps = 10
    dft_early_stop_epsilon = 1e-5

    def __init__(self, model, scheduler=None, num_inference_steps=None,
                 guidance_scale_bwd=None, guidance_scale_fwd=None, verbose: bool = False,
                 num_inner_steps: Optional[int] = None,
                 early_stop_epsilon: Optional[float] = None, seed: int = 0, noise_fn=None):
        super().__init__(model, scheduler, num_inference_steps, guidance_scale_bwd,
                         guidance_scale_fwd, verbose=verbose, seed=seed, noise_fn=noise_fn)
        self.num_inner_steps = num_inner_steps or self.dft_num_inner_steps
        self.early_stop_epsilon = early_stop_epsilon or self.dft_early_stop_epsilon

    def null_optimization(self, latents, context) -> Dict[str, Any]:
        """Optimize per-step uncond embeddings.  latents: (S+1, 1, c, h, w)
        from the forward pass; context: [uncond; cond].  Returns
        {"uncond_embeddings": (S, 1, 77, D), "inner_steps": [iterations per
        step], "losses": [[pre-update loss per iteration] per step]}."""
        ts = self.schedule.timesteps_backward
        ucfg = self.model.preset.unet
        opt_rows = ucfg.context_tokens if ucfg.addition_embed else None

        def unet(lat, t, ctx):
            return self.to_eps(self.model.unet(lat, t, ctx), lat, t)

        with torch.inference_mode(False), torch.enable_grad():
            latents, context = latents.clone(), context.clone()
            uncond, cond = context.chunk(2)
            uncond0 = uncond
            latent_prev_all = torch.flip(latents, dims=[0])[1:]  # step i's target
            latent_cur = latents[-1]
            out, inner_steps, losses = [], [], []
            for i, t in enumerate(ts):
                t = int(t)
                lr = 1e-2 * (1.0 - i / 100.0)
                thresh = self.early_stop_epsilon + i * 2e-5
                with torch.no_grad():
                    eps_cond = unet(latent_cur, t, cond)
                m, v = torch.zeros_like(uncond), torch.zeros_like(uncond)
                step_losses = []
                while len(step_losses) < self.num_inner_steps and (
                        not step_losses or step_losses[-1] >= thresh):
                    u = uncond.detach().requires_grad_(True)
                    eps_u = unet(latent_cur, t, u)
                    eps = eps_u + self.guidance_scale_bwd * (eps_cond - eps_u)
                    rec = self.step_backward(eps, t, latent_cur)
                    loss = torch.mean((rec - latent_prev_all[i]) ** 2)
                    (g,) = torch.autograd.grad(loss, u)
                    # torch.optim.Adam's update, in the embedding's dtype
                    j = len(step_losses) + 1
                    m = 0.9 * m + 0.1 * g
                    v = 0.999 * v + 0.001 * g * g
                    mh = m / (1.0 - 0.9 ** j)
                    vh = v / (1.0 - 0.999 ** j)
                    uncond = (u - lr * mh / (torch.sqrt(vh) + 1e-8)).detach()
                    if opt_rows is not None:  # the packed row stays fixed
                        uncond[:, opt_rows:] = uncond0[:, opt_rows:]
                    step_losses.append(loss.item())
                with torch.no_grad():  # denoise one step with the optimized embedding
                    eps_u = unet(latent_cur, t, uncond)
                    eps = eps_u + self.guidance_scale_bwd * (eps_cond - eps_u)
                    latent_cur = self.step_backward(eps, t, latent_cur)
                out.append(uncond)
                inner_steps.append(len(step_losses))
                losses.append(step_losses)
        return {"uncond_embeddings": torch.stack(out), "inner_steps": inner_steps,
                "losses": losses}

    @torch.inference_mode()
    def invert(self, image, prompt=None, context=None, guidance_scale_fwd=None,
               **kwargs) -> Dict[str, Any]:
        res = super().invert(image, prompt, context, guidance_scale_fwd, **kwargs)
        opt = self.null_optimization(res["latents"], res["context"])
        self.last_inner_steps = opt["inner_steps"]
        res["uncond_embeddings"] = opt["uncond_embeddings"]
        res["nti_inner_steps"], res["nti_losses"] = opt["inner_steps"], opt["losses"]
        return res
