"""DiffusionInversion: the inversion / denoising engine.

Counterpart of eta_inversion_tpu/inversion/base.py.  The JAX package's
`lax.scan` bodies are Python loops over steps here; controllers keep their
state in plain dicts of tensors.  Latents are NCHW fp32 on the model's
device; images are NHWC [-1, 1] at the public boundary.

Randomness: every draw of the backward loop goes through `_drawer`, which
takes the injected `noise_fn(i, shape)` when one is given (tests feed the JAX
draws this way), else a `torch.Generator` on the device seeded with seed + 1.

Schedulers: "ddim"; "ddpm", whose backward is DDIM with eta 1 and one draw
per step through `_drawer`; and "dpm", DPM-Solver++ of `solver_order` 1/2/3
(schedulers/dpm.py), whose inverse defaults to the "samesame" steps.  The
DPM order ramp and lower_order_final are decided per step on the host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..editing.controller import BatchLayout, Controller, ControllerEmpty
from ..schedulers import (DiffusionSchedule, ddim_backward_step, ddim_inverse_step,
                          dpm_init_state, dpm_plan, dpm_step, dpm_timesteps_backward,
                          dpm_timesteps_forward)

NoiseFn = Callable[[int, tuple], torch.Tensor]


class DiffusionInversion:
    """Naive DDIM inversion (registry key "diffinv") and the base engine."""

    name = "diffinv"
    # True for inverters whose backward step snaps the first B latent rows to
    # the forward trajectory; they need the [src rows; tgt rows] layout
    requires_source_rows: bool = False

    def __init__(self, model, scheduler: Optional[str] = None,
                 num_inference_steps: Optional[int] = None,
                 guidance_scale_bwd: Optional[float] = None,
                 guidance_scale_fwd: Optional[float] = None,
                 inv_steps: str = "sameshift", verbose: bool = False, seed: int = 0,
                 solver_order: int = 2, noise_fn: Optional[NoiseFn] = None):
        self.model = model
        self.device = model.device
        self.scheduler_name = scheduler or "ddim"
        if self.scheduler_name not in self.get_available_schedulers():
            raise ValueError(f"unknown scheduler {self.scheduler_name}")
        if solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order {solver_order}: 1, 2 or 3")
        self.solver_order = solver_order  # dpm only
        # "ddpm" denoises with DDIM at eta 1
        self.eta_bwd = 1.0 if self.scheduler_name == "ddpm" else 0.0
        if self.scheduler_name == "dpm" and inv_steps == "sameshift":
            inv_steps = "samesame"  # the DPM inverse scheduler's default
        self.num_inference_steps = num_inference_steps or 50
        self.guidance_scale_bwd = 7.5 if guidance_scale_bwd is None else guidance_scale_bwd
        self.guidance_scale_fwd = 1.0 if guidance_scale_fwd is None else guidance_scale_fwd
        self.inv_steps = inv_steps
        self.verbose = verbose  # kept as the JAX engine keeps it; nothing reads it
        self.seed = seed
        self.noise_fn = noise_fn
        self.schedule = DiffusionSchedule(model.schedule_config, self.num_inference_steps)

    @staticmethod
    def get_available_schedulers() -> List[str]:
        return ["ddim", "ddpm", "dpm"]

    # ---------------------------------------------------------------- codecs

    def encode(self, image) -> torch.Tensor:
        """NHWC (or HWC) [-1, 1] image -> scaled posterior-mean latent, NCHW
        fp32."""
        image = torch.as_tensor(image, device=self.device).float()
        if image.dim() == 3:
            image = image[None]
        if image.dim() != 4 or image.shape[-1] != 3:
            raise ValueError(f"expected NHWC image with 3 channels, got shape "
                             f"{tuple(image.shape)}")
        z = self.model.vae.encode(image.permute(0, 3, 1, 2))
        return (z * self.model.scaling_factor).float()

    def decode(self, latent) -> torch.Tensor:
        """NCHW latent -> NHWC image in the model dtype."""
        x = self.model.vae.decode(latent / self.model.scaling_factor)
        return x.permute(0, 2, 3, 1)

    def create_context(self, prompt: str, negative_prompt: Optional[str] = "") -> torch.Tensor:
        """[uncond; cond] embeddings, shape (2, 77, D)."""
        cond = self.model.encode_text(self.model.tokenizer([prompt]))
        if negative_prompt is None:
            return cond
        uncond = self.model.encode_text(self.model.tokenizer([negative_prompt]))
        return torch.cat([uncond, cond], dim=0)

    def embed_texts(self, prompts: List[str]) -> torch.Tensor:
        """N prompts -> (N, 77, D) embeddings in one text-encoder call."""
        return self.model.encode_text(self.model.tokenizer(list(prompts)))

    def cat_context(self, contexts: List[torch.Tensor]) -> torch.Tensor:
        """[[u1,c1],[u2,c2]] -> [u1,u2,c1,c2]."""
        n = len(contexts)
        b = contexts[0].shape[0]
        if b != 2:
            raise ValueError("cfg context should have batch dimension 2")
        x = torch.stack(contexts, dim=1)
        return x.reshape(b * n, *x.shape[2:])

    def cat_latent(self, latents: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(latents, dim=0)

    def flat_latent(self, z0: torch.Tensor) -> torch.Tensor:
        """Flat (rows, c, h, w) view of a diffusion_backward result.  The
        coupled-pair inverter (edict) selects its output chain, so editors
        and `sample` always see row-batched latents."""
        return z0

    # ------------------------------------------------------------- primitives

    def combine_guidance(self, eps_u, eps_c, guidance_scale, latent, t: int,
                         is_fwd: bool = False):
        """CFG combination; the override point of proximal guidance and
        per-branch scales."""
        return eps_u + guidance_scale * (eps_c - eps_u)

    def to_eps(self, out, x, t):
        """A raw UNet output in epsilon space under the schedule's
        prediction_type, so every inverter and editor works on noise
        predictions whatever the family's parameterisation.  v_prediction
        (SD-2.1 768-v): eps = sqrt(a_t) v + sqrt(1 - a_t) x_t, diffusers'
        DDIMScheduler's `pred_epsilon`; affine with coefficients summing to 1,
        so it commutes with the CFG combination.  `t` an int or a (rows,)
        tensor of per-row timesteps."""
        if self.schedule.config.prediction_type != "v_prediction":
            return out
        if isinstance(t, torch.Tensor) and t.dim() > 0:
            a = torch.stack([self.schedule.alpha_at(int(s)) for s in t.tolist()])
            a = a.to(out.device).reshape((-1,) + (1,) * (out.dim() - 1))
        else:
            a = self.schedule.alpha_at(t).to(out.device)
        return (torch.sqrt(a) * out.float() + torch.sqrt(1.0 - a) * x.float()).to(out.dtype)

    def predict_noise(self, latent, t: int, context, guidance_scale, hooks=None,
                      collect_store: bool = False, force_full_cfg: bool = False,
                      is_fwd: bool = False):
        """UNet noise prediction with classifier-free guidance.  Returns
        (eps, store) where store maps store keys to the probabilities the
        hooks asked to record (empty unless collect_store).  `is_fwd` marks
        a call of the forward (inversion) loop, for `combine_guidance`.  A
        v-prediction output is converted (`to_eps`) before the combination,
        each guidance half against its own latent rows."""
        store: Dict[str, torch.Tensor] = {}
        st = store if collect_store else None
        # a hooks' UNet row plan (pnp): gather the UNet's rows before the call
        # and re-expand eps after it
        in_rows = None if hooks is None else hooks.unet_in_rows
        out_rows = None if hooks is None else hooks.unet_out_rows

        def unet(lat, ctx, shared_prefix=False):
            if in_rows is not None:
                idx = torch.as_tensor(in_rows, device=lat.device)
                lat, ctx = lat[idx], ctx[idx]
            eps = self.model.unet(lat, t, ctx, hooks=hooks, store=st,
                                  cfg_shared_prefix=shared_prefix)
            if out_rows is not None:
                eps = eps[torch.as_tensor(out_rows, device=eps.device)]
            return eps

        scalar_gs = isinstance(guidance_scale, (int, float)) and not force_full_cfg
        n = context.shape[0] // 2
        if guidance_scale is None:
            eps = self.to_eps(unet(latent, context), latent, t)
        elif scalar_gs and guidance_scale == 0:
            eps = self.to_eps(unet(latent, context[:n]), latent, t)
        elif scalar_gs and guidance_scale == 1:
            eps = self.to_eps(unet(latent, context[n:]), latent, t)
        else:
            if latent.shape[0] * 2 == context.shape[0]:
                # both guidance halves carry the same latent: with a hook-free
                # prefix the UNet runs it once (exact, see models/unet.py)
                if self._cfg_prefix_ok(hooks):
                    eps_all = unet(latent, context, shared_prefix=True)
                else:
                    eps_all = unet(torch.cat([latent, latent], dim=0), context)
            else:
                eps_all = unet(latent, context)
            x_u, x_c = (latent[:n], latent[n:]) if latent.shape[0] == 2 * n else (latent, latent)
            eps = self.combine_guidance(self.to_eps(eps_all[:n], x_u, t),
                                        self.to_eps(eps_all[n:], x_c, t), guidance_scale,
                                        latent, t, is_fwd=is_fwd)
        return eps, store

    def _cfg_prefix_ok(self, hooks) -> bool:
        """Is the CFG shared prefix exact for these hooks?  With no hooks, or
        hooks that provably leave the UNet's prefix through the first
        self-attention layer alone (AttnHooks.cfg_prefix_safe) and carry no
        batch-restructuring plan (`unet_in_rows`).  Never with added
        conditioning (SDXL): the pooled text embedding tells the rows apart
        from the first resnet."""
        if self.model.preset.unet.addition_embed:
            return False
        if hooks is None:
            return True
        if hooks.unet_in_rows is not None:
            return False
        metas = [m for pair in self.model.attn_metas.values() for m in pair if not m.is_cross]
        if not metas:
            return False
        return hooks.cfg_prefix_safe(min(metas, key=lambda m: m.idx))

    def step_forward(self, eps, t, latent):
        return ddim_inverse_step(self.schedule, latent, eps, t, self.inv_steps)

    def step_backward(self, eps, t, latent, i: int = 0, extras: Optional[Dict[str, Any]] = None,
                      draw: Optional[NoiseFn] = None):
        """Denoising step i at t; "ddpm" draws its variance noise, one draw of
        the latent's shape a step."""
        if self.eta_bwd:
            return ddim_backward_step(self.schedule, latent, eps, t, eta=self.eta_bwd,
                                      noise=draw(i, tuple(latent.shape)))
        return ddim_backward_step(self.schedule, latent, eps, t)

    def scheduler_step(self, is_fwd: bool, i: int, t: int, eps, latent,
                       run: Dict[str, Any], draw: Optional[NoiseFn] = None):
        """Step i of a loop: DPM-Solver++ (its multistep state in run["dpm"],
        its per-step targets in run["dpm_plan"]), else `step_forward` /
        `step_backward`."""
        if self.scheduler_name == "dpm":
            prev_t, is_last, is_second_last = run["dpm_plan"][i]
            latent, run["dpm"] = dpm_step(self.schedule, run["dpm"], latent, eps, t, prev_t,
                                          is_last, is_second_last, self.solver_order)
            return latent
        if is_fwd:
            return self.step_forward(eps, t, latent)
        return self.step_backward(eps, t, latent, i, run, draw)

    def _run_state(self, ts: np.ndarray, is_fwd: bool) -> Dict[str, Any]:
        """A loop's scheduler state: DPM's plan and multistep state."""
        if self.scheduler_name != "dpm":
            return {}
        return {"dpm_plan": dpm_plan(self.schedule, ts, is_fwd), "dpm": dpm_init_state()}

    def _drawer(self, rng: Optional[Union[torch.Generator, NoiseFn]], seed: int) -> NoiseFn:
        """fn(step, shape) -> standard-normal fp32 draw on the device."""
        if callable(rng):
            return rng
        if self.noise_fn is not None:
            return self.noise_fn
        gen = rng if rng is not None else torch.Generator(self.device).manual_seed(seed)
        return lambda i, shape: torch.randn(shape, generator=gen, device=self.device,
                                            dtype=torch.float32)

    # ------------------------------------------------------------- step bodies

    def predict_step_forward(self, i: int, t: int, latent, state, context, ctrl: Controller,
                             layout: BatchLayout, guidance_scale, run: Dict[str, Any]):
        """Inversion step i at t -> (latent, state, eps): the override point
        of per-step forward variants (regdiffinv regularises eps here)."""
        latent = ctrl.begin_step(i, t, latent, state)
        eps, store = self.predict_noise(latent, t, context, guidance_scale,
                                        hooks=ctrl.hooks(i, state, layout),
                                        collect_store=ctrl.collect_store(), is_fwd=True)
        new_latent = self.scheduler_step(True, i, t, eps, latent, run)
        new_latent, state = ctrl.end_step(i, t, new_latent, eps, store, state)
        return new_latent, state, eps

    def predict_step_backward(self, i: int, t: int, latent, state, context,
                              ctrl: Controller, layout: BatchLayout, extras: Dict[str, Any],
                              draw: NoiseFn):
        latent = ctrl.begin_step(i, t, latent, state)
        context = self.null_context(context, extras, i)
        eps, store = self.predict_noise(latent, t, context, self.guidance_scale_bwd,
                                        hooks=ctrl.hooks(i, state, layout),
                                        collect_store=ctrl.collect_store())
        new_latent = self.scheduler_step(False, i, t, eps, latent, extras, draw)
        return ctrl.end_step(i, t, new_latent, eps, store, state)

    @staticmethod
    def null_context(context, extras: Dict[str, Any], i: int):
        """Per-step null-embedding patch (NPI / NTI): every unconditional row
        of the context is replaced by step i's embedding.  Pair editing
        carries 2B uncond rows ([u_src(B), u_tgt(B)]) for B per-sample
        embeddings: they are tiled so each sample's embedding lands on both
        its src and tgt rows."""
        if extras.get("uncond_emb") is None:
            return context
        n = context.shape[0] // 2
        ue = extras["uncond_emb"][i]
        if ue.dim() == 3 and n % ue.shape[0] == 0 and ue.shape[0] not in (1, n):
            ue = ue.repeat(n // ue.shape[0], 1, 1)
        return torch.cat([ue.to(context.dtype).expand_as(context[:n]), context[n:]])

    def backward_extras(self, inv_result: Dict[str, Any]) -> Dict[str, Any]:
        """Per-run inputs of the backward loop (subclass hook): the per-step
        null embeddings (S, B, 77, D) of an inversion that made them."""
        ue = inv_result.get("uncond_embeddings")
        return {} if ue is None else {"uncond_emb": ue}

    def backward_timesteps(self, inv_result: Dict[str, Any]) -> np.ndarray:
        if self.scheduler_name == "dpm":
            return dpm_timesteps_backward(self.schedule)
        return self.schedule.timesteps_backward

    def forward_timesteps(self) -> np.ndarray:
        if self.scheduler_name == "dpm":
            return dpm_timesteps_forward(self.schedule, self.inv_steps)
        return self.schedule.timesteps_forward(self.inv_steps)

    # ------------------------------------------------------------- main loops

    def _layout(self, n_prompts: int, guidance_scale) -> BatchLayout:
        cfg_dup = guidance_scale is not None and not (
            isinstance(guidance_scale, (int, float)) and guidance_scale in (0, 1))
        return BatchLayout(n_prompts, cfg_dup)

    def diffusion_forward(self, latent, context, guidance_scale_fwd=None,
                          ctrl: Optional[Controller] = None) -> Dict[str, Any]:
        ctrl = ctrl or ControllerEmpty()
        gs = self.guidance_scale_fwd if guidance_scale_fwd is None else guidance_scale_fwd
        layout = self._layout(context.shape[0] // 2, gs)
        state = ctrl.init_state(self, latent, context)
        latents, eps_all = [latent], []
        ts = self.forward_timesteps()
        run = self._run_state(ts, is_fwd=True)
        for i, t in enumerate(ts):
            latent, state, eps = self.predict_step_forward(i, int(t), latent, state, context,
                                                           ctrl, layout, gs, run)
            latents.append(latent)
            eps_all.append(eps)
        return {"latents": torch.stack(latents), "noise_preds": torch.stack(eps_all),
                "zT_inv": latent, "fwd_state": state}

    def diffusion_backward(self, latent, context, inv_result: Dict[str, Any],
                           ctrl: Optional[Controller] = None, rng=None):
        ctrl = ctrl or ControllerEmpty()
        layout = self._layout(context.shape[0] // 2, self.guidance_scale_bwd)
        draw = self._drawer(rng, self.seed + 1)
        ts = self.backward_timesteps(inv_result)
        # the run's inputs and its scheduler state, which the steps update
        extras = {**self.backward_extras(inv_result), **self._run_state(ts, is_fwd=False)}
        state = ctrl.init_state(self, latent, context)
        for i, t in enumerate(ts):
            latent, state = self.predict_step_backward(i, int(t), latent, state, context,
                                                       ctrl, layout, extras, draw)
        return latent

    # --------------------------------------------------------------- user API

    @torch.inference_mode()
    def invert(self, image, prompt: Optional[str] = None, context=None,
               guidance_scale_fwd: Optional[float] = None, **kwargs) -> Dict[str, Any]:
        """image (NHWC [-1, 1]) -> {latents (S+1, B, c, h, w), noise_preds,
        zT_inv, context, ...}."""
        context = context if context is not None else self.create_context(prompt)
        latent = self.encode(image)
        fwd = self.diffusion_forward(latent, context, guidance_scale_fwd)
        fwd["context"] = context
        return {**kwargs, **fwd}

    @torch.inference_mode()
    def sample(self, inv_result: Optional[Dict[str, Any]],
               prompt: Optional[Union[str, List[str]]] = None, context=None,
               ctrl: Optional[Controller] = None, rng=None) -> Optional[Dict[str, Any]]:
        if inv_result is None:
            return None
        latent = inv_result["latents"][-1]
        if context is None:
            context = ([self.create_context(p) for p in prompt]
                       if isinstance(prompt, (list, tuple)) else self.create_context(prompt))
        if isinstance(context, list):
            n = len(context)
            context = self.cat_context(context)
            latent = self.cat_latent([latent] * n)
        z0 = self.diffusion_backward(latent, context, inv_result, ctrl=ctrl, rng=rng)
        # edict's coupled pair (2, rows, ...) -> its output chain, before the
        # decode, so the image rows align with the context rows
        z0 = self.flat_latent(z0)
        return {"image": self.decode(z0), "latent": z0}

    @torch.inference_mode()
    def invert_sample(self, image, prompt: str, rng=None) -> Dict[str, Any]:
        """Invert the image with the prompt and denoise it back with it."""
        context = self.create_context(prompt)
        inv_res = self.invert(image, context=context)
        return self.sample(inv_res, context=context, rng=rng)

    @torch.inference_mode()
    def generate(self, prompt: Optional[str] = None, context=None, rng=None, batch: int = 1,
                 zT: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Text-to-image: denoise from z_T, the given (batch, c, h, w) latent
        or a standard-normal draw of a `torch.Generator` seeded with `seed`
        on the device; `rng` is the denoising loop's (`_drawer`)."""
        if zT is None:
            s = self.model.latent_size
            gen = torch.Generator(self.device).manual_seed(self.seed)
            zT = torch.randn((batch, self.model.latent_channels, s, s), generator=gen,
                             device=self.device)
        zT = torch.as_tensor(zT, device=self.device).float()
        return self.sample({"latents": zT[None]}, prompt=prompt, context=context, rng=rng)
