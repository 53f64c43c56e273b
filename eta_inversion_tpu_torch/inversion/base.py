"""DiffusionInversion: the inversion / denoising engine.

Counterpart of eta_inversion_tpu/inversion/base.py.  The JAX package's
`lax.scan` bodies are Python loops over steps here; controllers keep their
state in plain dicts of tensors.  Latents are NCHW fp32 on the model's
device; images are NHWC [-1, 1] at the public boundary.

Randomness: every draw of the backward loop goes through `_drawer`, which
takes the injected `noise_fn(i, shape)` when one is given (tests feed the JAX
draws this way), else a `torch.Generator` on the device seeded with seed + 1.

Only the DDIM scheduler is ported; "ddpm" and "dpm" raise (ROADMAP).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..editing.controller import BatchLayout, Controller, ControllerEmpty
from ..schedulers import DiffusionSchedule, ddim_backward_step, ddim_inverse_step

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
                 noise_fn: Optional[NoiseFn] = None):
        self.model = model
        self.device = model.device
        self.scheduler_name = scheduler or "ddim"
        if self.scheduler_name in ("ddpm", "dpm"):
            raise NotImplementedError(f"scheduler {self.scheduler_name!r} is not ported "
                                      "yet (ROADMAP, M7)")
        if self.scheduler_name != "ddim":
            raise ValueError(f"unknown scheduler {self.scheduler_name}")
        self.num_inference_steps = num_inference_steps or 50
        self.guidance_scale_bwd = 7.5 if guidance_scale_bwd is None else guidance_scale_bwd
        self.guidance_scale_fwd = 1.0 if guidance_scale_fwd is None else guidance_scale_fwd
        self.inv_steps = inv_steps
        self.verbose = verbose  # kept as the JAX engine keeps it; nothing reads it
        self.seed = seed
        self.noise_fn = noise_fn
        self.schedule = DiffusionSchedule(model.schedule_config, self.num_inference_steps)

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

    # ------------------------------------------------------------- primitives

    def predict_noise(self, latent, t: int, context, guidance_scale, hooks=None,
                      collect_store: bool = False, force_full_cfg: bool = False,
                      is_fwd: bool = False):
        """UNet noise prediction with classifier-free guidance.  Returns
        (eps, store) where store maps store keys to the probabilities the
        hooks asked to record (empty unless collect_store).  `is_fwd` marks
        a call of the forward (inversion) loop, for subclasses."""
        store: Dict[str, torch.Tensor] = {}
        st = store if collect_store else None

        def unet(lat, ctx, shared_prefix=False):
            return self.model.unet(lat, t, ctx, hooks=hooks, store=st,
                                   cfg_shared_prefix=shared_prefix)

        scalar_gs = isinstance(guidance_scale, (int, float)) and not force_full_cfg
        n = context.shape[0] // 2
        if guidance_scale is None:
            eps = unet(latent, context)
        elif scalar_gs and guidance_scale == 0:
            eps = unet(latent, context[:n])
        elif scalar_gs and guidance_scale == 1:
            eps = unet(latent, context[n:])
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
            eps_u, eps_c = eps_all[:n], eps_all[n:]
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        return eps, store

    def _cfg_prefix_ok(self, hooks) -> bool:
        """Is the CFG shared prefix exact for these hooks?  With no hooks, or
        hooks that provably leave the UNet's prefix through the first
        self-attention layer alone (AttnHooks.cfg_prefix_safe) and carry no
        batch-restructuring plan (`unet_in_rows`).  The port's presets have
        no added conditioning, which JAX also checks (SDXL's pooled text
        embedding tells the rows apart from the first resnet)."""
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

    def step_backward(self, eps, t, latent):
        return ddim_backward_step(self.schedule, latent, eps, t)

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

    def predict_step_backward(self, i: int, t: int, latent, state, context,
                              ctrl: Controller, layout: BatchLayout, extras: Dict[str, Any],
                              draw: NoiseFn):
        latent = ctrl.begin_step(i, t, latent, state)
        context = self.null_context(context, extras, i)
        eps, store = self.predict_noise(latent, t, context, self.guidance_scale_bwd,
                                        hooks=ctrl.hooks(i, state, layout),
                                        collect_store=ctrl.collect_store())
        return ctrl.end_step(i, t, self.step_backward(eps, t, latent), eps, store, state)

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
        return self.schedule.timesteps_backward

    def forward_timesteps(self) -> np.ndarray:
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
        for i, t in enumerate(self.forward_timesteps()):
            t = int(t)
            latent = ctrl.begin_step(i, t, latent, state)
            eps, store = self.predict_noise(latent, t, context, gs,
                                            hooks=ctrl.hooks(i, state, layout),
                                            collect_store=ctrl.collect_store(), is_fwd=True)
            latent = self.step_forward(eps, t, latent)
            latent, state = ctrl.end_step(i, t, latent, eps, store, state)
            latents.append(latent)
            eps_all.append(eps)
        return {"latents": torch.stack(latents), "noise_preds": torch.stack(eps_all),
                "zT_inv": latent, "fwd_state": state}

    def diffusion_backward(self, latent, context, inv_result: Dict[str, Any],
                           ctrl: Optional[Controller] = None, rng=None):
        ctrl = ctrl or ControllerEmpty()
        layout = self._layout(context.shape[0] // 2, self.guidance_scale_bwd)
        draw = self._drawer(rng, self.seed + 1)
        extras = self.backward_extras(inv_result)
        state = ctrl.init_state(self, latent, context)
        for i, t in enumerate(self.backward_timesteps(inv_result)):
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
        return {"image": self.decode(z0), "latent": z0}
