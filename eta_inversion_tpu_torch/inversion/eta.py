"""Eta inversion (registry key "etainv"), the paper's method.

Counterpart of eta_inversion_tpu/inversion/eta.py: a time-dependent eta table
over the 1000 train steps, per-step candidate variance noises, the closed-form
optimal noise (where the DDIM step would land on the recorded forward
latent), the nearest candidate by mean squared distance, a spatial eta mask
from forward (or backward) cross-attention maps, and source-row snapping to
the forward trajectory with optional masked delta propagation to the target.

Every draw is injectable: the candidate noises come from the engine's
`_drawer` (an injected `noise_fn(step, (count, B, c, h, w))`, or a seeded
`torch.Generator`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..editing.ptp import (AttnStoreController, aggregate_store_batched,
                           attention_map_for_token, image_resize, nearest_cross_res)
from ..schedulers import ddim_backward_step
from .base import DiffusionInversion


def _create_eta_func_pow(p1, p2, p=1):
    """Piecewise-power eta ramp between control points."""
    (x1, y1), (x2, y2) = p1, p2
    a = (y2 - y1) / (x2 - x1) ** p

    def f(t):
        return a * (np.clip(t, x1, x2) - x1) ** p + y1

    return f


def build_eta_table(eta, num_train_steps: int = 1000) -> np.ndarray:
    """eta spec -> (1000,) table over train timesteps."""
    if not isinstance(eta, (tuple, list)):
        eta = (eta, eta)
    ts = np.linspace(0, 1, num_train_steps)
    if len(eta) == 3 or isinstance(eta[0], (tuple, list)):
        etas = _create_eta_func_pow(*eta)(ts)
    else:
        etas = np.linspace(eta[0], eta[1], num_train_steps)
    return np.clip(etas, 0, None).astype(np.float32)


class EtaInversion(DiffusionInversion):
    name = "etainv"
    requires_source_rows = True  # the backward snaps rows [:B] to the forward

    def __init__(self, model, scheduler=None, num_inference_steps=None,
                 guidance_scale_bwd=None, guidance_scale_fwd=None,
                 eta=(0.0, 0.4), noise_sample_count: int = 10, seed: int = 0,
                 use_mask: bool = True, mask_mode_cfg: Optional[Dict[str, Any]] = None,
                 noise_fn=None):
        if use_mask:
            dft = dict(attn_from_where=("up", "down"), attn_res=16, mask_dirinv=None,
                       mask_eta="fwd_mean", pow=None, target_dirinv=None, thres=0.2)
            mask_mode_cfg = {**dft, **(mask_mode_cfg or {})}
        else:
            mask_mode_cfg = None
        self.mask_mode_cfg = mask_mode_cfg
        super().__init__(model, scheduler, num_inference_steps, guidance_scale_bwd,
                         guidance_scale_fwd, seed=seed, noise_fn=noise_fn)
        self.eta_spec = eta
        self.etas = build_eta_table(eta)
        self.noise_sample_count = noise_sample_count

    def _attn_res(self) -> int:
        """Configured mask resolution, clamped to one that has cross layers."""
        return nearest_cross_res(self.model.attn_metas, self.mask_mode_cfg["attn_res"],
                                 tuple(self.mask_mode_cfg["attn_from_where"]))

    # --------------------------------------------------------------- forward

    def predict_noise(self, latent, t, context, guidance_scale, hooks=None,
                      collect_store=False, force_full_cfg=False):
        # single-branch fast path only for exact scalar 0/1 guidance
        scalar01 = isinstance(guidance_scale, (int, float)) and guidance_scale in (0, 1)
        return super().predict_noise(latent, t, context, guidance_scale, hooks,
                                     collect_store, force_full_cfg=force_full_cfg or not scalar01)

    @torch.inference_mode()
    def invert(self, image, prompt=None, context=None, guidance_scale_fwd=None,
               inv_cfg=None, **kwargs) -> Optional[Dict[str, Any]]:
        inv_cfg = inv_cfg or {}
        context = context if context is not None else self.create_context(prompt)
        latent = self.encode(image)
        if self.mask_mode_cfg is None:
            fwd = self.diffusion_forward(latent, context, guidance_scale_fwd)
        else:
            widx = inv_cfg.get("edit_word_idx")
            if widx is None or self._widx_invalid(widx):
                return None
            ctrl = AttnStoreController(
                self, store_res=(self._attn_res(),),
                store_places=tuple(self.mask_mode_cfg["attn_from_where"]),
                n_prompts=latent.shape[0], per_step_maps=True,
                resize=self.model.latent_size)
            fwd = self.diffusion_forward(latent, context, guidance_scale_fwd, ctrl=ctrl)
            st = fwd.pop("fwd_state")
            # mean over steps of per-step normalized token maps, per sample
            fwd["fwd_token_maps"] = st["norm_map_sum"] / max(st["count"], 1.0)
        fwd["context"] = context
        return {**kwargs, "inv_cfg": inv_cfg, **fwd}

    @staticmethod
    def _widx_invalid(widx) -> bool:
        if isinstance(widx, (list, tuple)) and widx and isinstance(widx[0], (list, tuple)):
            return any(w[0] is None or w[1] is None for w in widx)
        return widx[0] is None or widx[1] is None

    @staticmethod
    def _widx_array(widx) -> np.ndarray:
        """(B, 2) int array of per-sample (source, target) word indices."""
        arr = np.asarray(widx, dtype=np.int64)
        return arr[None] if arr.ndim == 1 else arr

    # -------------------------------------------------------------- backward

    def _static_mask(self, inv_result, key) -> Optional[torch.Tensor]:
        """Step-independent masks ("gt" / "fwd_mean"), (B, 1, h, w)."""
        mode = self.mask_mode_cfg[key]
        size = self.model.latent_size
        inv_cfg = inv_result.get("inv_cfg") or {}
        if mode is None or mode.startswith("bwd"):
            return None  # bwd_* are computed per step (_bwd_mask)
        if mode == "gt":
            mask = torch.as_tensor(np.asarray(inv_cfg["mask"], np.float32), device=self.device)
            if mask.dim() == 2:
                mask = mask[None]
            mask = image_resize(mask, (mask.shape[0], size, size), "bilinear")
        elif mode == "fwd_mean":
            widx = self._widx_array(inv_cfg["edit_word_idx"])[:, 0]
            maps = inv_result["fwd_token_maps"]  # (B, size, size, 77)
            mask = torch.stack([attention_map_for_token(m, int(w) + 1, resize=None)
                                for m, w in zip(maps, widx)])
        else:
            raise NotImplementedError(f"unknown mask mode {mode!r}")
        return self._finish_mask(mask, size)

    def _finish_mask(self, mask, size):
        mm = self.mask_mode_cfg
        if mm["thres"] is not None:
            mask = (mask > mm["thres"]).float()
        if mm["pow"] is not None:
            mask = torch.pow(mask, mm["pow"])
        return mask.reshape(-1, 1, size, size)

    def _bwd_mask(self, key, ctrl, state, store, latent, widx_arr):
        """Masks from the backward controller's accumulated store, including
        this step's maps (bwd_source / bwd_target / bwd_source_target; needs a
        store-carrying controller such as ptp).  Rows [s_1..s_B, t_1..t_B]."""
        mode = self.mask_mode_cfg[key]
        size = self.model.latent_size
        n = latent.shape[0]
        B = n // 2
        res = self._attn_res()
        keys = [k for k in getattr(ctrl, "store_keys", ()) if f"_{res}_" in k]
        if not keys:
            raise ValueError(f"mask mode {mode!r} needs a controller with attention "
                             f"stores at res {res} (e.g. ptp)")
        merged = {k: state["store_sum"][k] + store[k][-n:].float() for k in keys}
        agg = aggregate_store_batched(merged, keys, res, n)  # (2B, res, res, 77)

        def token_masks(rows, widx):
            return torch.stack([attention_map_for_token(m, int(w) + 1, resize=size)
                                for m, w in zip(rows, widx)])

        if mode == "bwd_source":
            mask = token_masks(agg[:B], widx_arr[:, 0])
        elif mode == "bwd_target":
            mask = token_masks(agg[B:], widx_arr[:, 1])
        elif mode == "bwd_source_target":
            mask = torch.maximum(token_masks(agg[:B], widx_arr[:, 0]),
                                 token_masks(agg[B:], widx_arr[:, 1]))
        else:
            raise NotImplementedError(mode)
        return self._finish_mask(mask, size)

    def _mask_mode_is_bwd(self, key) -> bool:
        mode = self.mask_mode_cfg[key] if self.mask_mode_cfg else None
        return isinstance(mode, str) and mode.startswith("bwd")

    def backward_extras(self, inv_result):
        extras: Dict[str, Any] = {
            # [z_{S-1} .. z_0]: the forward latent each backward step lands on
            "source_latent_prev": torch.flip(inv_result["latents"], dims=[0])[1:]}
        if self.mask_mode_cfg is not None:
            for key in ("mask_eta", "mask_dirinv"):
                extras[key] = self._static_mask(inv_result, key)
            if self._mask_mode_is_bwd("mask_eta") or self._mask_mode_is_bwd("mask_dirinv"):
                widx = (inv_result.get("inv_cfg") or {}).get("edit_word_idx")
                extras["edit_word_idx"] = self._widx_array(widx)
        return extras

    def predict_step_backward(self, i, t, latent, state, context, ctrl, layout, extras, draw):
        latent = ctrl.begin_step(i, t, latent, state)
        eps, store = self.predict_noise(latent, t, context, self.guidance_scale_bwd,
                                        hooks=ctrl.hooks(i, state, layout),
                                        collect_store=ctrl.collect_store())
        src_prev = extras["source_latent_prev"][i]  # (B, c, h, w)
        B = src_prev.shape[0]
        eta_t = float(self.etas[min(max(t, 0), 999)])

        # candidate variance noises + closed-form optimal noise; nearest
        # candidate per sample
        noises = draw(i, (self.noise_sample_count,) + tuple(src_prev.shape))
        rec0 = ddim_backward_step(self.schedule, latent[:B], eps[:B], t, eta=eta_t)
        std = eta_t * torch.sqrt(self.schedule.variance(t)).item()
        opt = (src_prev - rec0) / max(std, 1e-20) if std > 0 else torch.zeros_like(src_prev)
        losses = ((noises - opt[None]) ** 2).mean(dim=tuple(range(2, noises.dim())))
        best = torch.argmin(losses, dim=0)  # (B,)
        vn = noises[best, torch.arange(B, device=noises.device)]
        pair = latent.shape[0] == 2 * B  # rows [s_1..s_B, t_1..t_B] share noise/mask
        vn_full = torch.cat([vn, vn]) if pair else vn

        eta_map = eta_t
        mask_eta = extras.get("mask_eta")
        if self._mask_mode_is_bwd("mask_eta"):
            mask_eta = self._bwd_mask("mask_eta", ctrl, state, store, latent,
                                      extras["edit_word_idx"])
        if self.mask_mode_cfg is not None and mask_eta is not None:
            eta_map = (torch.cat([mask_eta, mask_eta]) if pair else mask_eta) * eta_t

        new_latent = ddim_backward_step(self.schedule, latent, eps, t, eta=eta_map,
                                        noise=vn_full)
        # source rows snap to the forward trajectory
        delta = src_prev - new_latent[:B]
        rest = new_latent[B:]
        if self.mask_mode_cfg is not None and self.mask_mode_cfg.get("target_dirinv") is not None:
            mask_dirinv = extras.get("mask_dirinv")
            if self._mask_mode_is_bwd("mask_dirinv"):
                mask_dirinv = self._bwd_mask("mask_dirinv", ctrl, state, store, latent,
                                             extras["edit_word_idx"])
            if mask_dirinv is not None:
                delta = (1.0 - mask_dirinv) * delta
            rest = rest + self.mask_mode_cfg["target_dirinv"] * delta
        new_latent = torch.cat([src_prev, rest])
        return ctrl.end_step(i, t, new_latent, eps, store, state)
