"""Pair-batched editing: B independent (image, source, target) edits in one
run of the engine.

Counterpart of eta_inversion_tpu/editing/batched.py.  The backward batch
holds the rows [u_src(B), u_tgt(B), c_src(B), c_tgt(B)]: its conditional
half carries the B (source, target) pairs laid out [s_1..s_B, t_1..t_B], and
every ported editing hook (ptp's probability edits and LocalBlend, etainv's
masks and noise selection, nti's per-sample null embeddings) is written pair
by pair, so each pair's result is that of its edit alone, up to the order of
sums over the batch.  One UNet call serves 4B rows, which amortizes the
host's launch work across the pairs.

The editors the port has are batched here: simple and ptp
(ControllerBasedEditor), over any ported inverter (diffinv, etainv, nti,
npi).  The JAX package's other editors (masactrl, pnp, invedit,
pix2pix_zero) are not ported (ROADMAP M8).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from .editor import ControllerBasedEditor
from .simple import SimpleEditor

# scalar ptp options that must agree across a batch (one controller serves it)
SCALAR_PTP_KEYS = ("is_replace_controller", "cross_replace_steps", "self_replace_steps")


def _merged_ptp_cfg(cfgs: Sequence[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Per-sample ptp configs -> one controller's: the scalar options must
    agree (ValueError otherwise); the word options become per-pair lists."""
    cfgs = [dict(c or {}) for c in cfgs]
    merged: Dict[str, Any] = {}
    for key in SCALAR_PTP_KEYS:
        vals = [c[key] for c in cfgs if key in c]
        if vals:
            if any(v != vals[0] for v in vals):
                raise ValueError(f"batched ptp needs one {key} for every sample, got {vals}")
            merged[key] = vals[0]
    merged["blend_words"] = [c.get("blend_words") for c in cfgs]
    merged["equilizer_params"] = [c.get("equilizer_params") for c in cfgs]
    return merged


@torch.inference_mode()
def edit_batch(editor, images, source_prompts: List[str], target_prompts: List[str],
               cfgs: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
               inv_cfgs: Optional[Sequence[Optional[Dict[str, Any]]]] = None
               ) -> Optional[Dict[str, Any]]:
    """Run B edits through `editor` in one batched engine run.

    images: (B, H, W, 3) in [-1, 1]; one source and one target prompt, and
    optionally one cfg and inv_cfg (Editor.edit's), per sample.  Returns
    {"image", "image_inv", "latent", "latent_inv"} with leading dim B
    (images NHWC, latents NCHW), or None where the inverter refuses the
    inputs (etainv without edit-word indices), as Editor.edit does.  Every
    draw is the engine's (its `noise_fn` when one is injected): etainv's
    candidate noises come as one (count, B, c, h, w) draw a step."""
    inv = editor.inverter
    B = len(source_prompts)
    images = torch.as_tensor(images)
    if len(target_prompts) != B or images.shape[0] != B:
        raise ValueError(f"{B} source prompts, {len(target_prompts)} target prompts and "
                         f"{images.shape[0]} images: one of each per sample")
    if not isinstance(editor, (ControllerBasedEditor, SimpleEditor)):
        raise NotImplementedError(f"batched editing of {type(editor).__name__} is not ported "
                                  "(ROADMAP M8: masactrl, pnp, invedit, pix2pix_zero)")
    cfgs = list(cfgs) if cfgs is not None else [None] * B
    inv_cfgs = list(inv_cfgs) if inv_cfgs is not None else [None] * B

    # the inversion config, per sample: word indices (and masks) stacked
    widx = [(c or {}).get("edit_word_idx") or (None, None) for c in inv_cfgs]
    masks = [(c or {}).get("mask") for c in inv_cfgs]
    inv_cfg: Dict[str, Any] = {"edit_word_idx": widx}
    if all(m is not None for m in masks):
        inv_cfg["mask"] = torch.stack([torch.as_tensor(m, dtype=torch.float32) for m in masks])

    # inversion with the source prompts ([u(B), c_src(B)]; CFG 1 for simple)
    uncond = inv.embed_texts([""])
    cond_src = inv.embed_texts(source_prompts)
    u = uncond.expand_as(cond_src)
    inv_res = inv.invert(images, context=torch.cat([u, cond_src]),
                         guidance_scale_fwd=1 if isinstance(editor, SimpleEditor) else None,
                         inv_cfg=inv_cfg)
    if inv_res is None:
        return None

    # denoising: [u_src(B), u_tgt(B), c_src(B), c_tgt(B)] over [zT; zT]
    cond_tgt = inv.embed_texts(target_prompts)
    ctx_bwd = torch.cat([u, u, cond_src, cond_tgt])
    ctrl = None
    if isinstance(editor, ControllerBasedEditor):
        ctrl = editor.make_controller(image=images, source_prompt=list(source_prompts),
                                      target_prompt=list(target_prompts), inv_res=inv_res,
                                      **_merged_ptp_cfg(cfgs))
    zT = inv_res["latents"][-1]
    z0 = inv.diffusion_backward(inv.cat_latent([zT, zT]), ctx_bwd, inv_res, ctrl=ctrl)
    image = inv.decode(z0)
    return {"image_inv": image[:B], "image": image[B:], "latent_inv": z0[:B], "latent": z0[B:]}
