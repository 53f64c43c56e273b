"""Editor base classes.

Counterpart of eta_inversion_tpu/editing/editor.py.  `Editor.edit` keeps the
protocol: (image NHWC [-1, 1], source_prompt, target_prompt, cfg, inv_cfg) ->
{"image", "latent"[, "image_inv", "latent_inv"]} or None for unsupported
combinations.  Images come back NHWC; latents NCHW.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import torch

from .controller import Controller


class Editor:
    def edit(self, image, source_prompt: str, target_prompt: str,
             cfg: Optional[Dict[str, Any]] = None, inv_cfg: Optional[Dict[str, Any]] = None,
             **kwargs) -> Optional[Dict[str, Any]]:
        raise NotImplementedError


def check_no_source_backward(editor, inverter) -> None:
    """Validate a `no_source_backward=True` (serving mode) editor build.

    * Source-anchored inverters (etainv, `requires_source_rows`) snap rows
      [:B] to the forward trajectory, so a single-prompt batch returns the
      reconstruction, not the edit: raise.
    * Controller editors with pair-row attention hooks (ptp) become no-ops
      without the source rows: warn.
    """
    if getattr(inverter, "requires_source_rows", False):
        raise ValueError(
            f"{type(inverter).__name__} anchors source rows to the forward "
            "trajectory; no_source_backward would return the reconstruction, "
            "not the edit. Use the pair-batched edit for this inverter.")
    if isinstance(editor, ControllerBasedEditor):
        warnings.warn(
            f"{type(editor).__name__} with no_source_backward=True: "
            "pair-row attention interventions are inert without the "
            "source rows; the edit degrades to hook-free denoising. "
            "Use SimpleEditor for serving-mode edits.", stacklevel=3)


class ControllerBasedEditor(Editor):
    """Invert with the source prompt, then denoise [source, target] under a
    controller."""

    def __init__(self, inverter, no_source_backward: bool = False):
        self.inverter = inverter
        self.no_source_backward = no_source_backward
        if no_source_backward:
            check_no_source_backward(self, inverter)

    def make_controller(self, image, source_prompt: str, target_prompt: str,
                        inv_res: Dict[str, Any], **kwargs) -> Controller:
        raise NotImplementedError

    @torch.inference_mode()
    def edit(self, image, source_prompt: str, target_prompt: str,
             cfg: Optional[Dict[str, Any]] = None, inv_cfg: Optional[Dict[str, Any]] = None,
             **kwargs) -> Optional[Dict[str, Any]]:
        cfg = dict(cfg or {})
        inv_cfg = inv_cfg or {}
        src_context = self.inverter.create_context(source_prompt)
        target_context = self.inverter.create_context(target_prompt)
        inv_res = self.inverter.invert(image, prompt=source_prompt, context=src_context,
                                       inv_cfg=inv_cfg)

        controller = self.make_controller(image=image, source_prompt=source_prompt,
                                          target_prompt=target_prompt, inv_res=inv_res,
                                          **cfg, **kwargs)
        if controller is None and cfg:
            return None
        if not self.no_source_backward:
            edit_res = self.inverter.sample(inv_res, context=[src_context, target_context],
                                            ctrl=controller)
            if edit_res is None:
                return None
            return {"image_inv": edit_res["image"][0:1], "image": edit_res["image"][1:2],
                    "latent_inv": edit_res["latent"][0:1], "latent": edit_res["latent"][1:2]}
        edit_res = self.inverter.sample(inv_res, context=[target_context], ctrl=controller)
        return {"image": edit_res["image"], "latent": edit_res["latent"]}
