"""Simple editor (registry key "simple"): invert with the source prompt
(forward CFG=1), denoise the [source, target] batch with no intervention.
Counterpart of eta_inversion_tpu/editing/simple.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .editor import Editor, check_no_source_backward


class SimpleEditor(Editor):
    def __init__(self, inverter, no_source_backward: bool = False):
        self.inverter = inverter
        self.model = inverter.model
        self.no_source_backward = no_source_backward
        if no_source_backward:
            check_no_source_backward(self, inverter)

    @torch.inference_mode()
    def edit(self, image, source_prompt: str, target_prompt: str,
             cfg: Optional[Dict[str, Any]] = None, inv_cfg: Optional[Dict[str, Any]] = None,
             **kwargs) -> Dict[str, Any]:
        if cfg:
            raise ValueError(f"SimpleEditor takes no cfg, got {cfg}")
        src_context = self.inverter.create_context(source_prompt)
        target_context = self.inverter.create_context(target_prompt)
        inv_res = self.inverter.invert(image, context=src_context, guidance_scale_fwd=1,
                                       inv_cfg=inv_cfg)
        if not self.no_source_backward:
            edit_res = self.inverter.sample(inv_res, context=[src_context, target_context])
            return {"image_inv": edit_res["image"][0:1], "image": edit_res["image"][1:2],
                    "latent_inv": edit_res["latent"][0:1], "latent": edit_res["latent"][1:2]}
        edit_res = self.inverter.sample(inv_res, context=[target_context])
        return {"image": edit_res["image"], "latent": edit_res["latent"]}
