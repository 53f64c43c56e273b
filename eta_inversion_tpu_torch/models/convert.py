"""Map a flax parameter tree (as numpy arrays) onto the port's modules.

The port's modules carry the flax module names, so the mapping is mechanical:
the nested path joins with "." and the leaf renames --

    kernel (H, W, I, O) conv   -> weight (O, I, H, W)
    kernel (in, out) dense     -> weight (out, in)
    scale (norms)              -> weight
    embedding (nn.Embed)       -> weight
    bias                       -> bias
    anything else (a raw self.param, e.g. position_embedding) -> same name

numpy only: the values stay numpy arrays; `DiffusionModel.load_jax_params`
copies them into the modules.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np


def from_jax_params(np_tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested flax param tree into a state dict of numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for name, node in np_tree.items():
        if isinstance(node, Mapping):
            out.update(from_jax_params(node, f"{prefix}{name}."))
            continue
        arr = np.asarray(node)
        if name == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{prefix}{name}: unexpected kernel rank {arr.ndim}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        out[f"{prefix}{name}"] = np.ascontiguousarray(arr)
    return out
