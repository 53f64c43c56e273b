"""eta_inversion_tpu_torch: the PyTorch / CUDA port of eta_inversion_tpu.

A second package beside the JAX one, with the same module paths and names.
It imports torch, numpy and the standard library only -- never jax, flax or
eta_inversion_tpu -- and runs on one NVIDIA H100, with hand-written CUDA
kernels (csrc/) where the JAX package has Pallas kernels.

Ported: every inverter and editor of the JAX registry -- the main path
(the etainv + ptp edit served at SD-1.5 width), nti (whose gradient runs
through the flash attention backward kernels), npi, dirinv, ddpminv /
cyclediff, proxnpi, edict and regdiffinv over the ddim / ddpm / dpm
schedulers; the simple, ptp, masactrl, pnp, pix2pix_zero and invedit
editors, single and pair-batched -- on the JAX package's eight model presets
(SD-1.5, SD-2.1 base, SD-2.1-v at 768 px, SDXL and their tiny homologues),
with diffusers checkpoints from a local directory and the `edit_image` /
`invert_image` / `serve` entry points (see ROADMAP.md for what is still to
come).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List

__version__ = "0.1.0"


def _inverter_registry() -> Dict[str, Callable]:
    from .inversion.base import DiffusionInversion
    from .inversion.ddpm import DDPMInversion
    from .inversion.direct import DirectInversion
    from .inversion.edict import EdictInversion
    from .inversion.eta import EtaInversion
    from .inversion.npi import NegativePromptInversion
    from .inversion.nti import NullTextInversion
    from .inversion.proxnpi import ProximalNegativePromptInversion
    from .inversion.regularized import RegularizedDiffusionInversion

    return {
        "diffinv": DiffusionInversion,
        "nti": NullTextInversion,
        "npi": NegativePromptInversion,
        "proxnpi": ProximalNegativePromptInversion,
        "edict": EdictInversion,
        "ddpminv": DDPMInversion,
        "cyclediff": functools.partial(DDPMInversion, markovian_forward=True),
        "dirinv": DirectInversion,
        "etainv": EtaInversion,
        "regdiffinv": RegularizedDiffusionInversion,
    }


def _editor_registry() -> Dict[str, Callable]:
    from .editing.inv_editor import InversionEditor
    from .editing.masactrl import MasactrlEditor
    from .editing.pix2pix_zero import Pix2PixZeroEditor
    from .editing.pnp import PlugAndPlayEditor
    from .editing.ptp import PromptToPromptEditor
    from .editing.simple import SimpleEditor

    return {
        "simple": SimpleEditor,
        "ptp": PromptToPromptEditor,
        "masactrl": MasactrlEditor,
        "pnp": PlugAndPlayEditor,
        "pix2pix_zero": Pix2PixZeroEditor,
        "invedit": InversionEditor,
    }


_extra_editors: Dict[str, Callable] = {}

# the JAX package's registry keys the port has not ported yet, with the
# ROADMAP item that ports them: none are left
UNPORTED: Dict[str, str] = {}


def register_editor(name: str, editor_cls: Callable) -> None:
    """Register an additional editor under `name`."""
    _extra_editors[name] = editor_cls


def get_inversion_methods() -> List[str]:
    return list(_inverter_registry().keys())


def get_edit_methods() -> List[str]:
    return list(_editor_registry().keys()) + list(_extra_editors.keys())


def _unknown(kind: str, key: str, registry: Dict[str, Callable]) -> ValueError:
    where = f" (not ported yet, {UNPORTED[key]})" if key in UNPORTED else ""
    return ValueError(f"unknown {kind} {key!r}{where}; available: {sorted(registry)}")


def load_inverter(model, type: str = "diffinv", **kwargs):
    """Create an inverter by registry key."""
    registry = _inverter_registry()
    if type not in registry:
        raise _unknown("inverter", type, registry)
    return registry[type](model=model, **kwargs)


def load_editor(inverter, type: str = "simple", **kwargs):
    """Create an editor by registry key."""
    registry = {**_editor_registry(), **_extra_editors}
    if type not in registry:
        raise _unknown("editor", type, registry)
    return registry[type](inverter=inverter, **kwargs)
