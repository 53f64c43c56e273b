"""eta_inversion_tpu_torch: the PyTorch / CUDA port of eta_inversion_tpu.

A second package beside the JAX one, with the same module paths and names.
It imports torch, numpy and the standard library only -- never jax, flax or
eta_inversion_tpu -- and runs on one NVIDIA H100, with hand-written CUDA
kernels (csrc/) where the JAX package has Pallas kernels.

Ported so far: the main path, the etainv + ptp edit served at SD-1.5 width
(see ROADMAP.md for what is still to come).
"""

from __future__ import annotations

from typing import Callable, Dict

__version__ = "0.1.0"


def _inverter_registry() -> Dict[str, Callable]:
    from .inversion.base import DiffusionInversion
    from .inversion.eta import EtaInversion

    return {"diffinv": DiffusionInversion, "etainv": EtaInversion}


def _editor_registry() -> Dict[str, Callable]:
    from .editing.ptp import PromptToPromptEditor
    from .editing.simple import SimpleEditor

    return {"simple": SimpleEditor, "ptp": PromptToPromptEditor}


def load_inverter(model, type: str = "diffinv", **kwargs):
    """Create an inverter by registry key."""
    registry = _inverter_registry()
    if type not in registry:
        raise ValueError(f"inverter {type!r} is not ported yet; ported: "
                         f"{sorted(registry)}")
    return registry[type](model=model, **kwargs)


def load_editor(inverter, type: str = "simple", **kwargs):
    """Create an editor by registry key."""
    registry = _editor_registry()
    if type not in registry:
        raise ValueError(f"editor {type!r} is not ported yet; ported: "
                         f"{sorted(registry)}")
    return registry[type](inverter=inverter, **kwargs)
