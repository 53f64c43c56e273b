"""Engine-level diffusion controllers.

Counterpart of eta_inversion_tpu/editing/controller.py.  The engine's loops
call, for step i at timestep t:

  * `init_state(engine, latent, contexts)` once, before the loop
  * `hooks(i, state, layout)` -> AttnHooks | None
  * `begin_step(i, t, latent, state)` -> latent
  * `end_step(i, t, latent, eps, store, state)` -> (latent, state)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from ..ops.attn_ctrl import AttnHooks


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """The UNet batch the hooks see: with classifier-free guidance
    [u_1..u_n, c_1..c_n], edits act on the conditional half; the conditional
    half holds B (source, target) pairs laid out [s_1..s_B, t_1..t_B]."""

    n_prompts: int
    cfg_dup: bool

    @property
    def cond_start(self) -> int:
        return self.n_prompts if self.cfg_dup else 0

    @property
    def batch(self) -> int:
        return self.n_prompts * (2 if self.cfg_dup else 1)

    @property
    def n_pairs(self) -> int:
        return max(self.n_prompts // 2, 1)


class Controller:
    """Base controller: no-op at every site."""

    def init_state(self, engine, latent, contexts) -> Any:
        return ()

    def hooks(self, i: int, state, layout: BatchLayout) -> Optional[AttnHooks]:
        return None

    def collect_store(self) -> bool:
        """Does end_step consume stored attention maps?"""
        return False

    def begin_step(self, i, t, latent, state):
        return latent

    def end_step(self, i, t, latent, eps, store: Dict[str, Any], state) -> Tuple[Any, Any]:
        return latent, state


class ControllerEmpty(Controller):
    pass
