"""Attention-intervention protocol.

Counterpart of eta_inversion_tpu/ops/attn_ctrl.py.  The UNet takes an optional
`AttnHooks` object whose methods are called at fixed points of the static
layer topology:

    qkv(meta, q, k, v)     -> (q, k, v)   before the attention kernel
    wants_probs(meta)      -> bool        materialize probabilities?
    probs(meta, p)         -> p           edit the (B, H, Sq, Sk) probabilities
    store(meta)            -> bool        record this layer's probabilities?
    out(meta, o)           -> o           after the attention kernel
    resnet(meta, h)        -> h           after designated resnet blocks
    hidden(meta, h)        -> h           on the attention-layer input

Layer identity is static (`AttnLayerMeta`); decisions that depend only on it
are plain Python.  Stored probabilities go into the `store` dict the caller
passes to the UNet, under key f"{place}_{type}_{res}_{i}".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnLayerMeta:
    """Static identity of one attention layer in UNet forward-execution order
    (`idx` over all layers; `self_idx` / `cross_idx` within each kind)."""

    idx: int
    is_cross: bool
    place: str  # "down" | "mid" | "up"
    res: int  # spatial side at this layer (64 / 32 / 16 / 8 for 512px input)
    self_idx: int
    cross_idx: int
    heads: int

    @property
    def kind(self) -> str:
        return "cross" if self.is_cross else "self"

    @property
    def store_key(self) -> str:
        return f"{self.place}_{self.kind}_{self.res}_{self.idx}"


@dataclasses.dataclass(frozen=True)
class ResnetMeta:
    """Static identity of a resnet hook site (up blocks only)."""

    block: int
    resnet: int
    res: int


class AttnHooks:
    """No-op base hooks; subclass and override.

    `unet_in_rows` / `unet_out_rows` (row-index tuples or None) are the JAX
    protocol's whole-UNet batch restructuring (pnp's plans, ROADMAP M8); no
    ported hook sets them, and the engine reads `unet_in_rows` only to keep
    such a plan off the CFG shared prefix (`DiffusionInversion._cfg_prefix_ok`)."""

    unet_in_rows = None
    unet_out_rows = None

    def wants_probs(self, meta: AttnLayerMeta) -> bool:
        return False

    def cfg_prefix_safe(self, first_self_meta: AttnLayerMeta) -> bool:
        """Does this object provably not act on the UNet's prefix up to and
        including the first self-attention layer?  The guidance halves' rows
        are identical there, so the engine then runs the prefix once and
        tiles at the first cross-attention (exact).  Conservative default:
        False."""
        return False

    def store(self, meta: AttnLayerMeta) -> bool:
        return False

    def passthrough_attn(self, meta: AttnLayerMeta) -> bool:
        """Does this object provably not intervene at this layer (qkv, probs,
        store and out all identity)?  Then the layer takes the packed fast
        path (`attention_packed`).  Conservative default: False."""
        return False

    def hidden(self, meta: AttnLayerMeta, h):
        return h

    def qkv(self, meta: AttnLayerMeta, q, k, v) -> Tuple:
        return q, k, v

    def probs(self, meta: AttnLayerMeta, p):
        return p

    def out(self, meta: AttnLayerMeta, o):
        return o

    def resnet(self, meta: ResnetMeta, h):
        return h


class ComposedHooks(AttnHooks):
    """Compose several hooks; applied in order."""

    def __init__(self, *hooks: Optional[AttnHooks]):
        self.hooks = [h for h in hooks if h is not None]

    def wants_probs(self, meta):
        return any(h.wants_probs(meta) for h in self.hooks)

    def store(self, meta):
        return any(h.store(meta) for h in self.hooks)

    def passthrough_attn(self, meta):
        return all(h.passthrough_attn(meta) for h in self.hooks)

    def hidden(self, meta, x):
        for h in self.hooks:
            x = h.hidden(meta, x)
        return x

    def qkv(self, meta, q, k, v):
        for h in self.hooks:
            q, k, v = h.qkv(meta, q, k, v)
        return q, k, v

    def probs(self, meta, p):
        for h in self.hooks:
            p = h.probs(meta, p)
        return p

    def out(self, meta, o):
        for h in self.hooks:
            o = h.out(meta, o)
        return o

    def resnet(self, meta, x):
        for h in self.hooks:
            x = h.resnet(meta, x)
        return x
