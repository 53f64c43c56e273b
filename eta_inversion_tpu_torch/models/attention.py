"""UNet attention modules with intervention hooks.

Counterpart of eta_inversion_tpu/models/attention.py.  Hooks are explicit
arguments (ops/attn_ctrl.py); the probability tensor is only materialized
when a hook asks for it; hook-free self-attention stays in the packed
(B, S, H*D) projection layout and goes to `attention_packed`.  Stored
probabilities are written into the caller's `store` dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.attn_ctrl import AttnHooks, AttnLayerMeta
from ..ops.flash_attention import attention, attention_packed, attention_probs
from ..ops.geglu import geglu_mlp_xla
from .layers import GroupNorm, LayerNorm


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, head_dim: int,
                 meta: AttnLayerMeta):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.meta = heads, head_dim, meta
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None, hooks: Optional[AttnHooks] = None,
                store: Optional[Dict[str, torch.Tensor]] = None):
        b, s, _ = x.shape
        inner = self.heads * self.head_dim
        ctx = x if context is None else context
        sk = ctx.shape[1]
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        scale = self.head_dim ** -0.5

        if context is None and (hooks is None or hooks.passthrough_attn(self.meta)):
            # hook-free self-attention: packed layout end to end
            return self.to_out(attention_packed(q, k, v, self.heads, scale=scale))

        q = q.reshape(b, s, self.heads, self.head_dim).transpose(1, 2)
        k = k.reshape(b, sk, self.heads, self.head_dim).transpose(1, 2)
        v = v.reshape(b, sk, self.heads, self.head_dim).transpose(1, 2)
        if hooks is not None:
            q, k, v = hooks.qkv(self.meta, q, k, v)

        stored = hooks is not None and hooks.store(self.meta)
        if hooks is not None and (hooks.wants_probs(self.meta) or stored):
            # fp32 softmax, then the probability edits and PV in compute dtype
            p = attention_probs(q, k, scale).to(x.dtype)
            if stored and store is not None:
                store[self.meta.store_key] = p
            p = hooks.probs(self.meta, p)
            o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
        else:
            o = attention(q, k, v, scale)
        if hooks is not None:
            o = hooks.out(self.meta, o)
        return self.to_out(o.transpose(1, 2).reshape(b, s, inner))


class FeedForward(nn.Module):
    """GEGLU feed-forward (dim -> 4*dim -> dim), plain path (ops/geglu.py)."""

    def __init__(self, dim: int):
        super().__init__()
        self.geglu_proj = nn.Linear(dim, dim * 8)
        self.proj_out = nn.Linear(dim * 4, dim)

    def forward(self, x):
        return geglu_mlp_xla(x, self.geglu_proj.weight, self.geglu_proj.bias,
                             self.proj_out.weight, self.proj_out.bias)


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attn -> LayerNorm -> cross-attn -> LayerNorm -> GEGLU."""

    def __init__(self, heads: int, head_dim: int, context_dim: int,
                 self_meta: AttnLayerMeta, cross_meta: AttnLayerMeta):
        super().__init__()
        dim = heads * head_dim
        self.self_meta = self_meta
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, heads, head_dim, self_meta)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, context_dim, heads, head_dim, cross_meta)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, hooks=None, store=None, dup: bool = False):
        """`dup`: the CFG shared prefix ends here: x carries B rows through
        the self-attention and is tiled to 2B ([x; x]) before norm2, where
        the context first tells the guidance halves apart."""
        dt = x.dtype
        if hooks is not None:
            x = hooks.hidden(self.self_meta, x)
        x = x + self.attn1(self.norm1(x).to(dt), None, hooks, store)
        if dup:
            x = x.repeat(2, 1, 1)
        x = x + self.attn2(self.norm2(x).to(dt), context, hooks, store)
        return x + self.ff(self.norm3(x).to(dt))


class Transformer2D(nn.Module):
    """GroupNorm -> proj in -> transformer block(s) -> proj out, residual.
    The projections are 1x1 convs on the map (SD-1.x) or, with `use_linear`,
    linear layers on the flattened (B, h*w, C) tokens (SD-2.x / XL
    `use_linear_projection`: the tokens are flattened before proj_in and
    unflattened after proj_out).  `metas` holds one (self, cross) pair per
    block (SDXL's depth > 1)."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 metas: Tuple[AttnLayerMeta, ...], groups: int = 32, use_linear: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.use_linear = use_linear
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner) if use_linear else \
            nn.Conv2d(channels, inner, 1)
        for d in range(len(metas) // 2):
            self.add_module(f"blocks_{d}", BasicTransformerBlock(
                heads, head_dim, context_dim, metas[2 * d], metas[2 * d + 1]))
        self.depth = len(metas) // 2
        self.proj_out = nn.Linear(inner, channels) if use_linear else \
            nn.Conv2d(inner, channels, 1)

    def forward(self, x, context, hooks=None, store=None, dup: bool = False):
        """`dup`: the first block tiles the rows x2 (the CFG shared prefix's
        end, BasicTransformerBlock); the residual is tiled to match."""
        b, c, h, w = x.shape
        residual = x

        def tokens(y):  # (B, C, h, w) -> (B, h*w, C), tokens in (h, w) order
            return y.permute(0, 2, 3, 1).reshape(y.shape[0], h * w, -1)

        y = self.norm(x).to(x.dtype)
        y = self.proj_in(tokens(y)) if self.use_linear else tokens(self.proj_in(y))
        for d in range(self.depth):
            y = getattr(self, f"blocks_{d}")(y, context, hooks, store, dup=dup and d == 0)
        if self.use_linear:
            y = self.proj_out(y)
        y = y.reshape(-1, h, w, y.shape[-1]).permute(0, 3, 1, 2)
        if not self.use_linear:
            y = self.proj_out(y)
        if residual.shape[0] != y.shape[0]:
            residual = residual.repeat(y.shape[0] // residual.shape[0], 1, 1, 1)
        return y + residual
