"""CLIP text tower (the SD conditioning encoder).

Counterpart of the text half of eta_inversion_tpu/models/clip.py: causal
transformer over 77 tokens with quick-gelu MLPs (OpenAI CLIP, as SD-1.x
uses) or exact-erf gelu (OpenCLIP's towers of SD-2.x and SDXL, HF's "gelu"),
final-LayerNorm hidden states (fp32, as the JAX package's fp32 LayerNorm
returns them) or, with `penultimate`, the states before the last layer
(SDXL), and with `projection_dim` the projected pooled embedding beside them
(SDXL's second tower).  The vision tower is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    act: str = "quick_gelu"  # or "gelu" (exact erf)
    # SDXL: condition on the penultimate layer's hidden states (un-normed);
    # the last layer and the final norm still run, for the pooled output
    penultimate: bool = False
    # CLIPTextModelWithProjection: the eos row of the final normed states
    # times `text_projection` (hidden, projection_dim)
    projection_dim: Optional[int] = None


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, c = x.shape
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = torch.where(causal, logits, torch.tensor(-1e30, device=x.device))
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
        return self.out_proj(o.transpose(1, 2).reshape(b, s, c))


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, act: str = "quick_gelu"):
        super().__init__()
        if act not in ("quick_gelu", "gelu"):
            raise ValueError(f"CLIP activation {act!r}: quick_gelu or gelu")
        self.act = act
        self.layer_norm1 = LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, num_heads)
        self.layer_norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, dim * 4)
        self.fc2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        dt = x.dtype
        x = x + self.self_attn(self.layer_norm1(x).to(dt))
        h = self.fc1(self.layer_norm2(x).to(dt))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return x + self.fc2(h)


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = cfg = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPLayer(cfg.hidden_size, cfg.num_heads, cfg.act))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Parameter(torch.zeros(cfg.hidden_size,
                                                            cfg.projection_dim))

    def forward(self, input_ids):
        """input_ids: (B, 77) int -> (B, 77, hidden) hidden states: the final
        normed ones (fp32), or with `penultimate` the input of the last layer
        (the parameters' dtype).  With `projection_dim`, (hidden states,
        (B, projection_dim) pooled embedding): the final normed row at the
        eos token (the largest id, OpenAI CLIP's convention) times
        text_projection."""
        cfg = self.config
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding[None, : x.shape[1]].to(x.dtype)
        penult = x
        for i in range(cfg.num_layers):
            if i == cfg.num_layers - 1:
                penult = x
            x = self._modules[f"layers_{i}"](x)
        x = self.final_layer_norm(x)
        hidden = penult if cfg.penultimate else x
        if cfg.projection_dim is None:
            return hidden
        eos = input_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        dt = self.text_projection.dtype
        return hidden, pooled.to(dt) @ self.text_projection
