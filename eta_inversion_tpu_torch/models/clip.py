"""CLIP text tower (the SD conditioning encoder).

Counterpart of the text half of eta_inversion_tpu/models/clip.py: causal
transformer over 77 tokens with quick-gelu MLPs (OpenAI CLIP, as SD-1.x
uses), final-LayerNorm hidden states (fp32, as the JAX package's fp32
LayerNorm returns them).  The SD-2.x / SDXL options (exact gelu, penultimate
layer, pooled projection) and the vision tower are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from .layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77


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
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, num_heads)
        self.layer_norm2 = LayerNorm(dim, eps=1e-5)
        self.fc1 = nn.Linear(dim, dim * 4)
        self.fc2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        dt = x.dtype
        x = x + self.self_attn(self.layer_norm1(x).to(dt))
        h = self.fc1(self.layer_norm2(x).to(dt))
        return x + self.fc2(h * torch.sigmoid(1.702 * h))  # quick-gelu


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = cfg = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_length, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPLayer(cfg.hidden_size, cfg.num_heads))
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids):
        """input_ids: (B, 77) int -> (B, 77, hidden) fp32 hidden states."""
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding[None, : x.shape[1]].to(x.dtype)
        for i in range(self.config.num_layers):
            x = self._modules[f"layers_{i}"](x)
        return self.final_layer_norm(x)
