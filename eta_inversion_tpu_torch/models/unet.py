"""UNet2DCondition (the Stable Diffusion 1.x / 2.x / XL UNets), NCHW,
hook-aware.

Counterpart of eta_inversion_tpu/models/unet.py: down stages (SD-1.5: 320/
640/1280/1280, cross-attention on the first three), mid block, up stages.
The config carries the three families' fields: a fixed head count (SD-1.x)
or a fixed head width (SD-2.x / XL, `head_dim`), 1x1-conv or linear
transformer projections, a per-stage transformer depth (SDXL 1/2/10), and
SDXL's text_time added conditioning, unpacked from one extra context row.
`build_attn_metas` is the JAX package's.  `cfg_shared_prefix` runs the
prefix up to the first cross-attention once for both classifier-free-
guidance halves, as the JAX UNet does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attn_ctrl import AttnHooks, AttnLayerMeta, ResnetMeta
from .attention import Transformer2D
from .layers import (Downsample, GroupNorm, ResnetBlock, TimestepEmbedding, Upsample,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int = 8
    # SD-2.x / XL: a fixed head width, the head count per stage ch // head_dim
    # (num_heads ignored); None (SD-1.x) fixes the head count instead
    head_dim: Optional[int] = None
    # SD-2.x / XL: linear proj_in / proj_out on the flattened tokens
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    # SDXL: transformer blocks per Transformer2D by stage (the mid block takes
    # the last); None is depth 1 everywhere
    transformer_depth: Optional[Tuple[int, ...]] = None
    # SDXL text_time: the time embedding plus a projection of [pooled text
    # embedding; sinusoidal embeddings of the 6 micro-conditioning ids],
    # packed by the engine into context row `context_tokens`
    addition_embed: bool = False
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280
    context_tokens: int = 77  # the context rows cross-attention sees

    @property
    def num_stages(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_for(self, ch: int) -> int:
        if self.head_dim is not None:
            if ch % self.head_dim:
                raise ValueError(f"{ch} channels are not a multiple of head_dim "
                                 f"{self.head_dim}")
            return ch // self.head_dim
        return self.num_heads

    def depth_for(self, stage: int) -> int:
        return 1 if self.transformer_depth is None else self.transformer_depth[stage]


def build_attn_metas(config: UNetConfig) -> Dict[str, Tuple[AttnLayerMeta, ...]]:
    """Static attention-layer metadata in forward-execution order; keys
    f"down_{i}_{j}", "mid", f"up_{i}_{j}", one per Transformer2D, each a flat
    run of (self, cross) pairs, one pair per transformer block (depth 1: 2
    metas; SDXL's depth-10 stages: 20).  Self layers are numbered in forward
    order, as masactrl's start layer counts them."""
    metas: Dict[str, Tuple[AttnLayerMeta, ...]] = {}
    n = 0  # transformer blocks so far

    def add(key: str, place: str, res: int, ch: int, depth: int):
        nonlocal n
        heads = config.heads_for(ch)
        ms = []
        for _ in range(depth):
            ms += [AttnLayerMeta(2 * n, False, place, res, n, -1, heads),
                   AttnLayerMeta(2 * n + 1, True, place, res, -1, n, heads)]
            n += 1
        metas[key] = tuple(ms)

    res = config.sample_size
    chans = config.block_out_channels
    for i in range(config.num_stages):
        if config.attn_down[i]:
            for j in range(config.layers_per_block):
                add(f"down_{i}_{j}", "down", res, chans[i], config.depth_for(i))
        if i < config.num_stages - 1:
            res //= 2
    add("mid", "mid", res, chans[-1], config.depth_for(config.num_stages - 1))
    for i in reversed(range(config.num_stages)):
        if config.attn_down[i]:
            for j in range(config.layers_per_block + 1):
                add(f"up_{config.num_stages - 1 - i}_{j}", "up", res, chans[i],
                    config.depth_for(i))
        if i > 0:
            res *= 2
    return metas


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        self.metas = build_attn_metas(cfg)
        g = cfg.norm_num_groups
        c0 = cfg.block_out_channels[0]
        tdim = cfg.time_embed_dim
        self.time_embedding = TimestepEmbedding(c0, tdim)
        if cfg.addition_embed:
            self.add_embedding = TimestepEmbedding(
                cfg.addition_pooled_dim + 6 * cfg.addition_time_embed_dim, tdim)
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)

        def transformer(key, ch):
            heads = cfg.heads_for(ch)
            return Transformer2D(ch, heads, ch // heads, cfg.cross_attention_dim,
                                 self.metas[key], groups=g,
                                 use_linear=cfg.use_linear_projection)

        skips: List[int] = [c0]
        cur = c0
        for i, ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", ResnetBlock(cur, ch, tdim, g))
                cur = ch
                if cfg.attn_down[i]:
                    self.add_module(f"down_{i}_attn_{j}", transformer(f"down_{i}_{j}", ch))
                skips.append(ch)
            if i < cfg.num_stages - 1:
                self.add_module(f"down_{i}_downsample", Downsample(ch))
                skips.append(ch)
        self.mid_resnet_0 = ResnetBlock(cur, cur, tdim, g)
        self.mid_attn = transformer("mid", cur)
        self.mid_resnet_1 = ResnetBlock(cur, cur, tdim, g)
        for up_i, stage in enumerate(reversed(range(cfg.num_stages))):
            ch = cfg.block_out_channels[stage]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{up_i}_resnet_{j}",
                                ResnetBlock(cur + skips.pop(), ch, tdim, g))
                cur = ch
                if cfg.attn_down[stage]:
                    self.add_module(f"up_{up_i}_attn_{j}", transformer(f"up_{up_i}_{j}", ch))
            if stage > 0:
                self.add_module(f"up_{up_i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm(g, cur, eps=1e-5)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                hooks: Optional[AttnHooks] = None,
                store: Optional[Dict[str, torch.Tensor]] = None,
                cfg_shared_prefix: bool = False):
        """sample: (B, 4, h, w) latent; timesteps: int or (B,); context:
        (B, 77, cross_attention_dim), or with `addition_embed` (B, 78, ...)
        whose last row packs [pooled embedding; 6 micro-conditioning ids]
        (models/__init__.py `encode_text`; cross-attention sees the first 77
        rows).  Returns the raw prediction (B, 4, h, w) in the parameters'
        dtype: eps, or v for a v-prediction schedule (the engine converts,
        inversion/base.py `to_eps`).  Layers whose hooks store probabilities
        write them into `store`.

        cfg_shared_prefix: sample carries B rows but the context 2B ([u_1..u_B,
        c_1..c_B]): the guidance halves share the latent, so the prefix up to
        the first cross-attention runs on B rows and the hidden states are
        tiled there (exact; the caller makes sure no hook acts on the prefix,
        AttnHooks.cfg_prefix_safe).  Returns 2B rows.  Refused with
        `addition_embed`, whose pooled row tells the halves apart from the
        first resnet."""
        cfg = self.config
        dt = self.conv_in.weight.dtype
        b = sample.shape[0]
        if cfg.addition_embed:
            if cfg_shared_prefix:
                raise ValueError("cfg_shared_prefix: with added conditioning the rows differ "
                                 "before the first cross-attention")
            if encoder_hidden_states.shape[0] != b:
                raise ValueError(f"{b} latent rows, {encoder_hidden_states.shape[0]} context "
                                 f"rows")
            if encoder_hidden_states.shape[1] != cfg.context_tokens + 1:
                raise ValueError(
                    f"addition_embed expects a packed context with one extra row "
                    f"({cfg.context_tokens}+1 tokens; see encode_text), got "
                    f"{encoder_hidden_states.shape[1]}")
            add_row = encoder_hidden_states[:, cfg.context_tokens]
            ctx = encoder_hidden_states[:, :cfg.context_tokens].to(dt)
        else:
            ctx = encoder_hidden_states.to(dt)
        t = torch.as_tensor(timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(b)
        temb = timestep_embedding(t, cfg.block_out_channels[0])
        temb = self.time_embedding(temb.to(dt))
        if cfg.addition_embed:
            # diffusers' text_time path: each of the 6 ids through the
            # timestep table, after the pooled embedding
            pd = cfg.addition_pooled_dim
            t_add = timestep_embedding(add_row[:, pd:pd + 6].reshape(-1).float(),
                                       cfg.addition_time_embed_dim)
            aug = torch.cat([add_row[:, :pd].float(), t_add.reshape(b, -1)], dim=-1)
            temb = temb + self.add_embedding(aug.to(dt))
        m = self._modules
        dup_pending = cfg_shared_prefix

        def transformer(name: str, x):
            nonlocal dup_pending, temb
            x = m[name](x, ctx, hooks, store, dup=dup_pending)
            dup_pending = False
            if temb.shape[0] != x.shape[0]:
                temb = temb.repeat(x.shape[0] // temb.shape[0], 1)
            return x

        x = self.conv_in(sample.to(dt))
        skips = [x]
        for i in range(cfg.num_stages):
            for j in range(cfg.layers_per_block):
                x = m[f"down_{i}_resnet_{j}"](x, temb)
                if cfg.attn_down[i]:
                    x = transformer(f"down_{i}_attn_{j}", x)
                skips.append(x)
            if i < cfg.num_stages - 1:
                x = m[f"down_{i}_downsample"](x)
                skips.append(x)
        x = self.mid_resnet_0(x, temb)
        x = transformer("mid_attn", x)
        x = self.mid_resnet_1(x, temb)
        for up_i, stage in enumerate(reversed(range(cfg.num_stages))):
            for j in range(cfg.layers_per_block + 1):
                skip = skips.pop()
                if skip.shape[0] != x.shape[0]:  # saved before the shared prefix's tiling
                    skip = skip.repeat(x.shape[0] // skip.shape[0], 1, 1, 1)
                x = torch.cat([x, skip], dim=1)
                inner = None
                if hooks is not None:
                    rmeta = ResnetMeta(up_i, j, x.shape[2])
                    inner = lambda h, rm=rmeta: hooks.resnet(rm, h)  # noqa: E731
                x = m[f"up_{up_i}_resnet_{j}"](x, temb, inner_hook=inner)
                if cfg.attn_down[stage]:
                    x = transformer(f"up_{up_i}_attn_{j}", x)
            if stage > 0:
                x = m[f"up_{up_i}_upsample"](x)
        if dup_pending:  # no attention layer: tile at the end
            x = x.repeat(2, 1, 1, 1)
        x = F.silu(self.conv_norm_out(x)).to(dt)
        return self.conv_out(x)
