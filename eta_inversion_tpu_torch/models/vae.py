"""AutoencoderKL (Stable Diffusion VAE), NCHW.

Counterpart of eta_inversion_tpu/models/vae.py; encoding takes the posterior
mean (deterministic), scaling factor 0.18215 applied by the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import attention
from .layers import GroupNorm, ResnetBlock, Upsample


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block (at 512 px:
    S=4096, d=512, the flash kernel's blockwise entry)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).to(x.dtype).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        o = attention(q[:, None], k[:, None], v[:, None], c ** -0.5)[:, 0]
        o = self.to_out(o)
        return x + o.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEDownsample(nn.Module):
    """Stride-2 conv with the VAE's asymmetric (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        self.cfg = cfg
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0], 3, padding=1)
        cur = cfg.block_out_channels[0]
        for i, ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", ResnetBlock(cur, ch, None, g))
                cur = ch
            if i < len(cfg.block_out_channels) - 1:
                self.add_module(f"down_{i}_downsample", VAEDownsample(ch))
        self.mid_resnet_0 = ResnetBlock(cur, cur, None, g)
        self.mid_attn = VAEAttention(cur, g)
        self.mid_resnet_1 = ResnetBlock(cur, cur, None, g)
        self.conv_norm_out = GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        cfg, m = self.cfg, self._modules
        x = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                x = m[f"down_{i}_resnet_{j}"](x)
            if i < len(cfg.block_out_channels) - 1:
                x = m[f"down_{i}_downsample"](x)
        x = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(x)))
        x = F.silu(self.conv_norm_out(x)).to(self.conv_out.weight.dtype)
        return self.conv_out(x)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        self.cfg = cfg
        cur = cfg.block_out_channels[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, cur, 3, padding=1)
        self.mid_resnet_0 = ResnetBlock(cur, cur, None, g)
        self.mid_attn = VAEAttention(cur, g)
        self.mid_resnet_1 = ResnetBlock(cur, cur, None, g)
        for up_i, stage in enumerate(reversed(range(len(cfg.block_out_channels)))):
            ch = cfg.block_out_channels[stage]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{up_i}_resnet_{j}", ResnetBlock(cur, ch, None, g))
                cur = ch
            if stage > 0:
                self.add_module(f"up_{up_i}_upsample", Upsample(ch))
        self.conv_norm_out = GroupNorm(g, cur, eps=1e-6)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        cfg, m = self.cfg, self._modules
        x = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(self.conv_in(z))))
        for up_i, stage in enumerate(reversed(range(len(cfg.block_out_channels)))):
            for j in range(cfg.layers_per_block + 1):
                x = m[f"up_{up_i}_resnet_{j}"](x)
            if stage > 0:
                x = m[f"up_{up_i}_upsample"](x)
        x = F.silu(self.conv_norm_out(x)).to(self.conv_out.weight.dtype)
        return self.conv_out(x)


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def encode(self, x):
        """(B, 3, H, W) [-1, 1] image -> posterior mean (B, 4, h, w)."""
        x = x.to(self.quant_conv.weight.dtype)
        moments = self.quant_conv(self.encoder(x))
        return moments[:, : self.config.latent_channels]

    def decode(self, z):
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
