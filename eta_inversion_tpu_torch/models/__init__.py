"""Model layer: Stable Diffusion bundle + image pre/post-processing.

Counterpart of eta_inversion_tpu/models/__init__.py, with its eight presets:
SD-1.5 (`sd15`), SD-2.1 base (`sd21`, 512 px), SD-2.1 at 768 px with
v-prediction (`sd21v`), SDXL base (`sdxl`, 1024 px: depth-10 transformers,
two text towers, text_time conditioning), and their tiny homologues for the
CPU tests (`tiny`, `tiny21`, `tinyv`, `tinyxl`).  Weights come from a diffusers-layout checkpoint directory
(`weights_dir`, models/weights.py), or from a seeded random init made on the
device with a `torch.Generator`, with the initializer families of the flax
modules (lecun-normal kernels, zero biases, unit norm scales), so activations
at full width sit in the same range as in the JAX preset; or from a flax
parameter tree through `DiffusionModel.load_jax_params`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..schedulers.tables import ScheduleConfig
from .clip import CLIPTextConfig, CLIPTextEncoder
from .convert import from_jax_params
from .tokenizer import TokenizerBase, load_tokenizer
from .unet import UNet2DCondition, UNetConfig, build_attn_metas
from .vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    image_size: int
    unet: UNetConfig
    vae: VAEConfig
    text: CLIPTextConfig
    # SDXL's second text tower (OpenCLIP bigG with the pooled projection):
    # its penultimate states go after the first tower's on the feature axis,
    # its pooled embedding into the added conditioning
    text2: Optional[CLIPTextConfig] = None
    # prediction_type "v_prediction" for SD-2.1 768-v: the engine converts the
    # UNet's v to eps (inversion/base.py to_eps)
    schedule: ScheduleConfig = ScheduleConfig()


SD15 = ModelPreset(name="sd15", image_size=512, unet=UNetConfig(), vae=VAEConfig(),
                   text=CLIPTextConfig())

# tiny architecture-homologous preset for CPU tests
TINY = ModelPreset(
    name="tiny",
    image_size=16,
    unet=UNetConfig(sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
                    cross_attention_dim=32, num_heads=2, norm_num_groups=8,
                    attn_down=(True, False)),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8),
    text=CLIPTextConfig(vocab_size=1024, hidden_size=32, num_layers=2, num_heads=2),
)

# SD-2.1 base (512 px, eps): 64-wide heads (5/10/20/20 per stage), linear
# transformer projections, 1024-d cross-attention from the OpenCLIP ViT-H
# text tower (23 layers as HF ships it, exact gelu); SD-1.x's 32-layer
# attention topology
SD21 = ModelPreset(
    name="sd21", image_size=512,
    unet=UNetConfig(cross_attention_dim=1024, head_dim=64, use_linear_projection=True),
    vae=VAEConfig(),
    text=CLIPTextConfig(hidden_size=1024, num_layers=23, num_heads=16, act="gelu"),
)

TINY21 = ModelPreset(
    name="tiny21", image_size=16,
    unet=UNetConfig(sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
                    cross_attention_dim=32, head_dim=16, use_linear_projection=True,
                    norm_num_groups=8, attn_down=(True, False)),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8),
    text=CLIPTextConfig(vocab_size=1024, hidden_size=32, num_layers=2, num_heads=2,
                        act="gelu"),
)

# SDXL base 1.0 (1024 px): three stages (320/640/1280, no attention at full
# resolution), transformer depth 1/2/10 (70 blocks, 140 attention layers),
# 2048-d cross-attention fed by two towers (CLIP ViT-L and OpenCLIP bigG,
# both at their penultimate layer), text_time added conditioning, the VAE's
# scaling factor 0.13025
SDXL = ModelPreset(
    name="sdxl", image_size=1024,
    unet=UNetConfig(sample_size=128, block_out_channels=(320, 640, 1280),
                    cross_attention_dim=2048, head_dim=64, use_linear_projection=True,
                    attn_down=(False, True, True), transformer_depth=(1, 2, 10),
                    addition_embed=True),
    vae=VAEConfig(scaling_factor=0.13025),
    text=CLIPTextConfig(penultimate=True),
    text2=CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20, act="gelu",
                         penultimate=True, projection_dim=1280),
)

TINYXL = ModelPreset(
    name="tinyxl", image_size=16,
    unet=UNetConfig(sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
                    cross_attention_dim=32, head_dim=16, use_linear_projection=True,
                    norm_num_groups=8, attn_down=(False, True), transformer_depth=(1, 2),
                    addition_embed=True, addition_time_embed_dim=8, addition_pooled_dim=16),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8),
    text=CLIPTextConfig(vocab_size=1024, hidden_size=16, num_layers=2, num_heads=2,
                        penultimate=True),
    text2=CLIPTextConfig(vocab_size=1024, hidden_size=16, num_layers=2, num_heads=2,
                         act="gelu", penultimate=True, projection_dim=16),
)

# SD-2.1 at 768 px (stabilityai/stable-diffusion-2-1): sd21's geometry on
# 96x96 latents, v-prediction
SD21V = ModelPreset(
    name="sd21v", image_size=768, unet=dataclasses.replace(SD21.unet, sample_size=96),
    vae=VAEConfig(), text=SD21.text, schedule=ScheduleConfig(prediction_type="v_prediction"))

TINYV = dataclasses.replace(TINY, name="tinyv",
                            schedule=ScheduleConfig(prediction_type="v_prediction"))

PRESETS: Dict[str, ModelPreset] = {"sd15": SD15, "tiny": TINY, "sd21": SD21,
                                   "tiny21": TINY21, "sdxl": SDXL, "tinyxl": TINYXL,
                                   "sd21v": SD21V, "tinyv": TINYV}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiffusionModel:
    """UNet + VAE + text encoder(s) + tokenizer + schedule config on one
    device.  `nets` holds the modules under the flax tree's top-level keys
    ("unet", "vae", "text", and SDXL's "text2")."""

    def __init__(self, preset: ModelPreset, tokenizer: TokenizerBase,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda"):
        self.preset = preset
        self.name = preset.name
        self.image_size = preset.image_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.schedule_config = preset.schedule
        self.tokenizer = tokenizer
        with torch.device(self.device):  # allocated where they run, not on the host first
            nets = {"unet": UNet2DCondition(preset.unet), "vae": AutoencoderKL(preset.vae),
                    "text": CLIPTextEncoder(preset.text)}
            if preset.text2 is not None:
                nets["text2"] = CLIPTextEncoder(preset.text2)
            self.nets = nn.ModuleDict(nets).requires_grad_(False).eval()
        self.attn_metas = build_attn_metas(preset.unet)

    @property
    def unet(self) -> UNet2DCondition:
        return self.nets["unet"]

    @property
    def vae(self) -> AutoencoderKL:
        return self.nets["vae"]

    @property
    def text_encoder(self) -> CLIPTextEncoder:
        return self.nets["text"]

    @property
    def text_encoder_2(self) -> Optional[CLIPTextEncoder]:
        return self.nets["text2"] if "text2" in self.nets else None

    @property
    def latent_size(self) -> int:
        return self.preset.unet.sample_size

    @property
    def latent_channels(self) -> int:
        return self.preset.vae.latent_channels

    @property
    def scaling_factor(self) -> float:
        return self.preset.vae.scaling_factor

    # ---- weights -------------------------------------------------------------

    def init_random_(self, seed: int = 0) -> "DiffusionModel":
        """Seeded random init on the device: fp32 draws, then cast, one
        module at a time (an fp32 SDXL UNet alone is 10.3 GB)."""
        g = torch.Generator(self.device).manual_seed(seed)
        for net in self.nets.values():
            net.float()
            init_like_flax_(net, g)
            net.to(self.dtype)
        return self

    def load_pretrained_(self, weights_dir: str) -> "DiffusionModel":
        """Load a diffusers-layout checkpoint directory (models/weights.py),
        one tensor at a time, cast to the model dtype on its device."""
        from .weights import load_pretrained_params

        self.nets.to(self.dtype)
        load_pretrained_params(self.nets, weights_dir, self.preset)
        return self

    def load_jax_params(self, np_tree: Mapping[str, Any]) -> "DiffusionModel":
        """Load a flax tree {"unet": ..., "vae": ..., "text"[, "text2"]: ...}
        of numpy arrays (see models/convert.py)."""
        state = {k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in from_jax_params(np_tree).items()}
        self.nets.load_state_dict(state, strict=True)
        return self

    # ---- forward passes ------------------------------------------------------

    def encode_text(self, input_ids) -> torch.Tensor:
        """(B, 77) token ids -> the engine's context.  One tower: (B, 77, D)
        hidden states.  Two (SDXL): both towers' penultimate states side by
        side on the feature axis in the model dtype, and one more row packing
        [pooled embedding of tower 2; the 6 micro-conditioning ids] (B, 78,
        D); only the UNet unpacks it.  Tower 2 pads with id 0, not eos (HF's
        SDXL tokenizer_2), so the ids after the first eos are rewritten to 0
        for it.  The ids (orig h, w, crop top, left, target h, w) are the
        SDXL pipeline's for an uncropped generation at the preset's size."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        h1 = self.text_encoder(ids)
        if self.text_encoder_2 is None:
            return h1
        eos = (ids == self.tokenizer.eos_token_id).int().argmax(dim=-1)
        trailing = torch.arange(ids.shape[1], device=ids.device)[None] > eos[:, None]
        h2, pooled = self.text_encoder_2(torch.where(trailing, 0, ids))
        ctx = torch.cat([h1.to(self.dtype), h2.to(self.dtype)], dim=-1)
        b, _, d = ctx.shape
        pd = self.preset.unet.addition_pooled_dim
        size = float(self.image_size)
        row = torch.zeros((b, 1, d), dtype=ctx.dtype, device=ctx.device)
        row[:, 0, :pd] = pooled.to(ctx.dtype)
        row[:, 0, pd:pd + 6] = torch.tensor([size, size, 0.0, 0.0, size, size],
                                            dtype=ctx.dtype, device=ctx.device)
        return torch.cat([ctx, row], dim=1)


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    # flax lecun_normal: variance_scaling(1, fan_in, truncated_normal), i.e. a
    # standard normal truncated to [-2, 2], rescaled by its own std (0.8796)
    torch.nn.init.trunc_normal_(t, 0.0, std / 0.87962566103423978, -2 * std / 0.87962566103423978,
                                2 * std / 0.87962566103423978, generator=g)


def init_like_flax_(root: nn.Module, g: torch.Generator) -> None:
    """The flax initializers of the JAX modules: lecun-normal conv / dense
    kernels, zero biases, unit norm scales, fan-in normal embeddings, and
    N(0, 0.01) for the CLIP position table, N(0, 0.02) for its text
    projection."""
    for mod in root.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            _trunc_normal_(mod.weight, math.sqrt(1.0 / fan_in), g)
        elif isinstance(mod, nn.Linear):
            _trunc_normal_(mod.weight, math.sqrt(1.0 / mod.in_features), g)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, math.sqrt(1.0 / mod.embedding_dim), generator=g)
        elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
        if isinstance(getattr(mod, "bias", None), torch.Tensor):
            mod.bias.zero_()
        if isinstance(mod, CLIPTextEncoder):
            mod.position_embedding.normal_(0.0, 0.01, generator=g)
            if mod.config.projection_dim is not None:
                mod.text_projection.normal_(0.0, 0.02, generator=g)


def load_diffusion_model(model: str = "sd15", dtype: str = "float32", seed: int = 0,
                         weights_dir: Optional[str] = None,
                         preproc_args: Optional[dict] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> Tuple[DiffusionModel, Tuple["StablePreprocess", "StablePostProc"]]:
    """Returns (model bundle, (preprocess, postprocess)), on the card unless
    the caller asks for the CPU (``device="cpu"``).  With `weights_dir`, a
    diffusers-layout checkpoint directory ({unet,vae,text_encoder}/
    *.safetensors) of the preset's architecture gives the weights, and its
    tokenizer/ (vocab.json + merges.txt) the CLIP BPE tokenizer when it has
    one; otherwise the weights are a seeded random init and the tokenizer
    the hash fallback."""
    if model not in PRESETS:
        raise ValueError(f"unknown model preset {model!r}; available: {sorted(PRESETS)}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}; available: {sorted(DTYPES)}")
    preset = PRESETS[model]
    tokenizer = load_tokenizer(weights_dir or None, vocab_size=preset.text.vocab_size)
    with torch.no_grad():
        bundle = DiffusionModel(preset, tokenizer, dtype=DTYPES[dtype], device=device)
        if weights_dir:
            bundle.load_pretrained_(weights_dir)
        else:
            bundle.init_random_(seed)
    pre = StablePreprocess(size=bundle.image_size, **(preproc_args or {}))
    return bundle, (pre, StablePostProc())


class StablePreprocess:
    """File / array / PIL image -> center-crop -> LANCZOS resize -> float32
    [-1, 1] NHWC numpy (1, size, size, 3)."""

    def __init__(self, size: int = 512, center_crop: bool = True):
        self.size = size
        self.center_crop = center_crop

    def __call__(self, image) -> np.ndarray:
        from PIL import Image

        if isinstance(image, str):
            img = Image.open(image).convert("RGB")
        elif isinstance(image, np.ndarray):
            img = Image.fromarray(image.astype(np.uint8))
        else:
            img = image.convert("RGB")
        if self.center_crop:
            w, h = img.size
            side = min(w, h)
            img = img.crop(((w - side) // 2, (h - side) // 2,
                            (w - side) // 2 + side, (h - side) // 2 + side))
        if img.size != (self.size, self.size):
            img = img.resize((self.size, self.size), Image.Resampling.LANCZOS)
        arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
        return arr[None]


class StablePostProc:
    """NHWC [-1, 1] image -> uint8 HWC (the first image of a batch).  A device
    tensor converts to uint8 on the device before the copy to the host."""

    def __call__(self, image) -> np.ndarray:
        x = self.batch(image)
        return x[0] if x.ndim == 4 else x

    def batch(self, images) -> np.ndarray:
        x = torch.as_tensor(images).float()
        x = torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)
        return torch.round(x * 255.0).to(torch.uint8).cpu().numpy()
