"""Model layer: Stable Diffusion bundle + image pre/post-processing.

Counterpart of eta_inversion_tpu/models/__init__.py for the `sd15` and `tiny`
presets.  Weights come from a seeded random init made on the device with a
`torch.Generator`, with the initializer families of the flax modules
(lecun-normal kernels, zero biases, unit norm scales), so activations at full
width sit in the same range as in the JAX preset; or from a flax parameter
tree through `DiffusionModel.load_jax_params`.
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

PRESETS: Dict[str, ModelPreset] = {"sd15": SD15, "tiny": TINY}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DiffusionModel:
    """UNet + VAE + text encoder + tokenizer + schedule config on one device.
    `nets` holds the three modules under the flax tree's top-level keys
    ("unet", "vae", "text")."""

    def __init__(self, preset: ModelPreset, tokenizer: TokenizerBase,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cpu"):
        self.preset = preset
        self.name = preset.name
        self.image_size = preset.image_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.schedule_config = preset.schedule
        self.tokenizer = tokenizer
        self.nets = nn.ModuleDict({
            "unet": UNet2DCondition(preset.unet),
            "vae": AutoencoderKL(preset.vae),
            "text": CLIPTextEncoder(preset.text),
        }).to(self.device).requires_grad_(False).eval()
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
        """Seeded random init on the device (fp32 draws, then cast)."""
        self.nets.float()
        init_like_flax_(self.nets, torch.Generator(self.device).manual_seed(seed))
        self.nets.to(self.dtype)
        return self

    def load_jax_params(self, np_tree: Mapping[str, Any]) -> "DiffusionModel":
        """Load a flax tree {"unet": ..., "vae": ..., "text": ...} of numpy
        arrays (see models/convert.py)."""
        state = {k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in from_jax_params(np_tree).items()}
        self.nets.load_state_dict(state, strict=True)
        return self

    # ---- forward passes ------------------------------------------------------

    def encode_text(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        return self.text_encoder(ids)


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    # flax lecun_normal: variance_scaling(1, fan_in, truncated_normal), i.e. a
    # standard normal truncated to [-2, 2], rescaled by its own std (0.8796)
    torch.nn.init.trunc_normal_(t, 0.0, std / 0.87962566103423978, -2 * std / 0.87962566103423978,
                                2 * std / 0.87962566103423978, generator=g)


def init_like_flax_(root: nn.Module, g: torch.Generator) -> None:
    """The flax initializers of the JAX modules: lecun-normal conv / dense
    kernels, zero biases, unit norm scales, fan-in normal embeddings, and
    N(0, 0.01) for the CLIP position table."""
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


def load_diffusion_model(model: str = "sd15", dtype: str = "float32", seed: int = 0,
                         weights_dir: Optional[str] = None,
                         preproc_args: Optional[dict] = None,
                         device: Union[str, torch.device] = "cpu"
                         ) -> Tuple[DiffusionModel, Tuple["StablePreprocess", "StablePostProc"]]:
    """Returns (model bundle with seeded random weights, (preprocess,
    postprocess)).  `device` is explicit: "cuda" for the card."""
    if model not in PRESETS:
        raise ValueError(f"model preset {model!r} is not ported yet; ported: "
                         f"{sorted(PRESETS)}")
    if weights_dir:
        raise NotImplementedError("checkpoint loading is not ported yet "
                                  "(ROADMAP, Queue 1); weights are a seeded random init")
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}; available: {sorted(DTYPES)}")
    preset = PRESETS[model]
    with torch.no_grad():
        bundle = DiffusionModel(preset, load_tokenizer(None, vocab_size=preset.text.vocab_size),
                                dtype=DTYPES[dtype], device=device).init_random_(seed)
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
