"""Pretrained-weight loading: a diffusers-layout checkpoint directory onto the
port's modules.

Counterpart of eta_inversion_tpu/models/weights.py.  Weights arrive as local
files (no network): `{unet,vae,text_encoder}/*.safetensors` (SDXL also
`text_encoder_2/`; and optionally `tokenizer/vocab.json` + `merges.txt`).
This module holds

  * a dependency-free safetensors reader and writer (an 8-byte little-endian
    header length, a JSON header, the raw tensor bytes), F32 / F16 / BF16 /
    F64 and the integer types;
  * the key maps from diffusers' state-dict names onto the port's module
    names.  The port's modules carry the flax module names
    (models/convert.py), so each map is the JAX package's with the flax
    path joined by "." and the leaf renamed as torch names it (kernel,
    scale, embedding -> weight).  Torch layouts are diffusers' own, so no
    value is transposed but SDXL's `text_projection` (a raw (hidden, proj)
    parameter, as the flax module keeps it, stored by transformers as a
    bias-free linear (proj, hidden) weight: TRANSPOSED); the legacy VAE
    attention keys (renamed, their (C, C, 1, 1) 1x1-conv weights squeezed to
    linear (C, C)) and a 1x1-conv vs linear projection (same values, another
    shape) are the other keys that are not the identity;
  * `load_pretrained_params(nets, weights_dir, preset)`, which copies the
    checkpoint into the modules one tensor at a time: each tensor is read
    into a buffer of its own size and copied to the module's device and
    dtype before the next is read, so a 3.4 GB fp32 UNet file never sits
    whole on the host.

The maps cover the port's presets: SD-1.x (1x1-conv projections), SD-2.x
(linear projections) and SDXL (transformer depth, `add_embedding`, the
second text tower with its projection).
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .clip import CLIPTextConfig
from .unet import UNetConfig
from .vae import VAEConfig

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}

KeyMap = Dict[str, str]  # diffusers key -> the port's state-dict key
# the diffusers keys whose value is the transpose of the port's parameter
TRANSPOSED = frozenset({"text_projection.weight"})


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """({tensor name: {"dtype", "shape", "data_offsets"}}, byte offset of the
    data) of a safetensors file; the "__metadata__" entry is dropped."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_safetensors(path: str, names: Optional[Iterable[str]] = None
                     ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of each tensor of the file (only `names` when
    given), in file order, each read into a buffer of its own: the caller
    holds one tensor at a time unless it keeps them."""
    header, start = read_header(path)
    wanted = None if names is None else set(names)
    with open(path, "rb") as f:
        for name, meta in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if wanted is not None and name not in wanted:
                continue
            if meta["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, not one of "
                                 f"{sorted(DTYPES)}")
            dtype = DTYPES[meta["dtype"]]
            lo, hi = meta["data_offsets"]
            if hi == lo:
                yield name, torch.empty(meta["shape"], dtype=dtype)
                continue
            buf = bytearray(hi - lo)
            f.seek(start + lo)
            if f.readinto(buf) != hi - lo:
                raise ValueError(f"{path}: {name} is cut short")
            yield name, torch.frombuffer(buf, dtype=dtype).reshape(meta["shape"])


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors of its dtypes."""
    return dict(iter_safetensors(path))


def write_safetensors(path: str, tensors: Mapping[str, object],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays or tensors (any device; copied to the host one at a
    time, each in its own dtype) as a safetensors file."""
    def as_tensor(x) -> torch.Tensor:
        return x.detach() if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))

    header: Dict[str, object] = {}
    offset = 0
    for name, x in tensors.items():
        t = as_tensor(x)
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    hj = json.dumps(header).encode()
    hj += b" " * (-len(hj) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for x in tensors.values():
            t = as_tensor(x).to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())


# ---------------------------------------------------------------------------
# key maps (diffusers name -> the port's module name)
# ---------------------------------------------------------------------------

def _norm(m: KeyMap, tp: str, pp: str) -> None:
    m[f"{tp}.weight"] = f"{pp}.weight"
    m[f"{tp}.bias"] = f"{pp}.bias"


_conv = _norm  # a conv's weight and bias keep their names (and torch layout)


def _dense(m: KeyMap, tp: str, pp: str, bias: bool = True) -> None:
    m[f"{tp}.weight"] = f"{pp}.weight"
    if bias:
        m[f"{tp}.bias"] = f"{pp}.bias"


def _resnet(m: KeyMap, tp: str, pp: str, time_emb: bool = True,
            has_shortcut: bool = False) -> None:
    _norm(m, f"{tp}.norm1", f"{pp}.norm1")
    _conv(m, f"{tp}.conv1", f"{pp}.conv1")
    if time_emb:
        _dense(m, f"{tp}.time_emb_proj", f"{pp}.time_emb_proj")
    _norm(m, f"{tp}.norm2", f"{pp}.norm2")
    _conv(m, f"{tp}.conv2", f"{pp}.conv2")
    if has_shortcut:
        _conv(m, f"{tp}.conv_shortcut", f"{pp}.conv_shortcut")


def _transformer(m: KeyMap, tp: str, pp: str, depth: int = 1) -> None:
    """A Transformer2D of `depth` blocks; its projections' weight and bias
    keep their names whether 1x1 convs or linear layers."""
    _norm(m, f"{tp}.norm", f"{pp}.norm")
    _conv(m, f"{tp}.proj_in", f"{pp}.proj_in")
    _conv(m, f"{tp}.proj_out", f"{pp}.proj_out")
    for d in range(depth):
        b, pb = f"{tp}.transformer_blocks.{d}", f"{pp}.blocks_{d}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(m, f"{b}.{n}", f"{pb}.{n}")
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _dense(m, f"{b}.{attn}.{proj}", f"{pb}.{attn}.{proj}", bias=False)
            _dense(m, f"{b}.{attn}.to_out.0", f"{pb}.{attn}.to_out")
        _dense(m, f"{b}.ff.net.0.proj", f"{pb}.ff.geglu_proj")
        _dense(m, f"{b}.ff.net.2", f"{pb}.ff.proj_out")


def unet_key_map(cfg: UNetConfig) -> KeyMap:
    """diffusers UNet2DConditionModel names -> UNet2DCondition's."""
    m: KeyMap = {}
    _conv(m, "conv_in", "conv_in")
    _dense(m, "time_embedding.linear_1", "time_embedding.linear_1")
    _dense(m, "time_embedding.linear_2", "time_embedding.linear_2")
    ch_prev = cfg.block_out_channels[0]
    for i, ch in enumerate(cfg.block_out_channels):
        for j in range(cfg.layers_per_block):
            in_ch = ch_prev if j == 0 else ch
            _resnet(m, f"down_blocks.{i}.resnets.{j}", f"down_{i}_resnet_{j}",
                    has_shortcut=in_ch != ch)
            if cfg.attn_down[i]:
                _transformer(m, f"down_blocks.{i}.attentions.{j}", f"down_{i}_attn_{j}",
                             cfg.depth_for(i))
        if i < cfg.num_stages - 1:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", f"down_{i}_downsample.conv")
        ch_prev = ch
    _resnet(m, "mid_block.resnets.0", "mid_resnet_0")
    _resnet(m, "mid_block.resnets.1", "mid_resnet_1")
    _transformer(m, "mid_block.attentions.0", "mid_attn", cfg.depth_for(cfg.num_stages - 1))
    # up path: every resnet concatenates a skip, so each has a shortcut
    for up_i, stage in enumerate(reversed(range(cfg.num_stages))):
        for j in range(cfg.layers_per_block + 1):
            _resnet(m, f"up_blocks.{up_i}.resnets.{j}", f"up_{up_i}_resnet_{j}",
                    has_shortcut=True)
            if cfg.attn_down[stage]:
                _transformer(m, f"up_blocks.{up_i}.attentions.{j}", f"up_{up_i}_attn_{j}",
                             cfg.depth_for(stage))
        if stage > 0:
            _conv(m, f"up_blocks.{up_i}.upsamplers.0.conv", f"up_{up_i}_upsample.conv")
    if cfg.addition_embed:  # SDXL's text_time MLP
        _dense(m, "add_embedding.linear_1", "add_embedding.linear_1")
        _dense(m, "add_embedding.linear_2", "add_embedding.linear_2")
    _norm(m, "conv_norm_out", "conv_norm_out")
    _conv(m, "conv_out", "conv_out")
    return m


def _vae_attn(m: KeyMap, tp: str, pp: str) -> None:
    _norm(m, f"{tp}.group_norm", f"{pp}.group_norm")
    for a, b in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out.0", "to_out")):
        _dense(m, f"{tp}.{a}", f"{pp}.{b}")


def vae_key_map(cfg: VAEConfig) -> KeyMap:
    """diffusers AutoencoderKL names -> AutoencoderKL's."""
    m: KeyMap = {}
    _conv(m, "encoder.conv_in", "encoder.conv_in")
    ch_prev = cfg.block_out_channels[0]
    for i, ch in enumerate(cfg.block_out_channels):
        for j in range(cfg.layers_per_block):
            in_ch = ch_prev if j == 0 else ch
            _resnet(m, f"encoder.down_blocks.{i}.resnets.{j}", f"encoder.down_{i}_resnet_{j}",
                    time_emb=False, has_shortcut=in_ch != ch)
        if i < len(cfg.block_out_channels) - 1:
            _conv(m, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  f"encoder.down_{i}_downsample.conv")
        ch_prev = ch
    for part in ("encoder", "decoder"):
        if part == "decoder":
            _conv(m, "decoder.conv_in", "decoder.conv_in")
        _resnet(m, f"{part}.mid_block.resnets.0", f"{part}.mid_resnet_0", time_emb=False)
        _resnet(m, f"{part}.mid_block.resnets.1", f"{part}.mid_resnet_1", time_emb=False)
        _vae_attn(m, f"{part}.mid_block.attentions.0", f"{part}.mid_attn")
        if part == "encoder":
            _norm(m, "encoder.conv_norm_out", "encoder.conv_norm_out")
            _conv(m, "encoder.conv_out", "encoder.conv_out")
            _conv(m, "quant_conv", "quant_conv")
            _conv(m, "post_quant_conv", "post_quant_conv")
    ch_prev = cfg.block_out_channels[-1]
    for up_i, stage in enumerate(reversed(range(len(cfg.block_out_channels)))):
        ch = cfg.block_out_channels[stage]
        for j in range(cfg.layers_per_block + 1):
            in_ch = ch_prev if j == 0 else ch
            _resnet(m, f"decoder.up_blocks.{up_i}.resnets.{j}",
                    f"decoder.up_{up_i}_resnet_{j}", time_emb=False, has_shortcut=in_ch != ch)
        if stage > 0:
            _conv(m, f"decoder.up_blocks.{up_i}.upsamplers.0.conv",
                  f"decoder.up_{up_i}_upsample.conv")
        ch_prev = ch
    _norm(m, "decoder.conv_norm_out", "decoder.conv_norm_out")
    _conv(m, "decoder.conv_out", "decoder.conv_out")
    return m


def clip_text_key_map(cfg: CLIPTextConfig) -> KeyMap:
    """transformers CLIPTextModel (CLIPTextModelWithProjection with a
    projection_dim) names -> CLIPTextEncoder's."""
    p = "text_model"
    m: KeyMap = {f"{p}.embeddings.token_embedding.weight": "token_embedding.weight",
                 f"{p}.embeddings.position_embedding.weight": "position_embedding"}
    for i in range(cfg.num_layers):
        lp, pp = f"{p}.encoder.layers.{i}", f"layers_{i}"
        _norm(m, f"{lp}.layer_norm1", f"{pp}.layer_norm1")
        _norm(m, f"{lp}.layer_norm2", f"{pp}.layer_norm2")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(m, f"{lp}.self_attn.{proj}", f"{pp}.self_attn.{proj}")
        _dense(m, f"{lp}.mlp.fc1", f"{pp}.fc1")
        _dense(m, f"{lp}.mlp.fc2", f"{pp}.fc2")
    _norm(m, f"{p}.final_layer_norm", "final_layer_norm")
    if cfg.projection_dim is not None:  # bias-free, outside text_model
        m["text_projection.weight"] = "text_projection"
    return m


# pre-0.18 diffusers serialized the VAE mid attention as AttentionBlock
# (query / key / value / proj_attn, with 4D (C, C, 1, 1) conv-style weights
# in some exports); the original 2022 sd15 VAE safetensors use these
_LEGACY_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                    "proj_attn": "to_out.0", "group_norm": "group_norm"}


def legacy_key(key: str) -> str:
    """A legacy VAE attention key in the modern layout (others unchanged)."""
    parts = key.split(".")
    if len(parts) >= 4 and parts[-4] == "attentions" and parts[-2] in _LEGACY_VAE_ATTN:
        parts[-2] = _LEGACY_VAE_ATTN[parts[-2]]
    return ".".join(parts)


def _legacy_value(name: str, x: torch.Tensor) -> torch.Tensor:
    """A legacy VAE attention projection's conv-style (C, C, 1, 1) weight
    squeezed to (C, C); any other tensor as it is."""
    if legacy_key(name) != name and name.endswith(".weight") and x.dim() == 4:
        return x.reshape(x.shape[0], x.shape[1])
    return x


def _value(name: str, x: torch.Tensor) -> torch.Tensor:
    """Checkpoint tensor `name` in the layout of the port's parameter: a
    TRANSPOSED key's transpose, a legacy weight squeezed, any other as it
    is.  Written back, the port's value of a TRANSPOSED key is transposed
    the same way."""
    return x.t() if legacy_key(name) in TRANSPOSED else _legacy_value(name, x)


def normalize_legacy_keys(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Rename legacy diffusers VAE attention keys to the modern layout and
    squeeze their conv-style (C, C, 1, 1) projection weights to (C, C)."""
    return {legacy_key(k): _legacy_value(k, v) for k, v in state.items()}


def map_names(names: Iterable[str], key_map: KeyMap, strict: bool = True) -> Dict[str, str]:
    """{checkpoint name: the port's key} for the checkpoint `names` that
    `key_map` names once legacy keys are renamed (the first of duplicates).
    Names the map does not name are ignored (e.g. CLIP's position_ids);
    with `strict` a key the map names but no name gives raises KeyError."""
    found: Dict[str, str] = {}  # diffusers key -> checkpoint name
    for name in names:
        key = legacy_key(name)
        if key in key_map and key not in found:
            found[key] = name
    missing = [k for k in key_map if k not in found]
    if strict and missing:
        raise KeyError(f"missing {len(missing)} keys, e.g. {missing[:5]}")
    return {name: key_map[key] for key, name in found.items()}


def map_state_dict(state: Mapping[str, torch.Tensor], key_map: KeyMap,
                   strict: bool = True) -> Dict[str, torch.Tensor]:
    """A diffusers state dict -> the port's names (`map_names`) and layouts
    (`_value`: a TRANSPOSED key transposed, legacy weights squeezed as
    `normalize_legacy_keys` does, other values as they are)."""
    return {key: _value(name, state[name])
            for name, key in map_names(state, key_map, strict).items()}


# the checkpoint's subdirectories, the port's module of each, its key map
# (None where the preset has no such module)
COMPONENTS = (("unet", "unet", lambda p: unet_key_map(p.unet)),
              ("vae", "vae", lambda p: vae_key_map(p.vae)),
              ("text_encoder", "text", lambda p: clip_text_key_map(p.text)),
              ("text_encoder_2", "text2",
               lambda p: None if p.text2 is None else clip_text_key_map(p.text2)))




def _fit(name: str, x: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """x in the module's shape: the same, or the other form of a 1x1-conv /
    linear weight (O, I, 1, 1) <-> (O, I)."""
    if x.shape == shape:
        return x
    if x.numel() == shape.numel() and [n for n in x.shape if n != 1] == \
            [n for n in shape if n != 1]:
        return x.reshape(shape)
    raise ValueError(f"{name}: checkpoint shape {tuple(x.shape)}, module shape {tuple(shape)}")


def load_component_(module: nn.Module, files: Iterable[str], key_map: KeyMap) -> None:
    """Copy the tensors `key_map` names from safetensors `files` into
    `module`'s parameters (their device and dtype), one tensor at a time,
    named as `map_state_dict` names them (`map_names` on the files' headers).
    KeyError (before any copy) when a mapped key is in none of the files;
    ValueError for a shape the module's parameter cannot take."""
    targets = dict(module.named_parameters())
    where: Dict[str, str] = {}  # checkpoint name -> the first file holding it
    for path in files:
        for name in read_header(path)[0]:
            where.setdefault(name, path)
    by_file: Dict[str, Dict[str, str]] = {}  # file -> {name in file: port key}
    for name, key in map_names(where, key_map).items():
        by_file.setdefault(where[name], {})[name] = key
    unknown = sorted(set(key_map.values()) - set(targets))
    if unknown:
        raise KeyError(f"the key map names {len(unknown)} parameters the module lacks, "
                       f"e.g. {unknown[:5]}")
    with torch.no_grad():
        for path, names in by_file.items():
            for name, x in iter_safetensors(path, names):
                p = targets[names[name]]
                p.copy_(_fit(name, _value(name, x), p.shape))


def load_pretrained_params(nets: Mapping[str, nn.Module], weights_dir: str, preset) -> None:
    """Load a diffusers-layout directory ({unet,vae,text_encoder}/
    *.safetensors, SDXL also text_encoder_2/) into `nets` ({"unet", "vae",
    "text"[, "text2"]} modules, on their device in their dtype).
    FileNotFoundError for a subdirectory without safetensors files."""
    for sub, net, key_map in COMPONENTS:
        if key_map(preset) is None:
            continue
        files = sorted(glob.glob(os.path.join(weights_dir, sub, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no safetensors under {os.path.join(weights_dir, sub)}")
        load_component_(nets[net], files, key_map(preset))


def save_pretrained(nets: Mapping[str, nn.Module], weights_dir: str, preset) -> None:
    """Write `nets` as a diffusers-layout directory (the inverse key maps),
    one safetensors file a component, each tensor in its dtype."""
    for sub, net, key_map in COMPONENTS:
        kmap = key_map(preset)
        if kmap is None:
            continue
        params = dict(nets[net].named_parameters())
        os.makedirs(os.path.join(weights_dir, sub), exist_ok=True)
        name = "model.safetensors" if sub.startswith("text_encoder") else \
            "diffusion_pytorch_model.safetensors"
        write_safetensors(os.path.join(weights_dir, sub, name),
                          {k: _value(k, params[v].detach()) for k, v in kmap.items()})
