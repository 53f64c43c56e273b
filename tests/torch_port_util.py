"""Shared weights for the port's comparison tests (tests/test_torch_port_*).

The port's seeded `tiny` init is written out as a flax parameter tree (numpy),
and both sides are built from that one tree: the JAX `DiffusionModel` takes
it as its params, and the port loads it back through `from_jax_params`.  This
skips the JAX preset's jitted init, which costs tens of seconds per process.
"""

import functools

import numpy as np
import torch.nn as nn


def flax_tree(nets: nn.Module) -> dict:
    """Port modules -> nested flax param tree of numpy arrays (the inverse of
    eta_inversion_tpu_torch.models.convert.from_jax_params)."""
    tree: dict = {}
    for name, mod in nets.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        for pname, p in own.items():
            a = p.detach().float().cpu().numpy()
            if pname == "weight":
                if isinstance(mod, nn.Conv2d):
                    node["kernel"] = a.transpose(2, 3, 1, 0)
                elif isinstance(mod, nn.Linear):
                    node["kernel"] = a.T
                elif isinstance(mod, nn.Embedding):
                    node["embedding"] = a
                else:  # norms
                    node["scale"] = a
            else:
                node[pname] = a
    return tree


@functools.lru_cache(maxsize=4)
def tiny_pair(seed: int = 0, preset: str = "tiny"):
    """(JAX DiffusionModel, port DiffusionModel) of a tiny preset ("tiny",
    "tiny21", "tinyv", "tinyxl") with equal weights, fp32, on the CPU."""
    from eta_inversion_tpu.models import PRESETS, DiffusionModel as JaxModel
    from eta_inversion_tpu.models.tokenizer import load_tokenizer
    from eta_inversion_tpu_torch.models import load_diffusion_model

    port, _ = load_diffusion_model(preset, seed=seed, device="cpu")
    tree = flax_tree(port.nets)
    port.load_jax_params(tree)  # weights reach the port through from_jax_params
    jpreset = PRESETS[preset]
    jax_model = JaxModel(jpreset, tree, load_tokenizer(None, vocab_size=jpreset.text.vocab_size),
                         schedule=jpreset.schedule)
    return jax_model, port


def to_nhwc(x):
    """A port tensor (latents NCHW, pairs (2, B, c, h, w), images NHWC) as
    the JAX package lays it out, numpy."""
    return x.movedim(-3, -1).numpy() if x.dim() >= 4 and x.shape[-1] != 3 else x.numpy()


def edit_both(pair, image, inverter, editor, steps, cfg=None, inv_cfg=None,
              inv_kwargs=None, editor_kwargs=None, image_jax=None, port_inv_kwargs=None):
    """The same edit through the JAX package and the port, (want, got), the
    port's outputs laid out as JAX's (to_nhwc); None where an editor
    refuses.  `image_jax` (default `image`) is JAX's input;
    `port_inv_kwargs` go to the port's inverter alone (an injected
    noise_fn)."""
    import copy

    import jax.numpy as jnp

    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu_torch import load_editor, load_inverter

    jax_model, port = pair
    inv_kwargs, editor_kwargs = inv_kwargs or {}, editor_kwargs or {}
    jinv = jinverter(jax_model, inverter, num_inference_steps=steps, **inv_kwargs)
    want = jeditor(jinv, editor, **editor_kwargs).edit(
        jnp.asarray(image if image_jax is None else image_jax), "a cat sitting next to a mirror",
        "a tiger sitting next to a mirror", cfg=copy.deepcopy(cfg), inv_cfg=copy.deepcopy(inv_cfg))
    inv = load_inverter(port, inverter, num_inference_steps=steps, **inv_kwargs,
                        **(port_inv_kwargs or {}))
    got = load_editor(inv, editor, **editor_kwargs).edit(
        image, "a cat sitting next to a mirror", "a tiger sitting next to a mirror",
        cfg=copy.deepcopy(cfg), inv_cfg=copy.deepcopy(inv_cfg))
    if want is None or got is None:
        return want, got
    assert set(got) == set(want), (sorted(got), sorted(want))
    return {k: np.asarray(v) for k, v in want.items()}, {k: to_nhwc(v) for k, v in got.items()}


def write_jax_checkpoint(tree, root, preset) -> None:
    """A flax tree written under `root` as a diffusers-layout checkpoint
    directory with the JAX package's key maps and writer (their inverse
    transforms, tests/test_weights.py); SDXL-style presets also get
    text_encoder_2/."""
    from eta_inversion_tpu.models import weights as jw
    from tests.test_weights import to_torch_state

    parts = [("unet", "unet", jw.unet_key_map(preset.unet)),
             ("vae", "vae", jw.vae_key_map(preset.vae)),
             ("text_encoder", "text", jw.clip_text_key_map(preset.text))]
    if preset.text2 is not None:
        parts.append(("text_encoder_2", "text2", jw.clip_text_key_map(preset.text2)))
    for sub, comp, key_map in parts:
        (root / sub).mkdir(parents=True, exist_ok=True)
        jw.write_safetensors(str(root / sub / "model.safetensors"),
                             to_torch_state(tree[comp], key_map))


def write_tiny_checkpoint(root, preset: str = "tiny") -> tuple:
    """A tiny JAX tree (tiny_pair's of `preset`) written under `root` as a
    diffusers-layout checkpoint directory with the JAX package's key maps,
    and a 20x24 input png beside it: (directory, png path)."""
    from PIL import Image

    jax_model, _ = tiny_pair(preset=preset)
    write_jax_checkpoint(jax_model.params, root, jax_model.preset)
    png = root / "in.png"
    Image.fromarray((np.random.RandomState(0).rand(20, 24, 3) * 255).astype("uint8")).save(png)
    return str(root), str(png)
