"""The port's checkpoint loading (models/weights.py) against the JAX package's,
on the CPU.

The safetensors reader and writer round trip every dtype the port names
(F16 and BF16 reads included) and read what the JAX writer writes; the key
maps name exactly the diffusers keys of JAX's `unet_key_map` /
`vae_key_map` / `clip_text_key_map` for the tiny, sd15, tiny21, sd21,
tinyxl and sdxl presets (built from the configs alone; SDXL's second tower
too), each onto the port's name of the same flax path; tiny21 and tinyxl
trees written by the JAX package's writer load into both packages with the
same UNet output and text context; a
JAX tiny random init, written as diffusers safetensors as
tests/test_weights.py writes it, loads through `load_diffusion_model(...,
weights_dir=...)` bit-equal to the same tree through the `from_jax_params`
bridge; legacy VAE attention keys load, a missing key raises, an extra key
is ignored.
"""

import numpy as np
import pytest
import torch

from eta_inversion_tpu.models import PRESETS as JPRESETS, TINY as JTINY
from eta_inversion_tpu.models import weights as jw
from eta_inversion_tpu_torch.models import PRESETS, load_diffusion_model
from eta_inversion_tpu_torch.models import weights as tw
from tests.torch_port_util import write_jax_checkpoint

LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tiny_init():
    """The JAX package's seeded tiny init (numpy tree)."""
    import jax

    from eta_inversion_tpu.models import init_random_params

    return jax.tree.map(np.asarray, init_random_params(JTINY))


def test_safetensors_round_trip(tmp_path):
    rs = np.random.RandomState(0)
    tensors = {
        "f32": torch.from_numpy(rs.randn(3, 4).astype(np.float32)),
        "f16": torch.from_numpy(rs.randn(2, 5).astype(np.float16)),
        "bf16": torch.from_numpy(rs.randn(7).astype(np.float32)).bfloat16(),
        "f64": torch.from_numpy(rs.randn(2, 2)),
        "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(4, dtype=torch.int32),
        "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
        "empty": torch.zeros(0, 3),
        "scalar": torch.tensor(2.5),
    }
    p = str(tmp_path / "x.safetensors")
    tw.write_safetensors(p, tensors, metadata={"format": "pt"})
    back = tw.read_safetensors(p)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k
    assert [n for n, _ in tw.iter_safetensors(p, ["u8", "f16"])] == ["f16", "u8"]
    # the JAX reader reads the port's F16 and BF16 (widened to fp32)
    jback = jw.read_safetensors(p)
    np.testing.assert_array_equal(jback["f16"], tensors["f16"].numpy())
    np.testing.assert_array_equal(jback["bf16"], tensors["bf16"].float().numpy())


def test_reads_what_the_jax_writer_writes(tmp_path):
    rs = np.random.RandomState(1)
    arrays = {"a": rs.randn(3, 4).astype(np.float32), "b.c": rs.randn(5).astype(np.float16),
              "d": np.arange(4, dtype=np.int64)}
    p = str(tmp_path / "j.safetensors")
    jw.write_safetensors(p, arrays)
    back = tw.read_safetensors(p)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
        assert back[k].numpy().dtype == v.dtype


@pytest.mark.parametrize("name,jpreset", [(n, JPRESETS[n]) for n in
                                          ("tiny", "sd15", "tiny21", "sd21", "tinyxl", "sdxl")])
@pytest.mark.parametrize("component", ["unet", "vae", "text", "text2"])
def test_key_maps_name_the_jax_maps_keys(name, jpreset, component):
    """The same diffusers keys as JAX's map, each onto the port's name of
    JAX's flax path (joined by ".", the leaf renamed as torch names it), and
    every one a parameter of the port's module: SD-2.x's linear
    projections, SDXL's depths, add_embedding and second tower with its
    text_projection (the one key whose value is transposed)."""
    preset = PRESETS[name]
    if component == "text2" and preset.text2 is None:
        assert jpreset.text2 is None
        return
    if component == "unet":
        jmap, tmap = jw.unet_key_map(jpreset.unet), tw.unet_key_map(preset.unet)
    elif component == "vae":
        jmap, tmap = jw.vae_key_map(jpreset.vae), tw.vae_key_map(preset.vae)
    else:
        jmap = jw.clip_text_key_map(getattr(jpreset, component))
        tmap = tw.clip_text_key_map(getattr(preset, component))
    assert set(tmap) == set(jmap)
    for key, (path, (fwd, _)) in jmap.items():
        assert tmap[key] == ".".join(path[:-1] + (LEAVES.get(path[-1], path[-1]),)), key
        # the values the port transposes: a raw flax parameter (no "kernel"
        # leaf) that JAX's map transposes, SDXL's text_projection
        assert (key in tw.TRANSPOSED) == (path[-1] == "text_projection" and fwd is jw.t_dense)
    if name.startswith("tiny"):
        model, _ = load_diffusion_model(name, device="cpu")
        assert set(tmap.values()) == set(dict(model.nets[component].named_parameters()))


@pytest.mark.parametrize("name", ["tiny21", "tinyxl"])
def test_family_checkpoint_round_trip(tmp_path, name):
    """A tiny21 / tinyxl tree written as a diffusers directory by the JAX
    package's writer and key maps (tinyxl: text_encoder_2/ with its
    text_projection) loads into the port bit-equal to the same tree through
    the bridge, and into the JAX package; both give the same UNet output and
    text context (the packed 78 rows on tinyxl).  The port's own writer
    writes the directory back with the same tensors."""
    import jax.numpy as jnp

    from eta_inversion_tpu.models import DiffusionModel as JModel
    from eta_inversion_tpu.models.tokenizer import load_tokenizer
    from tests.torch_port_util import tiny_pair

    jax_model, bridged = tiny_pair(preset=name)
    jpreset = JPRESETS[name]
    write_jax_checkpoint(jax_model.params, tmp_path / "jax", jpreset)
    loaded, _ = load_diffusion_model(name, device="cpu", weights_dir=str(tmp_path / "jax"))
    want_state = bridged.nets.state_dict()
    assert set(loaded.nets.state_dict()) == set(want_state)
    for k, v in loaded.nets.state_dict().items():
        assert torch.equal(v, want_state[k]), k
    jloaded = JModel(jpreset, jw.load_pretrained_params(str(tmp_path / "jax"), jpreset),
                     load_tokenizer(None, vocab_size=jpreset.text.vocab_size),
                     schedule=jpreset.schedule)
    ids = jloaded.tokenizer(["a cat sitting next to a mirror", ""])
    want_ctx = np.asarray(jloaded.encode_text(ids))
    with torch.no_grad():
        ctx = loaded.encode_text(ids)
    np.testing.assert_allclose(ctx.numpy(), want_ctx, rtol=1e-4, atol=1e-4)
    lat = np.random.RandomState(8).randn(2, 8, 8, 4).astype(np.float32)
    want = np.asarray(jloaded.apply_unet(jnp.asarray(lat), 301, jnp.asarray(want_ctx)))
    with torch.no_grad():
        got = loaded.unet(torch.from_numpy(lat).permute(0, 3, 1, 2), 301, ctx)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4, atol=1e-4)
    tw.save_pretrained(loaded.nets, str(tmp_path / "port"), loaded.preset)
    subs = ["text_encoder", "text_encoder_2", "unet", "vae"] if name == "tinyxl" else \
        ["text_encoder", "unet", "vae"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == subs
    for sub in subs:
        (f_jax,), (f_port,) = ((tmp_path / d / sub).glob("*.safetensors") for d in ("jax", "port"))
        a, b = tw.read_safetensors(str(f_jax)), tw.read_safetensors(str(f_port))
        assert set(a) == set(b), sub
        for k in a:
            assert torch.equal(a[k], b[k]), (sub, k)


def test_jax_init_loads_bit_equal_to_the_bridge(tmp_path, jax_tiny_init):
    """A JAX tiny init written as a diffusers directory loads into the port
    with every parameter equal, bit for bit, to the same tree through
    DiffusionModel.load_jax_params (models/convert.py)."""
    write_jax_checkpoint(jax_tiny_init, tmp_path, JTINY)
    loaded, _ = load_diffusion_model("tiny", device="cpu", weights_dir=str(tmp_path))
    bridged, _ = load_diffusion_model("tiny", device="cpu")
    bridged.load_jax_params(jax_tiny_init)
    want = bridged.nets.state_dict()
    got = loaded.nets.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and in bf16: every value cast once
    half, _ = load_diffusion_model("tiny", device="cpu", weights_dir=str(tmp_path),
                                   dtype="bfloat16")
    for k, v in half.nets.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, want[k].bfloat16()), k


def test_port_checkpoint_round_trip(tmp_path):
    """save_pretrained (the inverse maps) then load_diffusion_model gives
    the model's bits; without a tokenizer/ the hash tokenizer, as JAX."""
    model, _ = load_diffusion_model("tiny", device="cpu", seed=3)
    tw.save_pretrained(model.nets, str(tmp_path), model.preset)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["text_encoder", "unet", "vae"]
    back, _ = load_diffusion_model("tiny", device="cpu", weights_dir=str(tmp_path))
    for k, v in model.nets.state_dict().items():
        assert torch.equal(back.nets.state_dict()[k], v), k
    assert type(back.tokenizer).__name__ == "HashTokenizer"


def test_legacy_missing_and_extra_keys(tmp_path, jax_tiny_init):
    """Legacy VAE attention keys (query / key / value / proj_attn with
    (C, C, 1, 1) weights) load; an extra key (CLIP's position_ids) is
    ignored; a missing key raises KeyError before anything is copied."""
    write_jax_checkpoint(jax_tiny_init, tmp_path, JTINY)
    vae_file = str(tmp_path / "vae" / "model.safetensors")
    state = tw.read_safetensors(vae_file)
    legacy = {}
    for k, v in state.items():
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                         ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in k:
                k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
                if k.endswith(".weight"):
                    v = v[:, :, None, None]
        legacy[k] = v
    assert any(".query." in k for k in legacy)
    tw.write_safetensors(vae_file, legacy)
    text_file = str(tmp_path / "text_encoder" / "model.safetensors")
    text = tw.read_safetensors(text_file)
    text["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    tw.write_safetensors(text_file, text)
    loaded, _ = load_diffusion_model("tiny", device="cpu", weights_dir=str(tmp_path))
    bridged, _ = load_diffusion_model("tiny", device="cpu")
    bridged.load_jax_params(jax_tiny_init)
    for k, v in bridged.nets.state_dict().items():
        assert torch.equal(loaded.nets.state_dict()[k], v), k
    assert tw.normalize_legacy_keys({"a.attentions.0.query.weight": torch.zeros(2, 2, 1, 1)}
                                    )["a.attentions.0.to_q.weight"].shape == (2, 2)

    del text["text_model.final_layer_norm.bias"]
    tw.write_safetensors(text_file, text)
    model, _ = load_diffusion_model("tiny", device="cpu", seed=5)
    before = model.text_encoder.final_layer_norm.weight.clone()
    with pytest.raises(KeyError, match="final_layer_norm.bias"):
        tw.load_pretrained_params(model.nets, str(tmp_path), model.preset)
    assert torch.equal(model.text_encoder.final_layer_norm.weight, before)
    with pytest.raises(KeyError, match="missing"):
        tw.map_state_dict(text, tw.clip_text_key_map(model.preset.text))
    partial = tw.map_state_dict(text, tw.clip_text_key_map(model.preset.text), strict=False)
    assert "final_layer_norm.weight" in partial and "position_ids" not in str(list(partial))


def test_checkpoint_errors(tmp_path):
    model, _ = load_diffusion_model("tiny", device="cpu")
    with pytest.raises(FileNotFoundError, match="unet"):
        load_diffusion_model("tiny", device="cpu", weights_dir=str(tmp_path))
    x = torch.zeros(4, 3, 1, 1)
    assert tw._fit("w", x, torch.Size([4, 3])).shape == (4, 3)  # 1x1 conv -> linear
    assert tw._fit("w", x[:, :, 0, 0], torch.Size([4, 3, 1, 1])).shape == (4, 3, 1, 1)
    with pytest.raises(ValueError, match="module shape"):
        tw._fit("w", x, torch.Size([3, 4]))
    assert model.dtype == torch.float32
