"""The other model families' models on the port against the JAX package,
on the CPU: the UNets of `tiny21`, `tinyv` and `tinyxl` with and without
ptp's hooks and their stores, the packed-row checks, the CLIP options (exact
gelu, penultimate layer, pooled projection) and the packed 78-row SDXL
context, and `to_eps`, each to fp32 rounding (1e-4); nti's null embeddings
on `tinyv` (its own UNet calls through `to_eps`) within 1e-3.  Weights as in
tests/test_torch_port_families.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

SRC = "a cat sitting next to a mirror"
TGT = "a tiger sitting next to a mirror"
PTP_CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
FAMILIES = ["tiny21", "tinyv", "tinyxl"]
TOL = 1e-4  # one model call, fp32 on both sides


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(preset):
    from tests.torch_port_util import tiny_pair

    return tiny_pair(preset=preset)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _context(preset, rows, rs):
    """Seeded (rows, T, D) context; with added conditioning a packed 78th
    row whose micro-conditioning ids are pixel sizes, as encode_text writes
    them."""
    from eta_inversion_tpu_torch.models import PRESETS

    u = PRESETS[preset].unet
    ctx = rs.randn(rows, 77, u.cross_attention_dim).astype(np.float32)
    if not u.addition_embed:
        return ctx
    row = np.zeros((rows, 1, u.cross_attention_dim), np.float32)
    row[:, 0, :u.addition_pooled_dim] = rs.randn(rows, u.addition_pooled_dim)
    row[:, 0, u.addition_pooled_dim:u.addition_pooled_dim + 6] = [16, 16, 0, 0, 16, 16]
    return np.concatenate([ctx, row], axis=1)


def test_sdxl_layer_counts():
    """SDXL: 70 transformer blocks (140 attention layers); per UNet call 10
    self layers at 64x64 and 60 at 32x32, 10 and 20 heads of 64."""
    from eta_inversion_tpu_torch.models import PRESETS
    from eta_inversion_tpu_torch.models.unet import build_attn_metas

    metas = [m for ms in build_attn_metas(PRESETS["sdxl"].unet).values() for m in ms]
    selfs = [m for m in metas if not m.is_cross]
    assert len(metas) == 140
    assert sorted({(m.res, m.heads, sum(1 for x in selfs if x.res == m.res))
                   for m in selfs}) == [(32, 20, 60), (64, 10, 10)]


@pytest.mark.parametrize("hooks_kind", ["none", "ptp"])
@pytest.mark.parametrize("preset", FAMILIES)
def test_unet_matches_jax(preset, hooks_kind):
    """The raw UNet output (v for tinyv) and, under ptp's hooks (q/k
    substitution, cross replace and reweight, stores for LocalBlend), every
    stored probability tensor: per-layer head counts, 77 columns against a
    78-row packed context on tinyxl."""
    from eta_inversion_tpu import load_inverter as jinverter
    from eta_inversion_tpu.editing.controller import BatchLayout as JLayout
    from eta_inversion_tpu.editing.ptp import PtpController as JPtp
    from eta_inversion_tpu.ops.attn_ctrl import flatten_store
    from eta_inversion_tpu_torch import load_inverter
    from eta_inversion_tpu_torch.editing.controller import BatchLayout
    from eta_inversion_tpu_torch.editing.ptp import PtpController

    jax_model, port = _pair(preset)
    rs = np.random.RandomState(3)
    lat = rs.randn(4, 8, 8, 4).astype(np.float32)
    ctx = _context(preset, 4, rs)
    t, i = 700, 2
    jhooks = thooks = None
    if hooks_kind == "ptp":
        kw = dict(PTP_CFG, blend_words=(("cat",), ("tiger",)),
                  equilizer_params={"words": ("tiger",), "values": (2.0,)})
        jinv = jinverter(jax_model, "etainv", num_inference_steps=10)
        tinv = load_inverter(port, "etainv", num_inference_steps=10)
        jc, tc = JPtp(jinv, SRC, TGT, **kw), PtpController(tinv, SRC, TGT, **kw)
        jhooks = jc.hooks(i, jc.init_state(jinv, jnp.asarray(lat[:2]), None), JLayout(2, True))
        thooks = tc.hooks(i, tc.init_state(tinv, _nchw(lat[:2]), None), BatchLayout(2, True))
        assert tc.store_keys  # LocalBlend's maps

    @jax.jit
    def apply(params, lat, ctx):
        eps, var = jax_model.unet.apply({"params": params}, lat, t, ctx, jhooks,
                                        mutable=["attn_store"])
        return eps, flatten_store(var.get("attn_store", {}))

    want, jstore = apply(jax_model.params["unet"], jnp.asarray(lat), jnp.asarray(ctx))
    store = {}
    with torch.no_grad():
        got = port.unet(_nchw(lat), t, _t(ctx), hooks=thooks, store=store)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)
    assert sorted(store) == sorted(jstore)
    heads = {m.store_key: m.heads for ms in port.attn_metas.values() for m in ms}
    for k in store:
        assert store[k].shape[1] == heads[k] and store[k].shape[-1] == 77, k
        np.testing.assert_allclose(store[k].numpy(), np.asarray(jstore[k]), rtol=TOL, atol=1e-6)


def test_unet_packed_row_checks():
    """tinyxl's UNet refuses an unpacked context and the CFG shared prefix,
    as JAX's asserts do; the engine never asks for the prefix there."""
    from eta_inversion_tpu_torch import load_inverter

    _, port = _pair("tinyxl")
    lat = torch.zeros(2, 4, 8, 8)
    with torch.no_grad():
        with pytest.raises(ValueError, match="packed context"):
            port.unet(lat, 10, torch.zeros(2, 77, 32))
        with pytest.raises(ValueError, match="cfg_shared_prefix"):
            port.unet(lat[:1], 10, torch.zeros(2, 78, 32), cfg_shared_prefix=True)
    assert not load_inverter(port, "diffinv")._cfg_prefix_ok(None)
    assert load_inverter(_pair("tiny21")[1], "diffinv")._cfg_prefix_ok(None)


@pytest.mark.parametrize("preset", FAMILIES)
def test_encode_text_matches_jax(preset):
    """The engine's context: tiny21's exact-gelu tower; tinyxl's two
    penultimate towers side by side and the packed row [pooled projection;
    time ids], tower 2 reading id 0 past the first eos."""
    jax_model, port = _pair(preset)
    ids = jax_model.tokenizer([SRC, "", "a tiger, sitting!"])
    want = np.asarray(jax_model.encode_text(ids))
    with torch.no_grad():
        got = port.encode_text(ids).numpy()
    assert got.shape == want.shape == (3, 78 if preset == "tinyxl" else 77, 32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["gelu", "penultimate_projection"])
def test_clip_options_match_jax(which):
    """The two tower options on their own: tiny21's exact-erf gelu tower,
    and tinyxl's second tower returning (penultimate states, pooled
    projection) with the pooled row at the largest id."""
    jax_model, port = _pair("tiny21" if which == "gelu" else "tinyxl")
    name = "text" if which == "gelu" else "text2"
    enc = jax_model.text_encoder if which == "gelu" else jax_model.text_encoder_2
    ids = np.random.RandomState(5).randint(0, 1024, (2, 77)).astype(np.int32)
    want = enc.apply({"params": jax_model.params[name]}, jnp.asarray(ids))
    with torch.no_grad():
        got = port.nets[name](torch.from_numpy(ids).long())
    if which == "gelu":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_to_eps_matches_jax():
    """v -> eps at scalar timesteps (the final alpha at t < 0 included) and
    at per-row timesteps (ddpminv's chunks), and the identity for eps."""
    from eta_inversion_tpu import load_inverter as jinverter
    from eta_inversion_tpu_torch import load_inverter

    rs = np.random.RandomState(6)
    out, x = rs.randn(3, 8, 8, 4).astype(np.float32), rs.randn(3, 8, 8, 4).astype(np.float32)
    for preset in ("tinyv", "tiny21"):
        jinv = jinverter(_pair(preset)[0], "diffinv", num_inference_steps=10)
        tinv = load_inverter(_pair(preset)[1], "diffinv", num_inference_steps=10)
        for t in (-20, 0, 481, 981, np.array([1, 481, 981])):
            want = jinv.to_eps(jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
            tt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
            got = tinv.to_eps(_nchw(out), _nchw(x), tt)
            np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)
        if preset == "tiny21":
            assert torch.equal(tinv.to_eps(_nchw(out), _nchw(x), 481), _nchw(out))


@pytest.mark.parametrize("preset", ["tiny21", "tinyxl"])
def test_from_jax_params_covers_the_flax_tree(preset):
    """Every leaf of the JAX preset's param tree (shapes from an abstract
    init, no compile) maps onto one port parameter of the right shape:
    linear projections, depth-2 blocks, add_embedding, the second tower and
    its raw text_projection."""
    from eta_inversion_tpu.models import PRESETS as JPRESETS, init_random_params
    from eta_inversion_tpu_torch.models.convert import from_jax_params

    abstract = jax.eval_shape(lambda: init_random_params(JPRESETS[preset]))
    tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), abstract)
    sd = from_jax_params(tree)
    names = dict(_pair(preset)[1].nets.named_parameters())
    assert sorted(sd) == sorted(names)
    for k, v in sd.items():
        assert tuple(names[k].shape) == v.shape, k


def test_nti_to_eps_on_tinyv_matches_jax():
    """nti's own UNet calls on the v-prediction preset: the null embeddings
    against JAX's nti within 1e-3 (3 steps x 2 Adam updates between)."""
    from eta_inversion_tpu import load_inverter as jinverter
    from eta_inversion_tpu_torch import load_inverter

    jax_model, port = _pair("tinyv")
    image = np.random.RandomState(2).rand(1, 16, 16, 3).astype(np.float32) * 2 - 1
    steps = 3
    jres = jinverter(jax_model, "nti", num_inference_steps=steps,
                     num_inner_steps=2).invert(jnp.asarray(image), prompt=SRC)
    res = load_inverter(port, "nti", num_inference_steps=steps,
                        num_inner_steps=2).invert(image, prompt=SRC)
    np.testing.assert_allclose(res["uncond_embeddings"].numpy(),
                               np.asarray(jres["uncond_embeddings"]), rtol=1e-3, atol=1e-3)
