"""The port's pair-batched editing and its CFG shared prefix against the JAX
package, at `tiny` geometry on the CPU.

`edit_batch` for etainv + ptp at B = 2 is held against JAX's `edit_batch`
with the same weights (tests/torch_port_util.py) and the JAX draws injected;
each pair of a batch against the port's own single `edit` (simple, ptp
replace, ptp refine with per-pair LocalBlend words, nti + simple), as
tests/test_batched.py holds the JAX package.  The UNet with
`cfg_shared_prefix` is held against itself without it and against the JAX
UNet with the flag, and the engine's `_cfg_prefix_ok` against JAX's.  JAX
runs once, at 2 steps; the rest is port against port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

STEPS = 2
SRCS = ["a cat sitting next to a mirror", "a dog running on grass"]
TGTS = ["a tiger sitting next to a mirror", "a wolf running on grass"]
PTP_CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8,
           "self_replace_steps": 0.5}
# the JAX oracle's bar (tests/test_torch_port_slice.py): fp32 on both sides,
# an argmin over candidate noises and a thresholded mask between input and
# output
TOL = 1e-3
# a pair of a batch against its single edit (tests/test_batched.py's bar):
# the same arithmetic but sums over other batch shapes
PAIR_TOL = 2e-4
# fp32 UNet with and without the shared prefix: the same products on B or
# 2B rows, which may sum in another order
PREFIX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    from tests.torch_port_util import tiny_pair

    return tiny_pair()


def _images():
    rs = np.random.RandomState(7)
    return rs.rand(2, 16, 16, 3).astype(np.float32) * 2 - 1


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _jax_draws(steps, count, shape_nhwc):
    """The JAX engine's candidate noises: PRNGKey(seed + 1), one split per
    backward step; returned NCHW per step."""
    rng = jax.random.PRNGKey(1)
    out = []
    for _ in range(steps):
        rng, k = jax.random.split(rng)
        n = np.array(jax.random.normal(k, (count,) + shape_nhwc, jnp.float32))
        out.append(torch.from_numpy(n).permute(0, 1, 4, 2, 3).contiguous())
    return out


def test_edit_batch_etainv_ptp_matches_jax(pair):
    """etainv + ptp at B = 2 (per-pair cfgs and word indices) through the
    port's edit_batch against JAX's, the candidate noises of both pairs
    drawn by JAX as one (count, 2, h, w, c) draw a step."""
    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu.editing.batched import edit_batch as jedit_batch
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.editing.batched import edit_batch

    jax_model, port = pair
    count, eta = 4, ((0.6, 0.0), (1.0, 0.7))
    cfgs = [{**PTP_CFG, "blend_words": (("cat",), ("tiger",))}, dict(PTP_CFG)]
    inv_cfgs = [{"edit_word_idx": (1, 1)}, {"edit_word_idx": (1, 1)}]
    imgs = _images()
    jinv = jinverter(jax_model, "etainv", num_inference_steps=STEPS, eta=eta,
                     noise_sample_count=count)
    want = jedit_batch(jeditor(jinv, "ptp"), jnp.asarray(imgs), SRCS, TGTS, cfgs=cfgs,
                       inv_cfgs=inv_cfgs)
    draws = _jax_draws(STEPS, count, (2, 8, 8, 4))
    inv = load_inverter(port, "etainv", num_inference_steps=STEPS, eta=eta,
                        noise_sample_count=count, noise_fn=lambda i, shape: draws[i])
    got = edit_batch(load_editor(inv, "ptp"), imgs, SRCS, TGTS, cfgs=cfgs, inv_cfgs=inv_cfgs)
    assert set(got) == {"image", "image_inv", "latent", "latent_inv"}
    for key in ("latent_inv", "latent"):
        assert got[key].shape == (2, 4, 8, 8)
        np.testing.assert_allclose(_nhwc(got[key]), np.asarray(want[key]), rtol=TOL, atol=TOL)
    for key in ("image_inv", "image"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("inverter,editor_name,cfg", [
    ("diffinv", "simple", None),
    ("diffinv", "ptp", PTP_CFG),
    ("diffinv", "ptp", {**PTP_CFG, "is_replace_controller": False,
                        "blend_words": (("cat",), ("tiger",))}),
    ("nti", "simple", None),
])
def test_edit_batch_matches_single_edits(pair, inverter, editor_name, cfg):
    """Each pair of a B = 2 batch against the same edit alone (ptp refine
    with per-pair LocalBlend words; nti's null embeddings optimized per
    sample and tiled onto each pair's source and target rows)."""
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.editing.batched import edit_batch

    _, port = pair
    kwargs = {"num_inner_steps": 2} if inverter == "nti" else {}
    cfgs = [cfg, None if cfg is None else
            ({**cfg, "blend_words": (("dog",), ("wolf",))} if "blend_words" in cfg else cfg)]
    imgs = _images()
    editor = load_editor(load_inverter(port, inverter, num_inference_steps=4, **kwargs),
                         editor_name)
    batched = edit_batch(editor, imgs, SRCS, TGTS, cfgs=cfgs if cfg else None)
    for i in range(2):
        single = load_editor(load_inverter(port, inverter, num_inference_steps=4, **kwargs),
                             editor_name).edit(imgs[i][None], SRCS[i], TGTS[i], cfg=cfgs[i])
        for key in ("image", "image_inv", "latent"):
            np.testing.assert_allclose(batched[key][i].numpy(), single[key][0].numpy(),
                                       rtol=PAIR_TOL, atol=PAIR_TOL,
                                       err_msg=f"{inverter}+{editor_name} pair {i}: {key}")


def test_edit_batch_refuses_unported_editors_and_mixed_scalar_cfgs(pair):
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.editing.batched import edit_batch
    from eta_inversion_tpu_torch.editing.editor import Editor

    _, port = pair

    class Masactrl(Editor):
        inverter = load_inverter(port, "diffinv", num_inference_steps=2)

    with pytest.raises(NotImplementedError, match="M8"):
        edit_batch(Masactrl(), _images(), SRCS, TGTS)
    ptp = load_editor(load_inverter(port, "diffinv", num_inference_steps=2), "ptp")
    with pytest.raises(ValueError, match="cross_replace_steps"):
        edit_batch(ptp, _images(), SRCS, TGTS,
                   cfgs=[PTP_CFG, {**PTP_CFG, "cross_replace_steps": 0.4}])
    etainv = load_editor(load_inverter(port, "etainv", num_inference_steps=2), "ptp")
    assert edit_batch(etainv, _images(), SRCS, TGTS) is None  # no edit-word indices


def _unet_inputs(b, seed=0):
    rs = np.random.RandomState(seed)
    lat = rs.randn(b, 8, 8, 4).astype(np.float32)  # NHWC, JAX's layout
    ctx = rs.randn(2 * b, 77, 32).astype(np.float32) * 0.5
    return lat, ctx


@pytest.mark.parametrize("b", [1, 2])
def test_unet_shared_prefix_matches_full_rows_and_jax(pair, b):
    """UNet2DCondition with cfg_shared_prefix (B latent rows, 2B context
    rows) against the same call on the tiled latent, and against JAX's UNet
    with the flag."""
    jax_model, port = pair
    lat, ctx = _unet_inputs(b, seed=b)
    assert ctx.shape[-1] == port.preset.unet.cross_attention_dim
    t = 501
    tl, tc = torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(ctx)
    with torch.no_grad():
        got = port.unet(tl, t, tc, cfg_shared_prefix=True)
        full = port.unet(torch.cat([tl, tl]), t, tc)
    assert got.shape == (2 * b, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=PREFIX_TOL, atol=PREFIX_TOL)
    want = jax_model.unet.apply({"params": jax_model.params["unet"]}, jnp.asarray(lat), t,
                                jnp.asarray(ctx), None, cfg_shared_prefix=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_cfg_prefix_ok_agrees_with_jax(pair):
    """The engine takes the shared prefix exactly where JAX's does: no hooks,
    the base hooks (off by default), ptp with do_edit on and off, and ptp's
    replacement threshold below, at and above the first self-attention
    layer's res^2 (8^2 at tiny geometry)."""
    from eta_inversion_tpu import load_inverter as jinverter
    from eta_inversion_tpu.editing.controller import BatchLayout as JLayout
    from eta_inversion_tpu.editing.ptp import PtpHooks as JHooks
    from eta_inversion_tpu.ops.attn_ctrl import AttnHooks as JBase
    from eta_inversion_tpu_torch import load_inverter
    from eta_inversion_tpu_torch.editing.controller import BatchLayout
    from eta_inversion_tpu_torch.editing.ptp import PtpHooks
    from eta_inversion_tpu_torch.ops.attn_ctrl import AttnHooks

    jax_model, port = pair
    jinv, inv = jinverter(jax_model, "diffinv"), load_inverter(port, "diffinv")
    first = min((m for p in port.attn_metas.values() for m in p if not m.is_cross),
                key=lambda m: m.idx)
    assert first.res ** 2 == 64
    cases = [(None, None), (JBase(), AttnHooks())]
    for do_edit in (True, False):
        for thres in (63, 64, 32 * 32):
            kw = dict(mode="replace", alpha_i=None, self_gate=True, attn_replace_thres=thres,
                      do_edit=do_edit)
            cases.append((JHooks(layout=JLayout(4, True), **kw),
                          PtpHooks(layout=BatchLayout(4, True), **kw)))
    got = [inv._cfg_prefix_ok(t) for _, t in cases]
    assert got == [jinv._cfg_prefix_ok(j) for j, _ in cases]
    assert got == [True, False, True, False, False, True, True, True]


def test_engine_takes_the_shared_prefix_where_it_is_exact(pair, monkeypatch):
    """predict_noise at CFG runs the UNet on the B latent rows with the
    prefix flag when the hooks allow it (ptp without edits), on the tiled 2B
    rows otherwise (the base hooks), and gives the same eps either way."""
    from eta_inversion_tpu_torch import load_inverter
    from eta_inversion_tpu_torch.editing.controller import BatchLayout
    from eta_inversion_tpu_torch.editing.ptp import PtpHooks
    from eta_inversion_tpu_torch.ops.attn_ctrl import AttnHooks

    _, port = pair
    inv = load_inverter(port, "diffinv")
    lat, ctx = _unet_inputs(2, seed=5)
    tl, tc = torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(ctx)
    calls = []
    unet = port.nets["unet"]
    forward = unet.forward

    def spy(sample, *args, cfg_shared_prefix=False, **kwargs):
        calls.append((sample.shape[0], cfg_shared_prefix))
        return forward(sample, *args, cfg_shared_prefix=cfg_shared_prefix, **kwargs)

    monkeypatch.setattr(unet, "forward", spy)
    hooks = PtpHooks(layout=BatchLayout(4, True), mode="replace", alpha_i=None,
                     self_gate=False, do_edit=False)
    with torch.no_grad():
        eps_prefix, _ = inv.predict_noise(tl, 301, tc, 7.5, hooks=hooks)
        eps_full, _ = inv.predict_noise(tl, 301, tc, 7.5, hooks=AttnHooks())  # not safe
    assert calls == [(2, True), (4, False)]
    np.testing.assert_allclose(eps_prefix.numpy(), eps_full.numpy(), rtol=1e-4, atol=1e-4)


def test_embed_texts_is_one_encoder_call_of_create_context_rows(pair):
    from eta_inversion_tpu_torch import load_inverter

    _, port = pair
    inv = load_inverter(port, "diffinv")
    emb = inv.embed_texts(["", SRCS[0], SRCS[1]])
    assert emb.shape == (3, 77, 32)
    for i, p in enumerate(SRCS):
        np.testing.assert_allclose(emb[[0, i + 1]].numpy(), inv.create_context(p).numpy(),
                                   rtol=1e-5, atol=1e-6)
