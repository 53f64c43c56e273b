"""The other model families' edits on the port against the JAX package, on
the CPU, beyond the family grid (tests/test_torch_port_families.py): nti +
ptp on `tinyxl`, whose packed context row (pooled embedding, time ids) must
stay fixed through the Adam updates as JAX's `opt_rows` keeps it; ddpminv
on `tinyv`, whose v-prediction is converted after the CFG combination
against per-row timesteps (nti's own conversion on `tinyv` is in
tests/test_torch_port_families_models.py); and `edit_batch` at B = 2 on
`tinyxl` against its single edits.  Weights and
draws as in the grid (tests/torch_port_util.tiny_pair, JAX draws injected).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

SRC = "a cat sitting next to a mirror"
TGT = "a tiger sitting next to a mirror"
PTP_CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}
TOL = 1e-3
PAIR_TOL = 2e-4  # a pair of a batch against its single edit: batch-size rounding


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(preset):
    from tests.torch_port_util import tiny_pair

    return tiny_pair(preset=preset)


def _image(seed=0, n=1):
    return np.random.RandomState(seed).rand(n, 16, 16, 3).astype(np.float32) * 2 - 1


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _close(got, want, what):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        g = got[key].numpy() if got[key].shape[-1] == 3 else _nhwc(got[key])
        np.testing.assert_allclose(g, np.asarray(want[key]), rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {key}")


def test_nti_ptp_on_tinyxl_matches_jax_and_keeps_the_packed_row():
    """The per-step null embeddings (S, 1, 78, D) against JAX's nti within
    1e-3, their row 77 equal to the unconditional context's at every step,
    bit for bit; then the nti + ptp edit against JAX's."""
    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu_torch import load_editor, load_inverter

    jax_model, port = _pair("tinyxl")
    image, steps = _image(), 4
    kw = {"num_inner_steps": 2}
    jinv = jinverter(jax_model, "nti", num_inference_steps=steps, **kw)
    inv = load_inverter(port, "nti", num_inference_steps=steps, **kw)
    jres = jinv.invert(jnp.asarray(image), prompt=SRC)
    res = inv.invert(image, prompt=SRC)
    ue, jue = res["uncond_embeddings"], np.asarray(jres["uncond_embeddings"])
    assert ue.shape == jue.shape == (steps, 1, 78, 32)
    np.testing.assert_allclose(ue.numpy(), jue, rtol=TOL, atol=TOL)
    u0 = res["context"][:1, 77]
    for i in range(steps):
        assert torch.equal(ue[i, :, 77], u0), i
    assert not torch.equal(ue[-1, :, :77], res["context"][:1, :77])  # the text rows moved
    want = jeditor(jinv, "ptp").edit(jnp.asarray(image), SRC, TGT, cfg=dict(PTP_CFG))
    got = load_editor(inv, "ptp").edit(image, SRC, TGT, cfg=dict(PTP_CFG))
    _close(got, want, "tinyxl nti+ptp")


def _trajectory_draws(steps, shape_nhwc):
    """ddpminv's trajectory draws, as JAX's sample_trajectory makes them
    from PRNGKey(forward_seed = 0): one (steps, ...) draw."""
    noise = jax.random.normal(jax.random.PRNGKey(0), (steps,) + shape_nhwc, jnp.float32)
    noise = torch.from_numpy(np.array(noise)).permute(0, 1, 4, 2, 3).contiguous()
    return lambda i, shape: noise


@pytest.mark.parametrize("preset", ["tinyv", "tinyxl"])
def test_ddpminv_simple_matches_jax(preset):
    """ddpminv's chunked forward calls the UNet itself, per-row timesteps:
    on tinyv its v output is converted after the CFG combination, each row
    at its own t; on tinyxl the packed context rides along."""
    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu_torch import load_editor, load_inverter

    jax_model, port = _pair(preset)
    image, steps = _image(1), 5
    want = jeditor(jinverter(jax_model, "ddpminv", num_inference_steps=steps),
                   "simple").edit(jnp.asarray(image), SRC, TGT)
    inv = load_inverter(port, "ddpminv", num_inference_steps=steps,
                        noise_fn=_trajectory_draws(steps, (1, 8, 8, 4)))
    _close(load_editor(inv, "simple").edit(image, SRC, TGT), want, f"{preset} ddpminv+simple")


@pytest.mark.parametrize("inverter,editor_name", [("etainv", "ptp"), ("diffinv", "simple")])
def test_edit_batch_on_tinyxl_matches_single_edits(inverter, editor_name):
    """embed_texts' packed 78-row contexts through a B = 2 edit_batch: each
    pair against its single edit (etainv's candidate noises the same
    draws, a pair's column for the single edit)."""
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.editing.batched import edit_batch

    _, port = _pair("tinyxl")
    steps, count = 4, 3
    srcs, tgts = [SRC, "a dog running on the beach"], [TGT, "a wolf running on the beach"]
    imgs = _image(7, 2)
    g = torch.Generator().manual_seed(0)
    draws = [torch.randn(count, 2, 4, 8, 8, generator=g) for _ in range(steps)]
    kwargs = {"noise_sample_count": count} if inverter == "etainv" else {}
    cfgs = [dict(PTP_CFG)] * 2 if editor_name == "ptp" else None
    inv_cfgs = [{"edit_word_idx": (1, 1)}] * 2 if inverter == "etainv" else None

    def editor(rows):
        return load_editor(load_inverter(port, inverter, num_inference_steps=steps,
                                         noise_fn=lambda i, shape: draws[i][:, rows], **kwargs),
                           editor_name)

    batched = edit_batch(editor(slice(0, 2)), imgs, srcs, tgts, cfgs=cfgs, inv_cfgs=inv_cfgs)
    for i in range(2):
        single = editor(slice(i, i + 1)).edit(
            imgs[i][None], srcs[i], tgts[i], cfg=cfgs and dict(cfgs[i]),
            inv_cfg=inv_cfgs and dict(inv_cfgs[i]))
        for key in ("image", "image_inv", "latent"):
            np.testing.assert_allclose(batched[key][i].numpy(), single[key][0].numpy(),
                                       rtol=PAIR_TOL, atol=PAIR_TOL,
                                       err_msg=f"{inverter}+{editor_name} pair {i}: {key}")
