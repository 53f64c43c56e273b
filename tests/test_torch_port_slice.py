"""The port's main path end to end against the JAX package at `tiny` geometry.

The etainv + ptp edit served through the port's BatchingEditServer is held
against the JAX engine's `editor.edit` with the same weights and the JAX
draws injected (torch's generator cannot reproduce jax.random), with the
configuration of tests/test_torch_e2e_oracle.py.  Tolerance 1e-3: the bar of
that oracle -- fp32 on both sides, but 2 x 10 UNet calls, a thresholded eta
mask and an argmin over candidate noises lie between input and output.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

STEPS = 10
COUNT = 4
SRC = "a cat sitting next to a mirror"
TGT = "a tiger sitting next to a mirror"
CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8,
       "self_replace_steps": 0.4,
       "blend_words": (("cat",), ("tiger",)),
       "equilizer_params": {"words": ("tiger",), "values": (2.0,)}}
INV_CFG = {"edit_word_idx": (1, 1)}
ETA = ((0.6, 0.0), (1.0, 0.7))
TOL = 1e-3
ROOT = Path(__file__).resolve().parent.parent


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


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def test_served_etainv_ptp_matches_jax(pair, test_image):
    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.serving import BatchingEditServer, EditRequest

    jax_model, port = pair
    jinv = jinverter(jax_model, "etainv", num_inference_steps=STEPS, eta=ETA,
                     noise_sample_count=COUNT)
    want = jeditor(jinv, "ptp").edit(jnp.asarray(test_image), SRC, TGT, cfg=dict(CFG),
                                     inv_cfg=dict(INV_CFG))

    draws = _jax_draws(STEPS, COUNT, (1, 8, 8, 4))

    def noise_fn(i, shape):
        assert tuple(shape) == tuple(draws[i].shape)
        return draws[i]

    inv = load_inverter(port, "etainv", num_inference_steps=STEPS, eta=ETA,
                        noise_sample_count=COUNT, noise_fn=noise_fn)
    server = BatchingEditServer(load_editor(inv, "ptp"))
    try:
        got = server.submit(EditRequest(test_image[0], SRC, TGT, cfg=dict(CFG),
                                        inv_cfg=dict(INV_CFG))).result(timeout=300)
    finally:
        server.shutdown()
    assert set(got) == {"image", "image_inv", "latent", "latent_inv"}
    for key in ("latent_inv", "latent"):
        np.testing.assert_allclose(_nhwc(got[key]), np.asarray(want[key]), rtol=TOL, atol=TOL)
    for key in ("image_inv", "image"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=TOL, atol=TOL)


def test_forward_token_maps_and_mask_match_jax(pair, test_image):
    """The forward store -> per-step normalized token maps -> fwd_mean eta
    mask, in isolation."""
    from eta_inversion_tpu import load_inverter as jinverter
    from eta_inversion_tpu_torch import load_inverter

    jax_model, port = pair
    jinv = jinverter(jax_model, "etainv", num_inference_steps=STEPS, noise_sample_count=2)
    jres = jinv.invert(jnp.asarray(test_image), prompt=SRC, inv_cfg=dict(INV_CFG))
    inv = load_inverter(port, "etainv", num_inference_steps=STEPS, noise_sample_count=2)
    res = inv.invert(test_image, prompt=SRC, inv_cfg=dict(INV_CFG))
    np.testing.assert_allclose(res["fwd_token_maps"].numpy(),
                               np.asarray(jres["fwd_token_maps"]), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_nhwc(res["zT_inv"]), np.asarray(jres["zT_inv"]),
                               rtol=2e-4, atol=2e-4)
    want_mask = np.asarray(jinv._static_mask(jres, "mask_eta"))
    got_mask = inv._static_mask(res, "mask_eta")
    np.testing.assert_array_equal(_nhwc(got_mask), want_mask)


def test_diffinv_simple_matches_jax(pair, test_image):
    from eta_inversion_tpu import load_editor as jeditor, load_inverter as jinverter
    from eta_inversion_tpu_torch import load_editor, load_inverter

    jax_model, port = pair
    want = jeditor(jinverter(jax_model, "diffinv", num_inference_steps=STEPS),
                   "simple").edit(jnp.asarray(test_image), SRC, TGT)
    got = load_editor(load_inverter(port, "diffinv", num_inference_steps=STEPS),
                      "simple").edit(test_image, SRC, TGT)
    np.testing.assert_allclose(_nhwc(got["latent"]), np.asarray(want["latent"]),
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               rtol=5e-4, atol=5e-4)


def test_server_refuses_unported_buckets_and_registry_keys(pair):
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.serving import BatchingEditServer

    _, port = pair
    with pytest.raises(ValueError, match="largest bucket"):  # buckets above 1 are served
        BatchingEditServer(object(), max_batch=16, buckets=(1, 2, 4, 8))
    with pytest.raises(ValueError, match="not ported"):
        load_inverter(port, "edict")
    with pytest.raises(ValueError, match="not ported"):
        load_editor(load_inverter(port, "etainv"), "masactrl")
    with pytest.raises(NotImplementedError):
        load_inverter(port, "diffinv", scheduler="dpm")
    with pytest.raises(ValueError, match="source rows"):
        load_editor(load_inverter(port, "etainv"), "ptp", no_source_backward=True)


def test_server_runs_edits_in_arrival_order():
    """At max_batch 1 the server is a FIFO over editor.edit: one edit per
    request, oldest first, and an editor's exception reaches only its own
    caller."""
    from eta_inversion_tpu_torch.serving import BatchingEditServer, EditRequest

    class Recorder:
        def __init__(self):
            self.seen = []

        def edit(self, image, src, tgt, cfg=None, inv_cfg=None):
            if src == "bad":
                raise RuntimeError("boom")
            self.seen.append(src)
            return {"image": image}

    editor = Recorder()
    server = BatchingEditServer(editor, max_batch=1)
    img = np.zeros((4, 4, 3), np.float32)
    try:
        futs = [server.submit(EditRequest(img, src, "t")) for src in ("a", "bad", "b", "c")]
        assert futs[0].result(timeout=10)["image"].shape == (1, 4, 4, 3)
        with pytest.raises(RuntimeError, match="boom"):
            futs[1].result(timeout=10)
        for f in futs[2:]:
            f.result(timeout=10)
    finally:
        server.shutdown()
    assert editor.seen == ["a", "b", "c"]
    assert server.stats_snapshot() == {"requests": 4, "batches": 4, "padded_slots": 0,
                                       "dispatch_sizes": {1: 4}, "queue_depth": 0,
                                       "mean_batch": 1.0}


def test_serve_refuses_a_dtype_the_card_kernels_do_not_take(monkeypatch):
    """float32 on the card is served (the attention kernels route it: the
    TF32 modes and flash_attention_bwd_tf32.cu); a dtype that neither the model
    nor the kernels take, float16, is refused."""
    from eta_inversion_tpu_torch import models, serve

    seen = []

    def fake_load(model, dtype, seed, device):
        seen.append((dtype, device))
        raise RuntimeError("stop after the dtype check")

    args = serve.parse_args(["--model", "tiny", "--device", "cuda", "--dtype", "float16"])
    with pytest.raises(ValueError, match="float16"):
        serve.build_server(args)
    monkeypatch.setattr(models, "load_diffusion_model", fake_load)
    args = serve.parse_args(["--model", "tiny", "--device", "cuda", "--dtype", "float32"])
    with pytest.raises(RuntimeError, match="stop after"):
        serve.build_server(args)
    assert seen == [("float32", "cuda")]


def test_port_imports_no_jax():
    """The port on its own: a tiny served etainv+ptp edit and a tiny nti+ptp
    edit (gradients through the UNet) on the CPU in a fresh process, after
    which neither jax, flax nor eta_inversion_tpu has been imported."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from eta_inversion_tpu_torch import load_editor, load_inverter
        from eta_inversion_tpu_torch.models import load_diffusion_model
        from eta_inversion_tpu_torch.serving import BatchingEditServer
        from eta_inversion_tpu_torch import serve
        model, (pre, post) = load_diffusion_model("tiny", device="cpu")
        inv = load_inverter(model, "etainv", num_inference_steps=3, noise_sample_count=2)
        server = BatchingEditServer(load_editor(inv, "ptp"))
        img = (np.random.RandomState(0).rand(16, 16, 3) * 255).astype(np.uint8)
        res = server.edit(pre(img), "a cat", "a tiger", inv_cfg={"edit_word_idx": (1, 1)})
        server.shutdown()
        assert post(res["image"]).shape == (16, 16, 3)
        nti = load_inverter(model, "nti", num_inference_steps=3, num_inner_steps=1)
        res = load_editor(nti, "ptp").edit(pre(img), "a cat", "a tiger")
        assert post(res["image"]).shape == (16, 16, 3) and nti.last_inner_steps == [1, 1, 1]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "eta_inversion_tpu"))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
