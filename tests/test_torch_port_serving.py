"""The port's dynamic-batching edit server (eta_inversion_tpu_torch/serving.py
and serve.py) on the CPU, at `tiny` geometry, as tests/test_serving.py holds
the JAX server: concurrent requests coalesce into one bucketed edit_batch
dispatch whose results match solo edits, a short group pads to the next
bucket, incompatible scalar ptp or masactrl options (or masactrl masks given
by some requests only) split into groups, pix2pix_zero over edict's pair
results split per request, a single request
takes editor.edit, an unsupported combination answers None through the
futures, the stats count requests, batches, padded slots and dispatches by
bucket, and the CLI parses --max_batch / --max_wait_ms.  Imports no JAX.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from eta_inversion_tpu_torch import load_editor, load_inverter, serve, serving
from eta_inversion_tpu_torch.serving import BatchingEditServer, EditRequest

STEPS = 3
PTP_CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8,
           "self_replace_steps": 0.5}
# a request of a batch against its solo edit: the same arithmetic over other
# batch shapes (tests/test_serving.py's bar)
TOL = 2e-4


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    from eta_inversion_tpu_torch.models import load_diffusion_model

    return load_diffusion_model("tiny", device="cpu", seed=0)[0]


def _images(n, seed=7):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 16, 16, 3).astype(np.float32) * 2 - 1


def _editor(model, name="ptp", inverter="diffinv"):
    return load_editor(load_inverter(model, inverter, num_inference_steps=STEPS), name)


def _submit_all(server, imgs, cfgs):
    futs = [server.submit(EditRequest(imgs[i], f"a cat number {i}", f"a tiger number {i}",
                                      cfg=cfg)) for i, cfg in enumerate(cfgs)]
    return [f.result(timeout=600) for f in futs]


def test_coalesces_full_batch_and_matches_solo(model):
    editor = _editor(model)
    server = BatchingEditServer(editor, max_batch=4, max_wait_ms=2000)
    imgs = _images(4)
    try:
        results = _submit_all(server, imgs, [dict(PTP_CFG)] * 4)
    finally:
        server.shutdown()
    stats = server.stats_snapshot()
    assert stats == {"requests": 4, "batches": 1, "padded_slots": 0, "dispatch_sizes": {4: 1},
                     "queue_depth": 0, "mean_batch": 4.0}
    for i, res in enumerate(results):
        assert set(res) == {"image", "image_inv", "latent", "latent_inv"}
        assert res["image"].shape == (1, 16, 16, 3)
        solo = editor.edit(imgs[i: i + 1], f"a cat number {i}", f"a tiger number {i}",
                           cfg=dict(PTP_CFG))
        for key in ("image", "image_inv"):
            np.testing.assert_allclose(res[key].numpy(), solo[key].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"request {i}: {key}")


def test_bucket_padding(model):
    """3 requests pad to the 4-bucket by repeating the last; the results are
    sliced back to the 3 real requests."""
    server = BatchingEditServer(_editor(model), max_batch=8, max_wait_ms=1000)
    try:
        results = _submit_all(server, _images(3), [dict(PTP_CFG)] * 3)
    finally:
        server.shutdown()
    stats = server.stats_snapshot()
    assert stats["dispatch_sizes"] == {4: 1} and stats["padded_slots"] == 1
    assert len(results) == 3 and all(r["image"].shape[0] == 1 for r in results)
    assert not torch.equal(results[1]["image"], results[2]["image"])


HALF_MASK = np.tile(np.arange(16) < 8, (16, 1)).astype(np.float32)
MASKED = {"mode": "mask", "mask_s": HALF_MASK, "mask_t": HALF_MASK}


@pytest.mark.parametrize("editor,cfgs", [
    ("ptp", [dict(PTP_CFG), {**PTP_CFG, "self_replace_steps": 0.2}, dict(PTP_CFG)]),
    ("masactrl", [{"mode": "union"}, {"mode": "mask_auto"}, {"mode": "union"}]),
    ("masactrl", [dict(MASKED), {"mode": "mask"}, dict(MASKED)]),
])
def test_incompatible_cfgs_split_batches(model, editor, cfgs):
    """Scalar ptp (or masactrl) options must agree within a batch, so
    differing self_replace_steps (modes) dispatch apart: the oldest
    request's group first.  So do masactrl requests with masks and
    without."""
    server = BatchingEditServer(_editor(model, editor), max_batch=4, max_wait_ms=500)
    try:
        results = _submit_all(server, _images(3), cfgs)
    finally:
        server.shutdown()
    stats = server.stats_snapshot()
    assert stats["batches"] == 2 and stats["dispatch_sizes"] == {1: 1, 2: 1}, stats
    assert stats["mean_batch"] == 1.5
    assert all(r is not None for r in results)


def test_pair_latent_results_split_per_request(model):
    """pix2pix_zero over edict returns both chains: a coalesced request gets
    its own image rows [x_i, y_i] and its own column of the pair latent, as
    its solo edit does."""
    editor = _editor(model, "pix2pix_zero", "edict")
    cfgs = [{"caption": "a cat"}, {"caption": "a dog"}]
    server = BatchingEditServer(editor, max_batch=2, max_wait_ms=2000)
    imgs = _images(2)
    try:
        results = _submit_all(server, imgs, cfgs)
    finally:
        server.shutdown()
    assert server.stats_snapshot()["dispatch_sizes"] == {2: 1}
    for i, res in enumerate(results):
        solo = editor.edit(imgs[i: i + 1], f"a cat number {i}", f"a tiger number {i}",
                           cfg=dict(cfgs[i]))
        assert set(res) == set(solo) == {"image", "latent"}
        for key in solo:
            assert res[key].shape == solo[key].shape, key
            np.testing.assert_allclose(res[key].numpy(), solo[key].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"request {i}: {key}")


def test_single_request_uses_editor_edit_path(model, monkeypatch):
    editor = _editor(model)
    calls = []
    monkeypatch.setattr(serving, "edit_batch", lambda *a, **k: calls.append("batch"))
    server = BatchingEditServer(editor, max_batch=4, max_wait_ms=10)
    img = _images(1)
    try:
        res = server.edit(img, "a cat", "a tiger", cfg=dict(PTP_CFG), timeout=600)
    finally:
        server.shutdown()
    assert calls == [] and server.stats_snapshot()["dispatch_sizes"] == {1: 1}
    solo = editor.edit(img, "a cat", "a tiger", cfg=dict(PTP_CFG))
    np.testing.assert_allclose(res["image"].numpy(), solo["image"].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_unsupported_combo_returns_none(model, n):
    """Editor.edit's None contract flows through the futures, alone and
    batched: etainv without edit-word indices builds no eta mask."""
    server = BatchingEditServer(_editor(model, inverter="etainv"), max_batch=2,
                                max_wait_ms=1000)
    try:
        results = _submit_all(server, _images(n), [None] * n)
    finally:
        server.shutdown()
    assert results == [None] * n
    assert server.stats_snapshot()["dispatch_sizes"] == {n: 1}


def test_server_refuses_a_max_batch_no_bucket_serves():
    with pytest.raises(ValueError, match="largest bucket"):
        BatchingEditServer(object(), max_batch=16)
    with pytest.raises(ValueError, match="largest bucket"):
        BatchingEditServer(object(), max_batch=4, buckets=(1, 2))
    with pytest.raises(ValueError, match="positive"):
        BatchingEditServer(object(), buckets=(0, 1))


def test_coalescing_under_contention(monkeypatch):
    """More submitting threads than cores, with a short switch interval:
    every request gets its own result exactly once and the counters add up
    (batched dispatches through a stand-in for edit_batch)."""
    def fake_batch(editor, images, srcs, tgts, cfgs=None, inv_cfgs=None):
        return {"image": images.clone(), "latent": torch.tensor([int(s) for s in srcs])}

    class Solo:
        def edit(self, image, src, tgt, cfg=None, inv_cfg=None):
            return fake_batch(self, image, [src], [tgt])

    monkeypatch.setattr(serving, "edit_batch", fake_batch)
    server = BatchingEditServer(Solo(), max_batch=8, max_wait_ms=2)
    threads, per_thread, results = 12, 40, {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(t):
            for j in range(per_thread):
                i = t * per_thread + j
                res = server.edit(np.full((2, 2, 3), i, np.float32), str(i), "t", timeout=60)
                results[i] = (int(res["latent"][0]), float(res["image"][0, 0, 0, 0]))

        workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
        server.shutdown()
    n = threads * per_thread
    assert results == {i: (i, float(i)) for i in range(n)}
    stats = server.stats_snapshot()
    assert stats["requests"] == n
    assert sum(b * c for b, c in stats["dispatch_sizes"].items()) - stats["padded_slots"] == n
    assert sum(stats["dispatch_sizes"].values()) == stats["batches"]


def test_serve_parses_max_batch_and_max_wait():
    """--max_batch (default 8) and --max_wait_ms reach the server with the
    buckets 1 / 2 / 4 / 8; a --max_batch above 8 is refused."""
    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--steps", "2",
                             "--max_wait_ms", "20"])
    assert args.max_batch == 8
    server, _, _ = serve.build_server(args)
    try:
        assert (server.max_batch, server.max_wait_s, server.buckets) == (8, 0.02, [1, 2, 4, 8])
    finally:
        server.shutdown()
    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--max_batch", "16"])
    with pytest.raises(ValueError, match="largest bucket"):
        serve.build_server(args)


@pytest.mark.parametrize("preset", ["tiny21", "tinyv", "tinyxl"])
def test_serve_takes_the_family_presets(preset):
    """`serve --model` takes every preset (and refuses another name); a
    family preset's server coalesces two requests into one bucket-2
    dispatch (tinyxl: the packed 78-row contexts of embed_texts), each
    result its solo edit's."""
    args = serve.parse_args(["--model", preset, "--device", "cpu", "--steps", str(STEPS),
                             "--dtype", "float32", "--inverter", "diffinv",
                             "--max_wait_ms", "2000", "--max_batch", "2"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--model", "sd3"])
    server, _, _ = serve.build_server(args)
    imgs = _images(2, seed=3)
    try:
        results = _submit_all(server, imgs, [dict(PTP_CFG)] * 2)
    finally:
        server.shutdown()
    assert server.stats_snapshot()["dispatch_sizes"] == {2: 1}
    for i, res in enumerate(results):
        solo = server.editor.edit(imgs[i: i + 1], f"a cat number {i}", f"a tiger number {i}",
                                  cfg=dict(PTP_CFG))
        for key in ("image", "image_inv"):
            np.testing.assert_allclose(res[key].numpy(), solo[key].numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{preset} request {i}: {key}")
