"""The port's attention kernels and dispatch against the JAX package.

On the CPU each kernel wrapper of eta_inversion_tpu_torch computes its plain
PyTorch version; here that version is held against the JAX Pallas kernel run
in interpret mode (as tests/test_kernels.py runs it), and the dispatchers
against the JAX dispatchers (which on the CPU take their XLA path).  Inputs
come from numpy with a seed.  The CUDA kernels themselves run only on the
card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eta_inversion_tpu.ops import flash_attention as jfa
from eta_inversion_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides; the kernels accumulate in another order than the plain
# einsums, so agreement is to fp32 rounding over a few hundred terms
TOL = 1e-4


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# each kernel's plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def test_packed_plain_matches_pallas_interpret():
    b, s, h, d = 1, 512, 2, 40
    q, k, v = (_np(b, s, h * d, seed=i) for i in range(3))
    scale = d ** -0.5
    want = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      scale=scale, heads=h, block_q=512, block_k=512,
                                      interpret=True)
    got = tfa.flash_attention_packed(_t(q), _t(k), _t(v), scale, heads=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bh,s,d,bq,bk", [
    (2, 512, 40, 256, 512),    # one pass (block_k == S): K2
    (2, 1024, 40, 256, 512),   # blockwise: K3
    (1, 512, 512, 256, 256),   # blockwise at the VAE's head dim
])
def test_bhsd_plain_matches_pallas_interpret(bh, s, d, bq, bk):
    q, k, v = (_np(bh, s, d, seed=10 + i) for i in range(3))
    scale = d ** -0.5
    want = jfa.flash_attention_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    scale=scale, block_q=bq, block_k=bk, interpret=True)
    got = tfa.flash_attention_bhsd(_t(q), _t(k), _t(v), scale, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_cpu_wrappers_count_no_launch():
    tfa.reset_launch_counts()
    q = _t(_np(2, 64, 16, seed=3))
    tfa.flash_attention_bhsd(q, q, q, 0.25, block_k=64)
    tfa.flash_attention_packed(q, q, q, 0.25, heads=2)
    assert set(tfa.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# dispatchers vs the JAX dispatchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 2, 64, 64, 16),    # short self-attention: plain path
    (2, 2, 64, 77, 16),    # cross-attention (short K)
    (1, 1, 256, 256, 32),  # single head
])
def test_attention_dispatch_matches_jax(b, h, sq, sk, d):
    q, k, v = _np(b, h, sq, d, seed=1), _np(b, h, sk, d, seed=2), _np(b, h, sk, d, seed=3)
    want = jfa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,s,h,d", [(2, 64, 2, 16), (1, 256, 1, 32)])
def test_attention_packed_dispatch_matches_jax(b, s, h, d):
    q, k, v = (_np(b, s, h * d, seed=20 + i) for i in range(3))
    want = jfa.attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
    got = tfa.attention_packed(_t(q), _t(k), _t(v), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attention_probs_matches_jax():
    q, k = _np(2, 2, 64, 16, seed=4), _np(2, 2, 77, 16, seed=5)
    want = jfa.attention_probs(jnp.asarray(q), jnp.asarray(k), 0.25)
    got = tfa.attention_probs(_t(q), _t(k), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-6)


def test_chunked_dispatch_matches_jax(monkeypatch):
    """A score budget small enough that both dispatchers take the q-chunked
    plain path."""
    budget = 64 * 1024
    monkeypatch.setattr(jfa, "_XLA_SCORE_BUDGET", budget)
    monkeypatch.setattr(tfa, "_XLA_SCORE_BUDGET", budget)
    b, h, s, d = 1, 2, 192, 8
    assert tfa._chunk_size(s, b * h * s) == jfa._chunk_size(s, b * h * s) < s
    q, k, v = (_np(b, h, s, d, seed=30 + i) for i in range(3))
    want = jfa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sq,rows", [(4096, 4096), (9216, 9216), (1000, 77 * 16), (7, 3)])
def test_chunk_size_matches_jax(sq, rows):
    assert tfa._chunk_size(sq, rows) == jfa._chunk_size(sq, rows)


@pytest.mark.parametrize("packed", [False, True])
def test_kernel_route_on_cpu_takes_plain_version(packed):
    """Long self-attention, a shape the kernel gate admits on the card: on a
    CPU tensor the dispatchers take the plain path, as the JAX ones do off
    the TPU, and count no launch."""
    b, h, s, d = 1, 2, 1024, 16
    tfa.reset_launch_counts()
    if packed:
        q, k, v = (_np(b, s, h * d, seed=40 + i) for i in range(3))
        want = jfa.attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h)
        got = tfa.attention_packed(_t(q), _t(k), _t(v), h)
    else:
        q, k, v = (_np(b, h, s, d, seed=40 + i) for i in range(3))
        want = jfa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        got = tfa.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert set(tfa.LAUNCHES.values()) == {0}


def test_block_sizes_match_jax():
    """The dispatch counts a flat call as the one-pass kernel (K2) exactly
    where the JAX dispatch picks block_k == S, and as the blockwise one (K3)
    elsewhere."""
    for bh, sk, d in [(256, 1024, 40), (256, 4096, 40), (8, 4096, 40), (1, 4096, 512),
                      (4, 1536, 64), (32, 512, 80)]:
        onepass = jfa.flash_block_sizes(bh, sk, d)[1] == sk
        assert (sk <= tfa.ONEPASS_MAX_SEQ) == onepass


# ---------------------------------------------------------------------------
# jax.image.resize semantics (eta masks, LocalBlend)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,out,method", [
    ((16, 16, 77), (64, 64, 77), "cubic"),     # forward token maps at SD size
    ((5, 5), (12, 12), "cubic"),
    ((2, 64, 64), (2, 8, 8), "bilinear"),      # gt mask, antialiased downsample
    ((2, 1, 16, 16), (2, 1, 64, 64), "nearest"),
])
def test_image_resize_matches_jax(shape, out, method):
    from eta_inversion_tpu_torch.editing.ptp import image_resize

    x = np.abs(_np(*shape, seed=7))
    want = jax.image.resize(jnp.asarray(x), out, method=method)
    got = image_resize(_t(x), out, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
