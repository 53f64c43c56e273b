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


@pytest.mark.parametrize("d", [136, 200, 512])
def test_wide_head_dims_take_the_plain_version_on_cpu(d):
    """Head dims above 128, the route of the wide kernel on the card
    (csrc/flash_attention_wide.cu): on CPU tensors the flat and packed
    wrappers compute the plain version, held against the JAX dispatch, and
    count no launch; the launch path refuses a CPU tensor and a head dim
    above 512 instead of falling back."""
    b, h, s = 1, 2, 256
    q, k, v = (_np(b, h, s, d, seed=60 + i) for i in range(3))
    scale = d ** -0.5
    want = np.asarray(jfa.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))
    tfa.reset_launch_counts()
    flat = [_t(x).reshape(b * h, s, d) for x in (q, k, v)]
    got = tfa.flash_attention_bhsd(*flat, scale, block_k=128)
    np.testing.assert_allclose(got.reshape(b, h, s, d).numpy(), want, rtol=TOL, atol=TOL)
    packed = [_t(x).transpose(1, 2).reshape(b, s, h * d) for x in (q, k, v)]
    got = tfa.flash_attention_packed(*packed, scale, heads=h)
    np.testing.assert_allclose(got.reshape(b, s, h, d).transpose(1, 2).numpy(), want,
                               rtol=TOL, atol=TOL)
    assert set(tfa.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._fwd_launch(*flat, scale, None, need_lse=True)
    wide = torch.zeros(1, 16, 520)
    with pytest.raises(ValueError, match="up to 512"):
        tfa._fwd_launch(wide, wide, wide, 0.1, None, need_lse=False)


@pytest.mark.parametrize("d,tf32,tile,lib", [
    (40, False, None, tfa.NARROW_LIB),    # K1 at the UNet's 64x64 level
    (80, False, None, tfa.NARROW_LIB),    # K1 / K2 at 32x32
    (8, False, None, tfa.NARROW_LIB), (16, False, None, tfa.NARROW_LIB),
    (64, False, None, tfa.NARROW_LIB),
    (128, False, None, tfa.NARROW_LIB),   # the widest head dim of the narrow forward
    (40, False, (4, 64), tfa.TILED_LIB),  # a chosen tile: S1's bf16 rows
    (80, False, tfa.DEFAULT_TILE, tfa.TILED_LIB),  # the mma.sync kernel's default tile
    (40, True, None, tfa.NARROW_TF32),    # the TF32 mode: S1 / S3's fp32 products
    (128, True, None, tfa.NARROW_TF32),   # ... at S1's D padded to 128
    (136, False, None, tfa.WIDE_LIB), (512, False, None, tfa.WIDE_LIB),
])
def test_forward_routing(d, tf32, tile, lib):
    """Which route a bf16 forward call takes on the card: up to head dim 128
    with no tile and no TF32 to the narrow wgmma kernel
    (flash_attention_narrow.cu), a chosen tile to the mma.sync kernel
    (flash_attention.cu), fp32 products (S1 / S3) to the narrow kernel's
    TF32 mode, head dims above 128 to the wide wgmma kernel; each route's
    library is one that build_kernels builds, from a source in csrc/."""
    from eta_inversion_tpu_torch.ops.cuda_build import CSRC

    assert tfa.fwd_library(d, tf32, tile) == lib
    sources = dict(tfa._LIBS)[tfa.NARROW_LIB if lib == tfa.NARROW_TF32 else lib]
    assert all((CSRC / src).is_file() for src in sources)


@pytest.mark.parametrize("tf32,tile", [(False, (4, 64)), (True, None), (True, (4, 128))])
def test_forward_routing_refuses_a_tile_above_128(tf32, tile):
    """Above head dim 128 no kernel has a chosen tile, and none takes fp32
    products of bf16 operands (S1 / S3's TF32 mode; fp32 operands there go
    to the forward of flash_attention_bwd_tf32.cu): the route raises instead of taking another
    kernel or a plain version."""
    with pytest.raises(ValueError, match="does not take head dim 136"):
        tfa.fwd_library(136, tf32, tile)


@pytest.mark.parametrize("d,lib", [
    (40, tfa.BWD_NARROW_LIB),   # nti's gradients at the UNet's 64x64 level
    (80, tfa.BWD_NARROW_LIB),   # and at 32x32
    (8, tfa.BWD_NARROW_LIB), (64, tfa.BWD_NARROW_LIB),
    (128, tfa.BWD_NARROW_LIB),  # the widest head dim of the wgmma backward
    (136, tfa.BWD_LIB), (256, tfa.BWD_LIB),
    (512, tfa.BWD_LIB),         # the VAE mid-block attention
])
def test_backward_routing(d, lib):
    """Which library a backward call (K4a and K4b) goes to on the card: head
    dims up to 128 to the wgmma kernels (flash_attention_bwd_narrow.cu), those
    in (128, 512] to flash_attention_bwd.cu; each library is one that
    build_kernels builds, from a source in csrc/."""
    from eta_inversion_tpu_torch.ops.cuda_build import CSRC

    assert tfa.bwd_library(d) == lib
    sources = dict(tfa._LIBS)[lib]
    assert all((CSRC / src).is_file() for src in sources)


def test_backward_routing_refuses_head_dims_above_512():
    with pytest.raises(ValueError, match="up to 512"):
        tfa.bwd_library(520)


def test_tiled_entry_names_a_tile_on_the_card(monkeypatch):
    """flash_attention_bhsd_tiled with no tile hands the launch DEFAULT_TILE,
    so its bf16 calls stay on the mma.sync kernel (the microbenchmarks'
    rows) rather than taking the narrow kernel's untiled route; its fp32
    products take the narrow kernel's TF32 mode, each on its own counter."""
    seen = []

    def fake_launch(q, k, v, scale, heads, need_lse, tf32=False, tile=None, counter=None):
        seen.append((tfa.fwd_library(q.shape[-1], tf32, tile, q.dtype), counter))
        return q, None

    monkeypatch.setattr(tfa, "_fwd_launch", fake_launch)
    q = torch.zeros(2, 16, 80, device="meta", dtype=torch.bfloat16)
    for operands in ("bf16", "fp32"):
        tfa.flash_attention_bhsd_tiled(q, q, q, 0.1, operands)
    assert seen == [(tfa.TILED_LIB, "flash_attention_bhsd_tiled"),
                    (tfa.NARROW_TF32, "flash_attention_bhsd_tf32")]


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
