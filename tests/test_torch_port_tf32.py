"""fp32 attention in the port, on the CPU: the routing rule by dtype, the
TF32 mode's prep kernel (its plain version), and the fp32 kernels' plain
versions against the JAX package.

* `fwd_library` / `bwd_library` by head dim and dtype: fp32 forward up to
  head dim 128 on the narrow kernel's TF32 mode, above it on the forward of
  csrc/flash_attention_bwd_tf32.cu; the fp32 backward up to 128 on the
  narrow backward's TF32 mode, above it on csrc/flash_attention_bwd_tf32.cu; bf16
  as before; a tile with TF32 products, bf16 operands with TF32 products
  above head dim 128 and any other dtype refused.
* The prep kernel's plain version (`tf32_prep_plain`) against index
  arithmetic written out here: V^T with each 8-key group in the order 0, 2,
  4, 6, 1, 3, 5, 7, zero past the keys, rounded to TF32 (checked against a
  frexp rounding), and bf16 q / k widened exactly.
* The fp32 forward with its LSE (the wrappers' CPU branch, the TF32 mode's
  plain version) against JAX's `_flash_fwd_impl` / `_packed_fwd_impl` in
  interpret mode, at the TF32 mode's head dims.
* The fp32 backward's plain version from a given LSE against JAX's
  `_flash_bwd_impl` (flat) and the packed VJP's backward, in interpret
  mode, on fp32 operands; off the CPU branch every fp32 route is a kernel's,
  which raises for a tensor off the card instead of falling back to plain.

The fp32 backward's own prep kernel and its routes' arithmetic are in
tests/test_torch_port_tf32_bwd.py; the kernels themselves run only on the
card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eta_inversion_tpu.ops import flash_attention as jfa
from eta_inversion_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides, summed in another order over a few hundred terms (the
# bar of tests/test_torch_port_ops.py and _grad.py)
TOL = 1e-4
BF16, FP32 = torch.bfloat16, torch.float32


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# routing by dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,tf32,tile,dtype,route", [
    (40, False, None, BF16, tfa.NARROW_LIB),     # K1 at the UNet's 64x64 level, bf16
    (40, False, None, FP32, tfa.NARROW_TF32),    # ... in fp32
    (80, False, None, FP32, tfa.NARROW_TF32),    # K1 / K2 at 32x32 in fp32
    (8, False, None, FP32, tfa.NARROW_TF32),
    (128, False, None, FP32, tfa.NARROW_TF32),   # the TF32 mode's widest head dim
    (80, True, None, FP32, tfa.NARROW_TF32),     # tf32 says nothing new for fp32
    (40, True, None, BF16, tfa.NARROW_TF32),     # S1 / S3: bf16 operands, fp32 products
    (136, False, None, FP32, tfa.FWD_TF32_WIDE),
    (512, False, None, FP32, tfa.FWD_TF32_WIDE),  # K3 at the VAE mid-block in fp32
    (512, False, None, BF16, tfa.WIDE_LIB),
])
def test_forward_route_by_dtype(d, tf32, tile, dtype, route):
    assert tfa.fwd_library(d, tf32, tile, dtype) == route


@pytest.mark.parametrize("d,tf32,tile,dtype", [
    (80, False, (4, 64), FP32),   # the TF32 mode's tiles are its own
    (40, True, (4, 128), BF16),   # ... with S1 / S3's bf16 operands too
    (136, True, None, BF16),      # no kernel takes fp32 products of bf16 above 128
    (512, False, (4, 64), FP32),  # nor a tile above 128
])
def test_forward_route_refuses_what_no_kernel_takes(d, tf32, tile, dtype):
    with pytest.raises(ValueError, match="does not take"):
        tfa.fwd_library(d, tf32, tile, dtype)


@pytest.mark.parametrize("d,dtype,route", [
    (40, BF16, tfa.BWD_NARROW_LIB), (512, BF16, tfa.BWD_LIB),
    (40, FP32, tfa.BWD_NARROW_TF32),   # nti's gradients at the 64x64 level in fp32
    (80, FP32, tfa.BWD_NARROW_TF32),
    (128, FP32, tfa.BWD_NARROW_TF32),  # the TF32 mode's widest head dim
    (136, FP32, tfa.BWD_TF32_LIB),
    (512, FP32, tfa.BWD_TF32_LIB),     # the VAE mid-block attention in fp32
])
def test_backward_route_by_dtype(d, dtype, route):
    assert tfa.bwd_library(d, dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_routes_refuse_another_dtype(dtype):
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfa.fwd_library(40, dtype=dtype)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tfa.bwd_library(40, dtype)
    with pytest.raises(ValueError, match="up to 512"):
        tfa.bwd_library(520, FP32)


# ---------------------------------------------------------------------------
# the prep kernel's plain version
# ---------------------------------------------------------------------------

def _round_tf32_frexp(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits (TF32), half away from zero, by frexp."""
    m, e = np.frexp(x.astype(np.float64))
    m = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(m, e).astype(np.float32)


def test_round_tf32_plain_rounds_to_nearest_ties_away():
    x = np.concatenate([_np(4096, seed=1) * 10.0 ** np.arange(-3, 5).repeat(512),
                        # ties: 1 + half a TF32 ulp, and its negative
                        [1 + 2.0 ** -11, -(1 + 2.0 ** -11), 0.0, -0.0]]).astype(np.float32)
    got = tfa.round_tf32_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _round_tf32_frexp(x))
    assert not (got.view(np.uint32) & 0x1FFF).any()  # the low 13 mantissa bits are gone
    assert got[-4] == 1 + 2.0 ** -10 and got[-3] == -(1 + 2.0 ** -10)
    special = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(tfa.round_tf32_plain(special), special)


@pytest.mark.parametrize("packed,dtype,sk", [
    (False, FP32, 24),   # whole 8-key groups
    (False, FP32, 37),   # a partial last group: zeros past Sk
    (True, FP32, 16),
    (True, BF16, 29),    # S1 / S3's operands: q and k widened
    (False, BF16, 8),
])
def test_tf32_prep_plain_matches_index_arithmetic(packed, dtype, sk):
    b, h, d, sq = 2, 3, 16, 20
    order = (0, 2, 4, 6, 1, 3, 5, 7)
    shape = (lambda s: (b, s, h * d)) if packed else (lambda s: (b * h, s, d))
    q = torch.from_numpy(_np(*shape(sq), seed=3)).to(dtype)
    k, v = (torch.from_numpy(_np(*shape(sk), seed=4 + i)).to(dtype) for i in range(2))
    qf, kf, vt = tfa.tf32_prep_plain(q, k, v, h if packed else None)

    spad = -(-sk // 8) * 8
    vn = v.float().numpy()
    if packed:  # (B, S, H*D) -> (B*H, S, D)
        vn = vn.reshape(b, sk, h, d).transpose(0, 2, 1, 3).reshape(b * h, sk, d)
    want = np.zeros((b * h, d, spad), np.float32)
    for col in range(spad):
        key = 8 * (col // 8) + order[col % 8]
        if key < sk:
            want[:, :, col] = vn[:, key, :]
    assert vt.dtype == FP32 and tuple(vt.shape) == (b * h, d, spad)
    np.testing.assert_array_equal(vt.numpy(), _round_tf32_frexp(want))
    assert qf.dtype == kf.dtype == FP32
    if dtype == FP32:
        assert qf is q and kf is k
    else:  # bf16 values are TF32 values: widening is exact
        np.testing.assert_array_equal(qf.numpy(), q.float().numpy())
        np.testing.assert_array_equal(kf.numpy(), k.float().numpy())


def test_key_order_makes_the_accumulators_the_a_fragment():
    """The arithmetic behind TF32_KEY_ORDER: thread t of a quad holds the
    score accumulators of keys 2t, 2t + 1 (elements 0, 1 of row g; 2, 3 of
    row g + 8), and the TF32 A fragment's registers {a0, a1, a2, a3} are (row
    g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4).  Passing elements {0, 2,
    1, 3} as {a0, a1, a2, a3} gives k-column c the key TF32_KEY_ORDER[c]."""
    key_of_column = {}
    for t in range(4):
        acc_keys = {0: 2 * t, 1: 2 * t + 1, 2: 2 * t, 3: 2 * t + 1}
        a_cols = {0: t, 1: t, 2: t + 4, 3: t + 4}
        for reg, elem in enumerate((0, 2, 1, 3)):
            key_of_column.setdefault(a_cols[reg], set()).add(acc_keys[elem])
    assert {c: keys.pop() for c, keys in key_of_column.items()} == dict(
        enumerate(tfa.TF32_KEY_ORDER))


# ---------------------------------------------------------------------------
# the fp32 forward with LSE and the fp32 backward, plain versions: against
# the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed,d", [(False, 8), (False, 80), (True, 40), (True, 128)])
def test_fp32_forward_with_lse_matches_pallas_interpret(packed, d):
    s, scale = 256, d ** -0.5
    if packed:
        h = 2
        q, k, v = (_np(1, s, h * d, seed=40 + i) for i in range(3))
        o, lse = jfa._packed_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                      h, 128, 128, interpret=True, need_lse=True)
        got_o, got = tfa.flash_attention_packed_fwd(_t(q), _t(k), _t(v), scale, h,
                                                    need_lse=True)
    else:
        q, k, v = (_np(2, s, d, seed=50 + i) for i in range(3))
        o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                     128, s, interpret=True, need_lse=True)
        got_o, got = tfa.flash_attention_bhsd_fwd(_t(q), _t(k), _t(v), scale, block_k=s,
                                                  need_lse=True)
    assert got_o.dtype == got.dtype == FP32 and got.shape == lse.shape
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 40), (2, 256, 80), (1, 256, 512)])
def test_fp32_backward_plain_version_flat_matches_pallas_interpret(bh, s, d):
    """The flat backward wrappers' CPU branch (K4a then K4b, the fp32
    kernels' plain version) from the JAX forward's LSE, at the UNet's and
    the VAE's head dims."""
    q, k, v, do = (_np(bh, s, d, seed=60 + i) for i in range(4))
    scale = d ** -0.5
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                 128, 128, interpret=True, need_lse=True)
    want = jfa._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                               jnp.asarray(do), scale, 128, 128, interpret=True)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do), scale)
    assert set(tfa.LAUNCHES.values()) == {0}
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == FP32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


def test_fp32_backward_plain_version_packed_matches_pallas_interpret():
    b, s, h, d = 1, 256, 2, 80
    q, k, v, do = (_np(b, s, h * d, seed=70 + i) for i in range(4))
    scale = d ** -0.5
    o, lse = jfa._packed_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, h,
                                  128, 128, interpret=True, need_lse=True)
    want = jfa._flash_packed_vjp_bwd(scale, h, 128, 128, True,
                                     (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse),
                                     jnp.asarray(do))
    got = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do), scale, heads=h)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("packed,d", [(False, 40), (True, 40), (False, 512)])
def test_fp32_backward_takes_a_kernel_route_and_never_falls_back(packed, d):
    """Off the CPU branch (tensors on the `meta` device stand in for the
    card's) the fp32 backward goes to its TF32 routes' checks (the prep
    kernel's first), as bf16 goes to its kernels': both refuse a tensor
    that is not on the card rather than fall back to plain, and nothing is
    counted."""
    b, s, h = 1, 64, 2
    shape = (b, s, h * d) if packed else (b * h, s, d)
    heads = h if packed else None
    lse = torch.zeros((b, h, s) if packed else (b * h, 1, s), device="meta")
    tfa.reset_launch_counts()
    for dtype in (FP32, BF16):
        x = torch.zeros(shape, device="meta", dtype=dtype)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention_bwd_dq(x, x, x, x, lse, x, 0.1, heads=heads)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention_bwd_dkv(x, x, x, lse, x, lse.reshape(b * h, s), 0.1,
                                        heads=heads)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention_bwd(x, x, x, x, lse, x, 0.1, heads=heads)
    assert set(tfa.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("d", [40, 512])
def test_fp32_forward_launch_path_refuses_a_tensor_off_the_card(d):
    """The forward's TF32 route (d = 40) and its route above head dim 128
    (d = 512, flash_attention_bwd_tf32.cu) take CUDA tensors only: a CPU tensor handed to the launch path
    raises, and nothing is counted."""
    q = _t(_np(2, 64, d, seed=1))
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa._fwd_launch(q, q, q, 0.1, None, need_lse=True, counter="flash_attention_packed")
    if d <= tfa.NARROW_MAX_HEAD_DIM:  # the prep kernel, off the CPU branch
        m = q.to("meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention_tf32_prep(m, m, m)
    assert set(tfa.LAUNCHES.values()) == {0}
