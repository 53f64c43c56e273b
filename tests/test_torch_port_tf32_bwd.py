"""The fp32 attention backward's TF32 routes, on the CPU: what their prep
kernel writes, why its element order makes the score accumulators the
output products' A fragments, the stripes of the route above head dim 128,
and the routes' refusal of tensors off the card.

* `bwd_tf32_prep_plain` (the prep kernel's plain version, also the wrapper's
  CPU branch) against index arithmetic written out here: K^T, Q^T and dO^T
  (BH, d, S rounded up to 8), each 8-element group along S in the order 0,
  2, 4, 6, 1, 3, 5, 7, zero past S, rounded to TF32; and D = rowsum(dO o O).
* The order at work: a score tile's accumulators, passed as the TF32 A
  fragment the way the kernels pass them, times the prep's transposed
  operand, give the true product, for K4a's dS K (over keys) and K4b's P^T dO
  and dS^T Q (over queries); in natural order they do not.
* The stripe arithmetic of csrc/flash_attention_bwd_tf32.cu in plain
  PyTorch (dQ a stripe of queries at a time, dK and dV summed over the
  stripes in order) against JAX's `_flash_bwd_impl` in Pallas interpret
  mode, and the stripe the wrapper picks for a scratch budget.
* The routes' entry points: every fp32 route is a library that build_kernels
  builds from a source in csrc/, and a tensor off the card is refused, never
  taken to the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eta_inversion_tpu.ops import flash_attention as jfa
from eta_inversion_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides, summed in another order over a few hundred terms (the
# bar of tests/test_torch_port_tf32.py)
TOL = 1e-4
FP32 = torch.float32
ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _np(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _round_tf32(x: np.ndarray) -> np.ndarray:
    """Round to 11 significant bits (TF32), half away from zero, by frexp."""
    m, e = np.frexp(x.astype(np.float64))
    m = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return np.ldexp(m, e).astype(np.float32)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the prep kernel's plain version
# ---------------------------------------------------------------------------

def _transposed(x: np.ndarray, s: int) -> np.ndarray:
    """(BH, S, d) -> (BH, d, S rounded up to 8) with position p of each
    8-group holding element ORDER[p] of it, zero past S, rounded to TF32."""
    bh, _, d = x.shape
    spad = -(-s // 8) * 8
    out = np.zeros((bh, d, spad), np.float32)
    for col in range(spad):
        src = 8 * (col // 8) + ORDER[col % 8]
        if src < s:
            out[:, :, col] = x[:, src, :]
    return _round_tf32(out)


@pytest.mark.parametrize("packed,sq,sk,d", [
    (False, 24, 16, 16),   # whole 8-element groups
    (False, 37, 29, 40),   # partial last groups, Sq != Sk: zeros past S
    (True, 20, 13, 8),     # packed, the narrowest head dim
    (True, 9, 33, 136),    # packed, a head dim of the route above 128
])
def test_bwd_prep_plain_matches_index_arithmetic(packed, sq, sk, d):
    b, h = 2, 3
    shape = (lambda s: (b, s, h * d)) if packed else (lambda s: (b * h, s, d))
    q, do, o = (_np(*shape(sq), seed=10 + i) for i in range(3))
    k = _np(*shape(sk), seed=13)
    heads = h if packed else None
    kt, qt, dot, dvec = tfa.bwd_tf32_prep_plain(_t(q), _t(k), _t(do), _t(o), heads)

    def flat(x, s):
        return x.reshape(b, s, h, d).transpose(0, 2, 1, 3).reshape(b * h, s, d) if packed else x

    for got, x, s in ((kt, k, sk), (qt, q, sq), (dot, do, sq)):
        assert got.dtype == FP32 and got.is_contiguous()
        assert tuple(got.shape) == (b * h, d, -(-s // 8) * 8)
        np.testing.assert_array_equal(got.numpy(), _transposed(flat(x, s), s))
    want_d = (flat(do, sq).astype(np.float64) * flat(o, sq)).sum(-1)
    assert dvec.dtype == FP32 and tuple(dvec.shape) == (b * h, sq)
    np.testing.assert_allclose(dvec.numpy(), want_d, rtol=1e-5, atol=1e-5)


def test_bwd_prep_wrapper_cpu_branch_returns_what_is_asked():
    """The wrapper's CPU branch is the plain version, with None for what the
    caller does not ask (K4a alone: K^T and D; K4b alone: Q^T and dO^T), and
    launches nothing."""
    q, k, do, o = (_t(_np(2, 24, 16, seed=20 + i)) for i in range(4))
    want = tfa.bwd_tf32_prep_plain(q, k, do, o)
    tfa.reset_launch_counts()
    kt, qt, dot, dvec = tfa.flash_attention_bwd_tf32_prep(q, k, do, o, qdot=False)
    assert qt is None and dot is None
    assert torch.equal(kt, want[0]) and torch.equal(dvec, want[3])
    kt, qt, dot, dvec = tfa.flash_attention_bwd_tf32_prep(q, k, do, None, kt=False)
    assert kt is None and dvec is None
    assert torch.equal(qt, want[1]) and torch.equal(dot, want[2])
    assert set(tfa.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# the element order makes the accumulators the A fragments
# ---------------------------------------------------------------------------

def _rs_product(tile: np.ndarray, bt: np.ndarray) -> np.ndarray:
    """What wgmma_rs_tf32 computes for one warp's 16 rows and one 8-wide k8
    step when its A fragment is a score accumulator chunk passed as the
    kernels pass it ({c0, c2, c1, c3}): tile (16, 8) is the chunk (rows g,
    g + 8; columns 2 t, 2 t + 1 held by thread t of a quad), bt (N, 8) the B
    operand's k8 step as the transposed tile holds it (column c = k-row c).
    Thread (g, t)'s accumulators: c0 = (g, 2t), c1 = (g, 2t + 1), c2 =
    (g + 8, 2t), c3 = (g + 8, 2t + 1); the A fragment's registers a0..a3 are
    (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    a = np.zeros((16, 8), np.float64)
    for g in range(8):
        for t in range(4):
            c = {0: tile[g, 2 * t], 1: tile[g, 2 * t + 1],
                 2: tile[g + 8, 2 * t], 3: tile[g + 8, 2 * t + 1]}
            regs = (c[0], c[2], c[1], c[3])  # as wgmma_rs_tf32 passes them
            a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = regs
    return a @ bt.T.astype(np.float64)


@pytest.mark.parametrize("product", ["dq += dS K", "dv += P^T dO", "dk += dS^T Q"])
def test_key_order_makes_the_backward_accumulators_the_a_fragment(product):
    """K4a contracts dS (queries x keys) with K over keys, K4b P^T and dS^T
    (keys x queries) with dO and Q over queries.  With the prep's transposed
    operand (B = X^T, S contracted, in the order 0, 2, 4, 6, 1, 3, 5, 7) the
    score chunks are the A fragments as they stand; with X^T in natural
    order they are not."""
    d = 24
    scores = _np(16, 8, seed=1)         # a warp's 16 rows x one 8-wide chunk
    x = _np(1, 8, d, seed=2 + len(product))  # the 8 contracted rows of K, dO or Q
    want = scores.astype(np.float64) @ x[0].astype(np.float64)
    bt = tfa.bwd_tf32_prep_plain(_t(x), _t(x), _t(x))[0][0].numpy()  # (d, 8) in the order
    exact = bt.astype(np.float64)
    # the prep rounds to TF32; compare with the rounded operand's product
    want_rounded = scores.astype(np.float64) @ _round_tf32(x[0]).astype(np.float64)
    np.testing.assert_allclose(_rs_product(scores, exact), want_rounded, rtol=1e-12, atol=1e-12)
    natural = _round_tf32(x[0]).T  # (d, 8) in natural order
    assert not np.allclose(_rs_product(scores, natural), want, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the route above head dim 128: stripes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,s,d,stripe", [
    (1, 384, 512, 128),   # three stripes at the VAE's head dim
    (2, 256, 136, 128),   # two, at the route's narrowest head dim
    (1, 256, 512, 256),   # one: the whole sequence
])
def test_striped_backward_arithmetic_matches_pallas_interpret(bh, s, d, stripe):
    """dQ a stripe of query rows at a time, dK and dV the stripes'
    contributions summed in stripe order (what flash_attention_bwd_tf32.cu
    computes, in plain fp32), against JAX's `_flash_bwd_impl` in interpret
    mode from the JAX forward's LSE: fp32 on both sides in other orders,
    TOL."""
    q, k, v, do = (_np(bh, s, d, seed=80 + i) for i in range(4))
    scale = d ** -0.5
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                 128, 128, interpret=True, need_lse=True)
    want = jfa._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                               jnp.asarray(do), scale, 128, 128, interpret=True)
    got = tfa.flash_attention_bwd_striped_plain(_t(q), _t(k), _t(v), _t(o), _t(lse), _t(do),
                                                scale, stripe)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("sq,sk,bh,arrays,stripe", [
    (4096, 4096, 1, 1, 4096),   # K4a at (1, 4096, 512): 64 MB, one stripe
    (4096, 4096, 1, 2, 4096),   # K4b: 128 MB, one stripe
    (4096, 4096, 2, 1, 4096),   # K4a at (2, 4096, 512): one stripe
    (4096, 4096, 2, 2, 2048),   # K4b: two stripes of 2048 queries
    (4225, 4225, 2, 2, 1920),   # 65 x 65 tokens: a multiple of the 128-query tile
    (300, 17, 1, 2, 300),       # short sequences: the whole of Sq
    (100_000, 100_000, 8, 2, 128),  # never below one tile
])
def test_stripe_fits_the_scratch_budget(sq, sk, bh, arrays, stripe):
    got = tfa.bwd_tf32_stripe(sq, sk, bh, arrays)
    assert got == stripe
    if got < sq:
        assert got % tfa.BWD_TF32_TILE == 0
        assert bh * got * (-(-sk // 8) * 8) * 4 * arrays <= tfa.BWD_TF32_SCRATCH_BYTES \
            or got == tfa.BWD_TF32_TILE


# ---------------------------------------------------------------------------
# the routes' entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,route,source", [
    (40, tfa.BWD_NARROW_TF32, "flash_attention_bwd_narrow.cu"),
    (80, tfa.BWD_NARROW_TF32, "flash_attention_bwd_narrow.cu"),
    (512, tfa.BWD_TF32_LIB, "flash_attention_bwd_tf32.cu"),
])
def test_fp32_backward_routes_are_built_from_csrc(d, route, source):
    """bwd_library names each fp32 route; its library is one build_kernels
    builds, from a source in csrc/ (the TF32 mode is a route of the narrow
    backward's library, as the forward's is of the narrow forward's)."""
    from eta_inversion_tpu_torch.ops.cuda_build import CSRC

    assert tfa.bwd_library(d, FP32) == route
    lib = tfa.BWD_NARROW_LIB if route == tfa.BWD_NARROW_TF32 else route
    assert dict(tfa._LIBS)[lib] == (source,)
    assert (CSRC / source).is_file()
    assert "eti_flash_attention_fp32" not in [name for name, _ in tfa._LIBS
                                              if "bwd" in name]


@pytest.mark.parametrize("packed,d", [(False, 40), (True, 80), (False, 512), (True, 136)])
def test_bwd_prep_refuses_a_tensor_off_the_card(packed, d):
    """Off the CPU branch (tensors on the `meta` device stand in for the
    card's) the prep kernel's wrapper checks its operands and refuses a
    tensor that is not on the card, and a bf16 one: nothing falls back to
    the plain version, nothing is counted."""
    b, s, h = 1, 64, 2
    shape = (b, s, h * d) if packed else (b * h, s, d)
    heads = h if packed else None
    tfa.reset_launch_counts()
    x = torch.zeros(shape, device="meta", dtype=FP32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_bwd_tf32_prep(x, x, x, x, heads)
    x = torch.zeros(shape, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_bwd_tf32_prep(x, x, x, None, heads)
    assert set(tfa.LAUNCHES.values()) == {0}
