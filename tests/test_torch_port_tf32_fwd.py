"""The fp32 attention forward above head dim 128 (K3 at the VAE mid-block's
d = 512 in an fp32 model) and S4's all-heads block, on the CPU: the
arithmetic of their routes, the stripe the forward's scratch holds, the
sources they are built from, and their refusal of tensors off the card.

* The stripe arithmetic of the forward in csrc/flash_attention_bwd_tf32.cu
  in plain PyTorch (`flash_attention_fwd_striped_plain`: a stripe of query
  rows at a time, the scores in the log2 domain with each 8-key group in the
  order 0, 2, 4, 6, 1, 3, 5, 7, each row's (max, sum of exp2) per 128-key
  tile merged into L, P = exp2(S - L), P V^T with V^T in the same order)
  against JAX's `_flash_fwd_impl` with block_k < S (K3's `_flash_kernel`)
  in Pallas interpret mode, O and the LSE.
* The stripe the wrapper picks for the scratch budget.
* The routes' libraries: fp32 above head dim 128 on the forward of
  flash_attention_bwd_tf32.cu, S4 on flash_attention_narrow.cu, both built
  from csrc/ by build_kernels; the sources they replaced are gone.
* Off the CPU branch (tensors on the `meta` device stand in for the card's)
  each route checks its operands and raises, never taking the plain version.

The kernels themselves run only on the card: tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eta_inversion_tpu.ops import flash_attention as jfa
from eta_inversion_tpu_torch.ops import flash_attention as tfa

# fp32 on both sides, the same exact softmax summed in another order over a
# few hundred keys (the bar of tests/test_torch_port_tf32.py)
TOL = 1e-4
FP32 = torch.float32


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
# the forward's stripes against K3 in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,sq,sk,d,stripe", [
    (1, 256, 256, 160, 128),   # two stripes at the route's narrow end
    (2, 512, 512, 512, 128),   # four, at the VAE's head dim
    (2, 512, 512, 512, 512),   # one: the whole sequence
    (1, 384, 200, 136, 256),   # Sk not a multiple of 8 or of the tile: -inf past Sk
])
def test_striped_forward_arithmetic_matches_pallas_interpret(bh, sq, sk, d, stripe):
    """O and the natural-log LSE of the forward's stripe arithmetic (plain
    fp32, no TF32 rounding) against JAX's K3 (`_flash_fwd_impl`, block_k <
    S, need_lse) in interpret mode: fp32 on both sides in other orders,
    TOL."""
    q = _np(bh, sq, d, seed=90)
    k, v = (_np(bh, sk, d, seed=91 + i) for i in range(2))
    scale = d ** -0.5
    block_k = 128 if sk % 128 == 0 else 8  # K3 streams the keys in blocks of block_k
    o, lse = jfa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 128,
                                 block_k, interpret=True, need_lse=True)
    got_o, got_lse = tfa.flash_attention_fwd_striped_plain(_t(q), _t(k), _t(v), scale, stripe)
    assert got_o.dtype == FP32 and tuple(got_o.shape) == (bh, sq, d)
    assert tuple(got_lse.shape) == (bh, 1, sq) == np.asarray(lse).shape
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=TOL, atol=TOL)


def test_striped_forward_key_order_is_the_arithmetic():
    """The permuted key order changes only the order of the sums: the
    striped plain forward equals the wrappers' plain forward (natural
    order, torch.softmax) to fp32 rounding, and a V^T in natural order
    against P in the permuted order would not."""
    q, k, v = (_t(_np(1, 64, 136, seed=70 + i)) for i in range(3))
    scale = 136 ** -0.5
    got, lse = tfa.flash_attention_fwd_striped_plain(q, k, v, scale, 64)
    want, lse_want = tfa._fwd_plain(q, k, v, scale, None, True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_want.numpy(), rtol=1e-5, atol=1e-5)
    order = torch.arange(64) // 8 * 8 + torch.tensor(tfa.TF32_KEY_ORDER).repeat(8)
    p = torch.softmax(q[0] @ k[0].T * scale, -1)
    assert not torch.allclose(p[:, order] @ v[0], want[0], rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("sq,sk,bh,stripe", [
    (4096, 4096, 1, 4096),      # (1, 4096, 512): 64 MB of scores, one stripe
    (4096, 4096, 2, 4096),      # (2, 4096, 512): 128 MB, one stripe
    (4096, 4096, 4, 2048),      # four rows: two stripes of 2048 queries
    (4225, 4225, 4, 1920),      # 65 x 65 tokens: a multiple of the 128-query tile
    (300, 17, 1, 300),          # short sequences: the whole of Sq
    (100_000, 100_000, 8, 128),  # never below one tile
])
def test_forward_stripe_fits_the_scratch_budget(sq, sk, bh, stripe):
    got = tfa.fwd_tf32_stripe(sq, sk, bh)
    assert got == stripe
    if got < sq:
        assert got % tfa.BWD_TF32_TILE == 0
        assert bh * got * (-(-sk // 8) * 8) * 4 <= tfa.BWD_TF32_SCRATCH_BYTES \
            or got == tfa.BWD_TF32_TILE


# ---------------------------------------------------------------------------
# the routes' sources and entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [136, 160, 256, 512])
def test_fp32_wide_forward_route_is_built_from_csrc(d):
    """fp32 above head dim 128 routes to the forward of the TF32 library
    above 128 (a route of BWD_TF32_LIB's library, as NARROW_TF32 is of
    NARROW_LIB's), built from csrc/flash_attention_bwd_tf32.cu; the mma.sync
    sources it and S4 ran on before are gone from the build and from
    csrc/."""
    from eta_inversion_tpu_torch.ops.cuda_build import CSRC

    assert tfa.fwd_library(d, dtype=FP32) == tfa.FWD_TF32_WIDE
    assert tfa.FWD_TF32_WIDE.startswith(tfa.BWD_TF32_LIB + " ")
    assert dict(tfa._LIBS)[tfa.BWD_TF32_LIB] == ("flash_attention_bwd_tf32.cu",)
    assert dict(tfa._LIBS)[tfa.NARROW_LIB] == ("flash_attention_narrow.cu",)
    for gone in ("flash_attention_fp32.cu", "flash_multihead.cu"):
        assert not (CSRC / gone).exists()
        assert all(gone not in sources for _, sources in tfa._LIBS)
    assert all((CSRC / s).is_file() for _, sources in tfa._LIBS for s in sources)


@pytest.mark.parametrize("packed,d", [(False, 512), (False, 136), (True, 160)])
def test_fp32_wide_forward_refuses_a_tensor_off_the_card(packed, d):
    """The route's wrapper takes CUDA fp32 tensors only: meta tensors (not
    on the CPU branch, not on the card) raise before any launch, with or
    without the LSE, and nothing is counted."""
    b, s, h = 1, 64, 2
    shape = (b, s, h * d) if packed else (b * h, s, d)
    x = torch.zeros(shape, device="meta", dtype=FP32)
    tfa.reset_launch_counts()
    for need_lse in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            if packed:
                tfa.flash_attention_packed_fwd(x, x, x, 0.1, h, need_lse=need_lse)
            else:
                tfa.flash_attention_bhsd_fwd(x, x, x, 0.1, block_k=16, need_lse=need_lse)
    assert set(tfa.LAUNCHES.values()) == {0}


def test_multihead_refuses_another_tile_and_a_tensor_off_the_card():
    """S4's all-heads block has one tile, MULTIHEAD_TILE (128 query rows a
    block, 128 keys a staged tile): off the CPU branch another tile raises,
    and its own tile on meta tensors reaches the operand checks and raises
    there; nothing is counted.  On the CPU any tile takes the plain
    version."""
    x = torch.zeros(1, 256, 8 * 40, device="meta", dtype=torch.bfloat16)
    tfa.reset_launch_counts()
    for operands in ("bf16", "fp32"):
        with pytest.raises(ValueError, match="does not take tile"):
            tfa.flash_attention_multihead(x, x, x, 0.1, 8, operands, (2, 64))
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention_multihead(x, x, x, 0.1, 8, operands, tfa.MULTIHEAD_TILE)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tfa.flash_attention_multihead(x, x, x, 0.1, 8, operands)
    assert set(tfa.LAUNCHES.values()) == {0}
    p = _t(_np(1, 64, 8 * 40, seed=5))
    assert torch.equal(tfa.flash_attention_multihead(p, p, p, 0.1, 8, "fp32", (2, 96)),
                       tfa.flash_attention_packed_plain(p, p, p, 0.1, 8))
