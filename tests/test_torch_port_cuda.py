"""The port's CUDA kernels against their plain versions, on the card: the
forward kernels (K1-K3: the narrow wgmma kernel up to head dim 128, the wide
one above) with their LSE, the narrow kernel's TF32 mode (fp32 operands) and
its prep kernel, the backward kernels (K4a dQ, K4b dK/dV: the narrow wgmma
kernels up to head dim 128, above it up to 512 the wgmma kernels over
materialized bf16 scores of flash_attention_bwd.cu), the fp32
forward above head dim 128 (scores, softmax pass and TF32 GEMM in
flash_attention_bwd_tf32.cu), the fp32 backward's TF32 routes (the narrow
backward's TF32 mode up to 128, flash_attention_bwd_tf32.cu above) and
their prep kernel, autograd through the dispatchers, the short-K
cross-attention kernel (K5, wgmma with TMA loads and stores), the fused
GEGLU kernel (K6) with its autograd.Function, and the microbenchmarks'
kernels: the narrow kernel's bf16 mode and TF32 mode through the tiled
entry (S1, S3) and its all-heads block (S4).

Marked `cuda`; each test skips without a card (a CUDA kernel has no CPU
mode).  Imports neither JAX nor tests/conftest.py's fixtures, so it runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import pytest
import torch

from eta_inversion_tpu_torch.ops import flash_attention as tfa
from eta_inversion_tpu_torch.ops import geglu as tgeglu

# relative to the largest output (randn inputs give outputs of size about
# sqrt(e/S), not O(1)): bf16 rounding of the output and of the probabilities
# in the PV product costs about one bf16 ulp of it, 0.25-0.65%; a 3% error in
# the softmax normalisation exceeds 2% (same bound as chip_smoke.py)
RTOL = 2e-2


def _inputs(shape, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").bfloat16() for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d", [
    ("packed", 2, 4096, 8, 40), ("packed", 2, 1024, 8, 80),
    ("onepass", 8, 1024, 1, 80), ("blockwise", 1, 4096, 1, 512),
    ("blockwise", 2, 300, 1, 64),   # ragged S: masked key tail, partial q tile
    ("blockwise", 2, 1000, 1, 200),  # head dim padded to 256, ragged S
    ("blockwise", 2, 4096, 1, 512),  # the VAE decode's two rows at 512 px
    ("blockwise", 1, 4225, 1, 512),  # 65 x 65 tokens: ragged at d = 512
    ("packed", 2, 1024, 2, 160),     # the wide kernel's head strides
    # the other families at d = 64: sd21's 5 / 10 heads at 512 px, sd21v's at
    # 768 px (S = 9216, 2304), sdxl's 10 / 20 heads; ptp's flat q/k
    # substitution at 32x32 (sd21's 10 heads, sdxl's 20, 4 rows); the VAE
    # at 768 and 1024 px (S = 9216, 16384; d = 512)
    ("packed", 4, 4096, 5, 64), ("packed", 4, 1024, 10, 64),
    ("packed", 2, 9216, 5, 64), ("packed", 4, 2304, 10, 64),
    ("packed", 4, 4096, 10, 64), ("packed", 2, 1024, 20, 64),
    ("onepass", 40, 1024, 1, 64), ("onepass", 80, 1024, 1, 64),
    ("blockwise", 2, 9216, 1, 512), ("blockwise", 1, 16384, 1, 512),
])
def test_cuda_kernel_matches_plain(kind, b, s, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape = (b, s, h * d) if kind == "packed" else (b, s, d)
    q, k, v = _inputs(shape)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    if kind == "packed":
        got = tfa.flash_attention_packed(q, k, v, scale, heads=h)
        want = tfa.flash_attention_packed_plain(q, k, v, scale, h)
    else:
        got = tfa.flash_attention_bhsd(q, k, v, scale, block_k=s if kind == "onepass" else 256)
        want = tfa.flash_attention_bhsd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()
    # one launch, and K3 up to head dim 128 also counted as the narrow kernel's
    narrow = int(kind == "blockwise" and d <= tfa.NARROW_MAX_HEAD_DIM)
    assert tfa.LAUNCHES["flash_attention_bhsd_blockwise_narrow"] == narrow
    assert sum(tfa.LAUNCHES.values()) == 1 + narrow


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["eti_flash_attention_wide", "eti_crossk_attention"])
def test_cuda_wide_forward_is_a_wgmma_kernel(lib):
    """Head dims above 128 run on flash_attention_wide.cu and the short-K
    cross-attention (K5, S2) on crossk_attention.cu, whose SASS hold warpgroup
    MMA (HGMMA) instructions; no forward library of mma.sync kernels is
    built any more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from eta_inversion_tpu_torch.ops import cuda_build

    tfa.build_kernels()
    assert cuda_build.sass_count(lib, "HGMMA") > 0
    assert "eti_flash_attention" not in cuda_build.build_info


@pytest.mark.cuda
@pytest.mark.parametrize("need_lse", [False, True])
@pytest.mark.parametrize("s", [1024, 1032, 4096])
@pytest.mark.parametrize("d", [8, 16, 40, 64, 80, 128])
@pytest.mark.parametrize("packed", [True, False])
def test_cuda_narrow_forward_matches_plain(packed, d, s, need_lse):
    """The untiled bf16 route up to head dim 128 (flash_attention_narrow.cu):
    K1's packed and K2's flat layout, S a multiple of the 128-key tile or
    not (a masked key tail and a partial query block), against the plain
    version within 2% of its largest magnitude, the LSE (when asked) within
    LSE_TOL of attention_lse_plain; one launch on the wrapper's counter and
    none elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert tfa.fwd_library(d) == tfa.NARROW_LIB
    b, h = (1, 2) if packed else (2, 1)
    q, k, v = _inputs((b, s, h * d), seed=d + s)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    if packed:
        got, lse = tfa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=need_lse)
        want = tfa.flash_attention_packed_plain(q, k, v, scale, h)
        lse_want = tfa.attention_lse_plain(tfa._packed_to_flat(q, h), tfa._packed_to_flat(k, h),
                                           scale).reshape(b, h, s)
        counter = "flash_attention_packed"
    else:
        got, lse = tfa.flash_attention_bhsd_fwd(q, k, v, scale, block_k=s, need_lse=need_lse)
        want = tfa.flash_attention_bhsd_plain(q, k, v, scale)
        lse_want = tfa.attention_lse_plain(q, k, scale)
        counter = "flash_attention_bhsd_onepass"
    torch.cuda.synchronize()
    assert tfa.LAUNCHES[counter] == 1 and sum(tfa.LAUNCHES.values()) == 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()
    if need_lse:
        assert lse.shape == lse_want.shape and lse.dtype == torch.float32
        assert (lse - lse_want).abs().max().item() <= LSE_TOL
    else:
        assert lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(1024, 1032, 40), (1000, 4096, 80), (4096, 300, 64)])
def test_cuda_narrow_forward_takes_unequal_sequences(sq, sk, d):
    """Queries and keys of different lengths (flat layout) through the narrow
    kernel, with its LSE, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn(2, sq, d, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(2, sk, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    scale = d ** -0.5
    got, lse = tfa.flash_attention_bhsd_fwd(q, k, v, scale, block_k=sk, need_lse=True)
    want = tfa.flash_attention_bhsd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()
    assert (lse - tfa.attention_lse_plain(q, k, scale)).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1032, 4096])
def test_cuda_narrow_forward_reads_no_column_of_the_next_head(s):
    """At d = 40 a packed row's K / V box would reach into head h + 1 if the
    tensor map's extent were not d: head 0 is held against the plain version
    while heads 1 and 2 hold values far larger than its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, d = 2, 3, 40
    q, k, v = _inputs((b, s, h * d), seed=s)
    for x in (q, k, v):
        x.view(b, s, h, d)[:, :, 1:] = 300.0
    scale = d ** -0.5
    got = tfa.flash_attention_packed(q, k, v, scale, heads=h).view(b, s, h, d)[:, :, 0]
    want = tfa.flash_attention_packed_plain(q, k, v, scale, h).view(b, s, h, d)[:, :, 0]
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_narrow_forward_is_a_wgmma_kernel():
    """The untiled forward up to head dim 128 runs on warpgroup MMA: the
    narrow library's SASS holds HGMMA instructions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from eta_inversion_tpu_torch.ops import cuda_build

    tfa.build_kernels()
    assert cuda_build.sass_count(tfa.NARROW_LIB, "HGMMA") > 0


@pytest.mark.cuda
def test_cuda_narrow_forward_refuses_a_scale_it_does_not_take():
    """The kernel folds the scale into the exponent's FFMA and takes the row
    max of the raw scores, so it needs a positive scale: it raises for
    another, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((2, 256, 40))
    tfa.reset_launch_counts()
    for scale in (0.0, -0.1):
        with pytest.raises(ValueError, match="does not take"):
            tfa.flash_attention_bhsd(q, k, v, scale)
    assert set(tfa.LAUNCHES.values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [40, 80])
def test_cuda_autograd_through_the_narrow_forward(packed, d, monkeypatch):
    """Gradients of sum(sin(o)) through `_FlashAttention` at the UNet's head
    dims, its forward (with the LSE) on the narrow kernel, then K4a / K4b,
    against the plain path's autograd on the same bf16 inputs; 2% of the
    largest plain gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert tfa.fwd_library(d) == tfa.NARROW_LIB
    b, h, s = 1, 4, 1032
    shape = (b, s, h * d) if packed else (b, h, s, d)
    base = _inputs(shape, seed=23 + d)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in base]
        o = tfa.attention_packed(*xs, h) if packed else tfa.attention(*xs)
        torch.sin(o.float()).sum().backward()
        return [x.grad.float() for x in xs]

    tfa.reset_launch_counts()
    got = grads()
    fwd = "flash_attention_packed" if packed else "flash_attention_bhsd_blockwise"
    assert tfa.LAUNCHES[fwd] == 1
    assert tfa.LAUNCHES["flash_attention_bwd_dq"] == tfa.LAUNCHES["flash_attention_bwd_dkv"] == 1
    monkeypatch.setattr(tfa, "_kernel_eligible", lambda *a, **k: False)
    want = grads()
    for g, w, name in zip(got, want, "qkv"):
        assert (g - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_dispatch_raises_for_a_dtype_the_kernel_refuses(packed, dtype):
    """An eligible shape on the card goes to the kernels' routes whatever
    its dtype.  fp32 takes the TF32 mode (the launch counted on the wrapper's
    counter and the TF32 one) and matches the plain fp32 path within 2% of
    its largest magnitude; fp16, which no route takes, raises instead of
    quietly taking the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, s, d = 1, 2, 1024, 40
    shape = (b, s, h * d) if packed else (b, h, s, d)
    g = torch.Generator(device="cuda").manual_seed(31)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))

    def run():
        return tfa.attention_packed(q, k, v, h) if packed else tfa.attention(q, k, v)

    tfa.reset_launch_counts()
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="bfloat16"):
            run()
        assert set(tfa.LAUNCHES.values()) == {0}
        return
    got = run()
    torch.cuda.synchronize()
    counter = "flash_attention_packed" if packed else "flash_attention_bhsd_onepass"
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        counter: 1, "flash_attention_narrow_tf32": 1, "flash_attention_tf32_prep": 1}
    want = tfa.xla_attention(*(x.view(b, s, h, d).transpose(1, 2) if packed else x
                               for x in (q, k, v)), d ** -0.5)
    if packed:
        want = want.transpose(1, 2).reshape(shape)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((2, 256, 64))
    with pytest.raises(ValueError, match="bfloat16"):  # fp16: no route takes it
        tfa.flash_attention_bhsd(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match="multiples of 8"):
        a = torch.zeros(2, 256, 12, device="cuda", dtype=torch.bfloat16)
        tfa.flash_attention_bhsd(a, a, a, 0.3)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.1)


# the forward's LSE is a log of a row sum accumulated in fp32 from exact
# bf16 products: both sides agree to fp32 rounding (~1e-6 of a value near
# log S); 1e-3 is a 0.1% error of the row sum
LSE_TOL = 1e-3


def _bwd_inputs(kind, b, s, h, d, seed):
    """Seeded bf16 q, k, v, dO and the plain forward's o and LSE, in the
    wrapper's layout (packed (B, S, H*D) + (B, H, S) LSE, or flat
    (BH, S, D) + (BH, 1, S))."""
    shape = (b, s, h * d) if kind == "packed" else (b * h, s, d)
    q, k, v = _inputs(shape, seed)
    (do,) = _inputs(shape, seed + 1)[:1]
    scale = d ** -0.5
    if kind == "packed":
        o = tfa.flash_attention_packed_plain(q, k, v, scale, h)
        lse = tfa.attention_lse_plain(tfa._packed_to_flat(q, h), tfa._packed_to_flat(k, h),
                                      scale).reshape(b, h, s)
    else:
        o = tfa.flash_attention_bhsd_plain(q, k, v, scale)
        lse = tfa.attention_lse_plain(q, k, scale)
    return q, k, v, o, lse, do, scale


def _flat(x, kind, h):
    return tfa._packed_to_flat(x, h) if kind == "packed" else x


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d", [
    ("packed", 1, 4096, 8, 40), ("packed", 1, 1024, 8, 80),   # nti's main path
    ("packed", 2, 1024, 4, 64),
    ("flat", 2, 300, 1, 64),    # ragged S: masked key tail, partial q tile
    ("flat", 3, 1000, 1, 128),  # the largest head dim the backward takes
    ("packed", 1, 4096, 10, 64), ("packed", 1, 1024, 20, 64),  # nti on sdxl
])
def test_cuda_backward_kernels_match_plain(kind, b, s, h, d):
    """K4a against dQ and K4b against dK, dV of the plain backward, each
    within 2% of the plain gradient's largest magnitude (the forward's rule:
    both sides round the output to bf16, the kernels also round P and dS to
    bf16 before their products, about one bf16 ulp of the largest term)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, o, lse, do, scale = _bwd_inputs(kind, b, s, h, d, seed=7)
    heads = h if kind == "packed" else None
    tfa.reset_launch_counts()
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_dq"] == tfa.LAUNCHES["flash_attention_bwd_dkv"] == 1
    want = tfa.flash_attention_bwd_plain(*(_flat(x, kind, h) for x in (q, k, v, o)), lse,
                                         _flat(do, kind, h), scale)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        err = (_flat(got, kind, h).float() - ref.float()).abs().max().item()
        assert err <= RTOL * ref.float().abs().max().item(), name


def _check_bwd(got, want, kind, h):
    for g, ref, name in zip(got, want, ("dq", "dk", "dv")):
        err = (_flat(g, kind, h).float() - ref.float()).abs().max().item()
        assert err <= RTOL * ref.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
@pytest.mark.parametrize("kind,b,s,h", [
    ("packed", 2, 2048, 8),  # 256 blocks of 128 rows: two consumer warpgroups a block
    ("flat", 3, 1024, 1),    # 24 blocks of 128 rows would idle SMs: 64-row blocks
])
def test_cuda_narrow_backward_matches_plain(kind, b, s, h, d):
    """K4a and K4b up to head dim 128 (flash_attention_bwd_narrow.cu) at every
    head dim the kernels take, packed (8 heads) and flat, against the plain
    backward within 2% of its largest magnitude, and D against the plain
    rowsum; one launch of each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert tfa.bwd_library(d) == tfa.BWD_NARROW_LIB
    q, k, v, o, lse, do, scale = _bwd_inputs(kind, b, s, h, d, seed=d)
    heads = h if kind == "packed" else None
    tfa.reset_launch_counts()
    dq, dvec = tfa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads=heads)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale, heads=heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_dq"] == tfa.LAUNCHES["flash_attention_bwd_dkv"] == 1
    assert sum(tfa.LAUNCHES.values()) == 2
    flat = [_flat(x, kind, h) for x in (q, k, v, o, do)]
    want_dq, want_dvec = tfa.flash_attention_bwd_dq_plain(*flat[:4], lse, flat[4], scale)
    assert (dvec - want_dvec).abs().max().item() <= 1e-3 * want_dvec.abs().max().item()
    want = (want_dq, *tfa.flash_attention_bwd_dkv_plain(*flat[:3], lse, flat[4], want_dvec,
                                                        scale))
    _check_bwd((dq, dk, dv), want, kind, h)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d", [
    ("flat", 2, 300, 1, 40), ("flat", 2, 1000, 1, 80),     # ragged S: a masked key tail,
    ("packed", 1, 300, 8, 128), ("packed", 2, 1000, 8, 16),  # partial query and key tiles
])
def test_cuda_narrow_backward_takes_ragged_sequences(kind, b, s, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, o, lse, do, scale = _bwd_inputs(kind, b, s, h, d, seed=s + d)
    heads = h if kind == "packed" else None
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=heads)
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_plain(*(_flat(x, kind, h) for x in (q, k, v, o)), lse,
                                         _flat(do, kind, h), scale)
    _check_bwd(got, want, kind, h)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(1000, 4096, 40), (4096, 300, 80), (1024, 1032, 128)])
def test_cuda_narrow_backward_takes_unequal_sequences(sq, sk, d):
    """Queries and keys of different lengths (flat layout, which _bwd_prepare
    accepts): K4a walks sk keys for sq rows, K4b sq queries for sk rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q, do = (torch.randn(2, sq, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(2, sk, d, generator=g, device="cuda").bfloat16() for _ in range(2))
    scale = d ** -0.5
    o = tfa.flash_attention_bhsd_plain(q, k, v, scale)
    lse = tfa.attention_lse_plain(q, k, scale)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert [x.shape for x in got] == [q.shape, k.shape, v.shape]
    _check_bwd(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale), "flat", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80])
def test_cuda_narrow_backward_reads_no_column_of_the_next_head(d):
    """The products over a head dim padded to 16 read columns d..DP-1 of every
    tile (40..47 at d = 40): they must come in as zeros, never as head h + 1's
    columns.  Heads 1 and 2 of every operand hold NaN; head 0's gradients are
    held against the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, s, h = 1, 1032, 3
    q, k, v, o, lse, do, scale = _bwd_inputs("packed", b, s, h, d, seed=d + 1)
    for x in (q, k, v, o, do):
        x.view(b, s, h, d)[:, :, 1:] = float("nan")
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)
    torch.cuda.synchronize()
    head0 = [x.view(b, s, h, d)[:, :, 0] for x in (q, k, v, o, do)]
    want = tfa.flash_attention_bwd_plain(*head0[:4], lse[:, :1].reshape(b, 1, s), head0[4],
                                         scale)
    for g, ref, name in zip(got, want, ("dq", "dk", "dv")):
        err = (g.view(b, s, h, d)[:, :, 0].float() - ref.float()).abs().max().item()
        assert err <= RTOL * ref.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(1, 4096, 8, 40), (1, 1024, 8, 80)])
def test_cuda_narrow_backward_is_deterministic(b, s, h, d):
    """Every output element is summed by one thread in a fixed order (no
    atomics): two launches on the same inputs give the same bits, at nti's
    shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, o, lse, do, scale = _bwd_inputs("packed", b, s, h, d, seed=31)
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)
    torch.cuda.synchronize()
    for x, y, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_narrow_backward_is_a_wgmma_kernel():
    """The backward runs on warpgroup MMA at every head dim: the SASS of the
    narrow backward library (up to head dim 128) and of flash_attention_bwd.cu
    (bf16 above it) holds HGMMA instructions, and no library of the port
    holds an mma.sync one (HMMA)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from eta_inversion_tpu_torch.ops import cuda_build

    tfa.build_kernels()
    tgeglu.build_kernels()
    assert cuda_build.sass_count(tfa.BWD_NARROW_LIB, "HGMMA") > 0
    assert cuda_build.sass_count(tfa.BWD_LIB, "HGMMA") > 0
    for lib, _ in tfa._LIBS + tgeglu._LIBS:
        assert cuda_build.sass_count(lib, "HMMA") == 0, lib


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d", [
    ("packed", 1, 4096, 8, 40), ("onepass", 8, 1024, 1, 80), ("blockwise", 1, 4096, 1, 512),
    ("blockwise", 2, 300, 1, 64), ("blockwise", 2, 4096, 1, 512), ("blockwise", 1, 4225, 1, 512),
])
def test_cuda_forward_lse_matches_plain(kind, b, s, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape = (b, s, h * d) if kind == "packed" else (b, s, d)
    q, k, v = _inputs(shape, seed=3)
    scale = d ** -0.5
    if kind == "packed":
        o, lse = tfa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=True)
        want = tfa.attention_lse_plain(tfa._packed_to_flat(q, h), tfa._packed_to_flat(k, h),
                                       scale).reshape(b, h, s)
    else:
        o, lse = tfa.flash_attention_bhsd_fwd(q, k, v, scale,
                                              block_k=s if kind == "onepass" else 256,
                                              need_lse=True)
        want = tfa.attention_lse_plain(q, k, scale)
    torch.cuda.synchronize()
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert (lse - want).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_autograd_matches_plain_autograd(packed, monkeypatch):
    """Gradients of sum(sin(o)) through the dispatchers: on the kernel path
    (forward with LSE, K4a, K4b) against the plain path (the dispatch gate
    closed), same bf16 inputs; 2% of the largest plain gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, s, d = 1, 8, 1024, 40
    shape = (b, s, h * d) if packed else (b, h, s, d)
    base = _inputs(shape, seed=11)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in base]
        o = tfa.attention_packed(*xs, h) if packed else tfa.attention(*xs)
        torch.sin(o.float()).sum().backward()
        return [x.grad.float() for x in xs]

    tfa.reset_launch_counts()
    got = grads()
    assert tfa.LAUNCHES["flash_attention_bwd_dq"] == 1
    assert tfa.LAUNCHES["flash_attention_bwd_dkv"] == 1
    monkeypatch.setattr(tfa, "_kernel_eligible", lambda *a, **k: False)
    want = grads()
    for g, w, name in zip(got, want, "qkv"):
        assert (g - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
def test_cuda_backward_refuses_head_dims_above_128():
    """The backward's limit is now the forward's, 512 (it was 128): a head
    dim above it raises in the backward wrappers and in a differentiable
    forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, o, lse, do, scale = _bwd_inputs("flat", 1, 256, 1, 520, seed=5)
    with pytest.raises(ValueError, match="up to 512"):
        tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    x = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="up to 512"):
        tfa.flash_attention_bhsd(x, k, v, scale).float().sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d", [
    (1, 4096, 512), (2, 1024, 512),  # the VAE mid-block attention at 512 / 256 px
    (2, 300, 256),                   # ragged S, head dim padded to 256
    (1, 200, 136),                   # the smallest head dim above 128
])
def test_cuda_wide_backward_kernels_match_plain(b, s, d):
    """K4a / K4b above head dim 128 (materialized bf16 scores, then bf16
    GEMMs) against the plain backward; the bound of the narrow heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, o, lse, do, scale = _bwd_inputs("flat", b, s, 1, d, seed=13)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_dq"] == tfa.LAUNCHES["flash_attention_bwd_dkv"] == 1
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= RTOL * w.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d,scratch", [
    ("flat", 2, 4096, 1, 512, None),     # the VAE decode at 512 px: one stripe
    ("flat", 1, 4096, 1, 512, None),     # the encode
    ("flat", 2, 1033, 1, 512, 1 << 20),  # 9 stripes of 128 queries, the last ragged
    ("packed", 1, 1000, 2, 256, 1 << 20),  # head strides, 8 stripes
    ("flat", 1, 300, 1, 136, 1 << 16),   # the narrowest head dim, 3 stripes
])
def test_cuda_wide_backward_pair_repeats_bits(kind, b, s, h, d, scratch, monkeypatch):
    """The bf16 pair above head dim 128 in one stripe or several (`scratch`:
    a smaller score budget, so that dK and dV pass through the fp32
    workspace stripe by stripe): two calls give the same bits (one thread
    sums each output element, in a fixed order), each gradient within 2% of
    the plain backward's largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if scratch:
        monkeypatch.setattr(tfa, "BWD_TF32_SCRATCH_BYTES", scratch)
        assert tfa.bwd_tf32_stripe(s, s, b * h, 1, elem_bytes=2) < s
        assert tfa.bwd_tf32_stripe(s, s, b * h, 2, elem_bytes=2) < s
    q, k, v, o, lse, do, scale = _bwd_inputs(kind, b, s, h, d, seed=s + d)
    heads = h if kind == "packed" else None
    tfa.reset_launch_counts()
    first = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=heads)
    second = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_dq_wide"] == tfa.LAUNCHES["flash_attention_bwd_dq"] == 2
    assert tfa.LAUNCHES["flash_attention_bwd_dkv_wide"] == 2
    for x, y, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(x, y), name
    want = tfa.flash_attention_bwd_plain(*(_flat(x, kind, h) for x in (q, k, v, o)), lse,
                                         _flat(do, kind, h), scale)
    _check_bwd(first, want, kind, h)


@pytest.mark.cuda
def test_cuda_vae_attention_gradient_goes_through_the_wide_backward(monkeypatch):
    """A gradient through the VAE mid-block attention (512 channels, one
    head, 32x32 tokens) on the card: the blockwise forward with its LSE, then
    K4a / K4b at d = 512, within 1% (relative L2) of the plain path's for the
    input and the q / k / v projections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from eta_inversion_tpu_torch.models.vae import VAEAttention

    torch.manual_seed(0)
    mod = VAEAttention(512).cuda().to(torch.bfloat16)
    x = torch.randn(1, 512, 32, 32, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).bfloat16()

    def grads():
        mod.zero_grad()
        xg = x.clone().requires_grad_(True)
        torch.sin(mod(xg).float()).sum().backward()
        return [xg.grad.float()] + [getattr(mod, n).weight.grad.float()
                                    for n in ("to_q", "to_k", "to_v")]

    tfa.reset_launch_counts()
    got = grads()
    assert tfa.LAUNCHES["flash_attention_bwd_dq"] == tfa.LAUNCHES["flash_attention_bwd_dkv"] == 1
    monkeypatch.setattr(tfa, "_kernel_eligible", lambda *a, **k: False)
    for g, w, name in zip(got, grads(), ("x", "to_q", "to_k", "to_v")):
        assert (g - w).norm().item() <= 1e-2 * w.norm().item(), name


def _mean_err(got, want):
    return (got.float() - want.float()).abs().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,tile", [
    (16, 4096, 40, None), (16, 4096, 40, tfa.NARROW_TILE), (16, 1000, 40, None),
    (8, 1000, 128, tfa.NARROW_TILE),  # S1's pad-128 width; ragged S
    (4, 300, 120, None),    # head dim padded to 128 in shared memory only
])
def test_cuda_tf32_mode_matches_plain(bh, s, d, tile):
    """The fp32-operand (TF32) mode (its own tiles) and the bf16 mode with
    the narrow kernel's tile (chosen or by default) against the fp32 plain
    version: each within 2% of its largest magnitude, and TF32 on average
    closer to it than bf16 (P rounded to TF32's 10-bit mantissa, not to
    bf16's 7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((bh, s, d), seed=17)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bhsd_tiled(q, k, v, scale, operands="fp32")
    bf16 = tfa.flash_attention_bhsd_tiled(q, k, v, scale, operands="bf16", tile=tile)
    want = tfa.flash_attention_bhsd_plain(q.float(), k.float(), v.float(), scale)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bhsd_tf32"] == 1
    assert tfa.LAUNCHES["flash_attention_bhsd_tiled"] == 1
    for out in (got, bf16):
        err = (out.float() - want).abs().max().item()
        assert err <= RTOL * want.abs().max().item()
    assert _mean_err(got, want) < _mean_err(bf16, want)


# the TF32 mode's LSE: Q and K reach the tensor cores truncated to TF32's 10
# mantissa bits, which shrinks each score by about 2^-10 of itself; at
# unit-variance scores the row logsumexp moves by about 1e-3.  1e-2 is a 1%
# error of the row sum
LSE_TF32_TOL = 1e-2


def _fp32_inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda") for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("need_lse", [False, True])
@pytest.mark.parametrize("s", [1024, 1032])
@pytest.mark.parametrize("d", [8, 16, 40, 64, 80, 96, 120, 128])
@pytest.mark.parametrize("packed", [True, False])
def test_cuda_tf32_forward_matches_plain(packed, d, s, need_lse):
    """fp32 operands on the narrow kernel's TF32 mode at every padded head
    dim, K1's packed and K2's flat layout, S a multiple of the key tile or
    not: within 2% of the fp32 plain version's largest magnitude, on average
    closer to it than the bf16 kernel on the same inputs rounded to bf16,
    the LSE within LSE_TF32_TOL; one launch of the prep kernel and of the
    TF32 mode, counted on the wrapper's counter too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert tfa.fwd_library(d, dtype=torch.float32) == tfa.NARROW_TF32
    b, h = (1, 2) if packed else (2, 1)
    q, k, v = _fp32_inputs((b, s, h * d), seed=d + s)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    if packed:
        got, lse = tfa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=need_lse)
        want, lse_want = tfa._fwd_plain(q, k, v, scale, h, True)
        bf16, _ = tfa.flash_attention_packed_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                 scale, h)
        counter = "flash_attention_packed"
    else:
        got, lse = tfa.flash_attention_bhsd_fwd(q, k, v, scale, block_k=s, need_lse=need_lse)
        want, lse_want = tfa._fwd_plain(q, k, v, scale, None, True)
        bf16, _ = tfa.flash_attention_bhsd_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale,
                                               block_k=s)
        counter = "flash_attention_bhsd_onepass"
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        counter: 2, "flash_attention_narrow_tf32": 1, "flash_attention_tf32_prep": 1}
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    assert _mean_err(got, want) < _mean_err(bf16, want)
    if need_lse:
        assert lse.shape == lse_want.shape and lse.dtype == torch.float32
        assert (lse - lse_want).abs().max().item() <= LSE_TF32_TOL
    else:
        assert lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(1024, 1032, 40), (1000, 4096, 80), (300, 17, 64)])
def test_cuda_tf32_forward_takes_unequal_sequences(sq, sk, d):
    """Queries and keys of different lengths (flat, fp32), Sk not a multiple
    of 8 among them (V^T's zero-padded last key group), with the LSE."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn(2, sq, d, generator=g, device="cuda")
    k, v = (torch.randn(2, sk, d, generator=g, device="cuda") for _ in range(2))
    scale = d ** -0.5
    got, lse = tfa.flash_attention_bhsd_fwd(q, k, v, scale, block_k=sk, need_lse=True)
    want, lse_want = tfa._fwd_plain(q, k, v, scale, None, True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    assert (lse - lse_want).abs().max().item() <= LSE_TF32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80])
def test_cuda_tf32_forward_reads_no_column_of_the_next_head(d):
    """fp32 packed rows with NaN in heads 1 and 2: a box of the TF32 mode's
    maps (32 columns) reaching into head h + 1, or a prep row read past d,
    would carry NaN into head 0, which is held against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, s = 2, 3, 1032
    q, k, v = _fp32_inputs((b, s, h * d), seed=d)
    for x in (q, k, v):
        x.view(b, s, h, d)[:, :, 1:] = float("nan")
    scale = d ** -0.5
    got, lse = tfa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=True)
    head0 = [x.view(b, s, h, d)[:, :, :1].reshape(b, s, d) for x in (q, k, v)]
    want, lse_want = tfa._fwd_plain(*head0, scale, None, True)
    torch.cuda.synchronize()
    got0 = got.view(b, s, h, d)[:, :, 0]
    assert torch.isfinite(got0).all() and torch.isfinite(lse[:, 0]).all()
    assert (got0 - want).abs().max().item() <= RTOL * want.abs().max().item()
    assert (lse[:, 0] - lse_want[:, 0]).abs().max().item() <= LSE_TF32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("packed,dtype,sk", [
    (True, torch.float32, 4096), (False, torch.float32, 1037), (True, torch.float32, 300),
    (False, torch.bfloat16, 4096),   # S1 / S3: q and k widened
    (True, torch.bfloat16, 1001),
])
def test_cuda_tf32_prep_matches_plain(packed, dtype, sk):
    """The prep kernel against its plain version, bit for bit: V^T with each
    8-key group in TF32_KEY_ORDER, zero past Sk, rounded to TF32, and bf16 q,
    k widened."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, d, sq = 2, 3, 40, 1024
    shape = (lambda n: (b, n, h * d)) if packed else (lambda n: (b * h, n, d))
    g = torch.Generator(device="cuda").manual_seed(sk)
    q = torch.randn(shape(sq), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(shape(sk), generator=g, device="cuda").to(dtype) for _ in range(2))
    heads = h if packed else None
    tfa.reset_launch_counts()
    got = tfa.flash_attention_tf32_prep(q, k, v, heads)
    want = tfa.tf32_prep_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_tf32_prep"] == 1
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [40, 80])
def test_cuda_fp32_autograd_through_the_tf32_forward(packed, d, monkeypatch):
    """Gradients of sum(sin(o)) in fp32 through `_FlashAttention`: the
    forward (with its LSE) on the TF32 mode, the backward on the narrow
    backward's TF32 mode from that LSE after one prep launch, each counted,
    against the plain path's autograd on the same inputs; 2% of the largest
    plain gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert tfa.bwd_library(d, torch.float32) == tfa.BWD_NARROW_TF32
    b, h, s = 1, 4, 1032
    shape = (b, s, h * d) if packed else (b, h, s, d)
    base = _fp32_inputs(shape, seed=41 + d)

    def grads():
        xs = [x.clone().requires_grad_(True) for x in base]
        o = tfa.attention_packed(*xs, h) if packed else tfa.attention(*xs)
        torch.sin(o).sum().backward()
        return [x.grad for x in xs]

    tfa.reset_launch_counts()
    got = grads()
    fwd = "flash_attention_packed" if packed else "flash_attention_bhsd_blockwise"
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        fwd: 1, "flash_attention_narrow_tf32": 1, "flash_attention_tf32_prep": 1,
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        "flash_attention_bwd_dq_tf32": 1, "flash_attention_bwd_dkv_tf32": 1,
        "flash_attention_bwd_tf32_prep": 1}
    monkeypatch.setattr(tfa, "_kernel_eligible", lambda *a, **k: False)
    want = grads()
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32
        assert (g - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("need_lse", [False, True])
@pytest.mark.parametrize("kind,b,s,h,d,scratch", [
    ("flat", 2, 1024, 1, 136, None), ("flat", 2, 1000, 1, 200, None),  # ragged S
    ("flat", 1, 1024, 1, 160, None), ("flat", 2, 1024, 1, 160, None),  # d = 160, BH 1 and 2
    ("flat", 1, 1024, 1, 256, None),
    ("flat", 1, 4096, 1, 512, None),   # the VAE encode at 512 px
    ("flat", 2, 4096, 1, 512, None),   # the VAE decode at 512 px
    ("flat", 1, 1033, 1, 512, None),   # ragged at d = 512
    ("flat", 2, 1033, 1, 512, 1 << 20),  # 9 stripes of 128 queries, the last ragged
    ("packed", 2, 1024, 2, 160, None),   # head strides
    ("packed", 1, 1000, 2, 256, 1 << 20),  # head strides, 8 stripes
])
def test_cuda_fp32_wide_forward_matches_plain(kind, b, s, h, d, scratch, need_lse,
                                              monkeypatch):
    """fp32 above head dim 128 (K3 at the VAE mid-block's d = 512) on the
    forward of flash_attention_bwd_tf32.cu, with its LSE, in one stripe or
    several (`scratch`: a smaller score budget): within 2% of the fp32 plain
    version's largest magnitude, the LSE within LSE_TF32_TOL, two calls
    bitwise equal, the launch counted on the wrapper's key and the fp32 one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    assert tfa.fwd_library(d, dtype=torch.float32) == tfa.FWD_TF32_WIDE
    if scratch:
        monkeypatch.setattr(tfa, "BWD_TF32_SCRATCH_BYTES", scratch)
    q, k, v = _fp32_inputs((b, s, h * d) if kind == "packed" else (b, s, d), seed=d + s)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    if kind == "packed":
        run = lambda: tfa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=need_lse)  # noqa: E731
        want, lse_want = tfa._fwd_plain(q, k, v, scale, h, True)
        counter = "flash_attention_packed"
    else:
        run = lambda: tfa.flash_attention_bhsd_fwd(q, k, v, scale, block_k=256,  # noqa: E731
                                                   need_lse=need_lse)
        want, lse_want = tfa._fwd_plain(q, k, v, scale, None, True)
        counter = "flash_attention_bhsd_blockwise"
    got, lse = run()
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {counter: 1,
                                                            "flash_attention_fwd_fp32": 1}
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= RTOL * want.abs().max().item()
    again, lse_again = run()
    assert torch.equal(got, again)
    if need_lse:
        assert lse.shape == lse_want.shape and lse.dtype == torch.float32
        assert (lse - lse_want).abs().max().item() <= LSE_TF32_TOL
        assert torch.equal(lse, lse_again)
    else:
        assert lse is None


def _fp32_bwd_case(kind, b, sq, sk, h, d, seed):
    """Seeded fp32 q, k, v, dO with the plain forward's o and LSE, and the
    plain backward's flat (dQ, dK, dV); the wrapper's layout, and the map to
    the flat one."""
    heads = h if kind == "packed" else None
    shape = (lambda n: (b, n, h * d)) if heads else (lambda n: (b * h, n, d))
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(shape(sq), generator=g, device="cuda") for _ in range(2))
    k, v = (torch.randn(shape(sk), generator=g, device="cuda") for _ in range(2))
    scale = d ** -0.5
    f = (lambda x: tfa._packed_to_flat(x, h)) if heads else (lambda x: x)
    o, lse = tfa._fwd_plain(q, k, v, scale, heads, True)
    want = tfa.flash_attention_bwd_plain(f(q), f(k), f(v), f(o), lse, f(do), scale)
    return (q, k, v, o, lse, do, scale, heads), want, f


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h", [("packed", 1, 1032, 2), ("flat", 2, 1032, 1)])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128,
                               136, 160, 256, 512])
def test_cuda_fp32_backward_matches_plain(kind, b, s, h, d):
    """K4a and K4b on the TF32 routes (the narrow backward's TF32 mode up to
    head dim 128, flash_attention_bwd_tf32.cu above) at every instance of
    the narrow one and the other's edges, ragged S, packed and flat, each
    wrapper called alone (so each launches the prep kernel): dQ, dK, dV
    within 2% of the fp32 plain backward's largest magnitude from the same
    LSE, D within 1e-4 of its largest; each launch counted on the wrapper's
    key and its route's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args, want, f = _fp32_bwd_case(kind, b, s, s, h, d, seed=d)
    q, k, v, o, lse, do, scale, heads = args
    tfa.reset_launch_counts()
    dq, dvec = tfa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale, heads)
    torch.cuda.synchronize()
    sub = "tf32" if d <= tfa.NARROW_MAX_HEAD_DIM else "tf32_wide"
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {
        "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
        f"flash_attention_bwd_dq_{sub}": 1, f"flash_attention_bwd_dkv_{sub}": 1,
        "flash_attention_bwd_tf32_prep": 2}
    dvec_want = (f(do) * f(o)).sum(-1)
    assert (dvec - dvec_want).abs().max().item() <= 1e-4 * dvec_want.abs().max().item()
    for g, w, name in zip((dq, dk, dv), want, "qkv"):
        g = f(g)
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(1024, 1032, 40), (1000, 300, 80), (300, 17, 512)])
def test_cuda_fp32_backward_takes_unequal_sequences(sq, sk, d):
    """Queries and keys of different lengths (flat, fp32), key and query
    tails that fill no whole tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args, want, _ = _fp32_bwd_case("flat", 2, sq, sk, 1, d, seed=sq + sk)
    got = tfa.flash_attention_bwd(*args[:7], heads=None)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, "qkv"):
        assert (g - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_cuda_fp32_backward_reads_no_column_of_the_next_head(d):
    """Packed fp32 rows with NaN in heads 1 and 2: a load past d would carry
    NaN into head 0's gradients, which are held against the plain version;
    a second run gives the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, s = 1, 3, 1032
    args, _, _ = _fp32_bwd_case("packed", b, s, s, h, d, seed=d)
    q, k, v, o, lse, do, scale, _ = args
    head0 = [x.view(b, s, h, d)[:, :, 0].clone() for x in (q, k, v, o, do)]
    want = tfa.flash_attention_bwd_plain(*head0[:4], lse[:, :1].clone(), head0[4], scale)
    for x in (q, k, v, o, do):
        x.view(b, s, h, d)[:, :, 1:] = float("nan")
    lse[:, 1:] = float("nan")
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)
    torch.cuda.synchronize()
    for g, a, w, name in zip(got, again, want, "qkv"):
        g0 = g.view(b, s, h, d)[:, :, 0]
        assert torch.isfinite(g0).all() and torch.equal(g0, a.view(b, s, h, d)[:, :, 0])
        assert (g0 - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d", [
    ("packed", 1, 4096, 8, 40), ("packed", 1, 1024, 8, 80),  # nti's fp32 gradients
    ("packed", 1, 4096, 1, 512),                             # the VAE mid-block at 512 px
    ("flat", 2, 4096, 1, 512),                               # two rows: K4b in two stripes
    ("flat", 1, 1001, 1, 40), ("packed", 1, 1001, 2, 80),    # S not a multiple of 8
    ("flat", 1, 1001, 1, 512),
])
def test_cuda_fp32_backward_pair_matches_plain_and_repeats_bits(kind, b, s, h, d):
    """The pair (one prep launch, K4a, K4b) on the TF32 routes at the main
    path's shapes and ragged S: dQ, dK, dV within 2% of the fp32 plain
    backward's largest magnitude; a second call gives the same bits (one
    thread sums each output element, in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args, want, f = _fp32_bwd_case(kind, b, s, s, h, d, seed=s + d)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(*args[:7], heads=args[7])
    again = tfa.flash_attention_bwd(*args[:7], heads=args[7])
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_tf32_prep"] == 2
    for g, a, w, name in zip(got, again, want, "qkv"):
        assert torch.equal(g, a), f"d{name} differs between two calls"
        assert (f(g) - w).abs().max().item() <= RTOL * w.abs().max().item(), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("packed,sq,sk,d", [
    (True, 4096, 4096, 40), (False, 1001, 1037, 80), (True, 300, 17, 128), (False, 1033, 520, 512),
])
def test_cuda_bwd_tf32_prep_matches_plain(packed, sq, sk, d):
    """The backward's prep kernel against its plain version: K^T, Q^T and
    dO^T bit for bit (each 8-group in TF32_KEY_ORDER, zero past S, rounded
    to TF32), D within 1e-5 of its largest magnitude (another summation
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h = (1, 3) if packed else (3, 1)
    shape = (lambda n: (b, n, h * d)) if packed else (lambda n: (b * h, n, d))
    g = torch.Generator(device="cuda").manual_seed(sq + d)
    q, do, o = (torch.randn(shape(sq), generator=g, device="cuda") for _ in range(3))
    k = torch.randn(shape(sk), generator=g, device="cuda")
    heads = h if packed else None
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd_tf32_prep(q, k, do, o, heads)
    want = tfa.bwd_tf32_prep_plain(q, k, do, o, heads)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bwd_tf32_prep"] == 1
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert (got[3] - want[3]).abs().max().item() <= 1e-5 * want[3].abs().max().item()


@pytest.mark.cuda
def test_cuda_fp32_backward_above_128_is_a_tf32_wgmma_kernel():
    """flash_attention_bwd_tf32.cu's scores kernel and GEMM are wgmma
    (HGMMA in the library's SASS), as is the narrow backward's TF32 mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from eta_inversion_tpu_torch.ops import cuda_build

    tfa.build_kernels()
    assert cuda_build.sass_count(tfa.BWD_TF32_LIB, "HGMMA") > 0
    assert cuda_build.sass_count(tfa.BWD_NARROW_LIB, "HGMMA") > 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,tile", [
    (2, 4096, 8, 40, None), (2, 4096, 8, 40, (128, 128)),
    (1, 300, 4, 48, None),    # ragged S, fewer heads, an unpadded head dim
    (3, 1000, 2, 40, None),   # ragged S
    (1, 128, 1, 40, None),    # one key tile a head: Q freed after the first tile
    (1, 256, 16, 40, None),   # 16 heads walked by one block
])
@pytest.mark.parametrize("operands", ["bf16", "fp32"])
def test_cuda_multihead_matches_plain(b, s, h, d, tile, operands):
    """Both operand modes of the all-heads block against the fp32 plain
    version, within 2% of its largest magnitude; two calls bitwise equal;
    one launch counted (and, fp32, one of the TF32 mode's prep kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((b, s, h * d), seed=19)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.flash_attention_multihead(q, k, v, scale, h, operands, tile)
    want = tfa.flash_attention_packed_plain(q.float(), k.float(), v.float(), scale, h)
    torch.cuda.synchronize()
    counter = "flash_attention_multihead" + ("_tf32" if operands == "fp32" else "")
    launched = {counter: 1, **({"flash_attention_tf32_prep": 1} if operands == "fp32" else {})}
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == launched
    err = (got.float() - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item()
    assert torch.equal(got, tfa.flash_attention_multihead(q, k, v, scale, h, operands, tile))


@pytest.mark.cuda
def test_cuda_sweep_wrappers_refuse_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((2, 256, 40))
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_bhsd_tiled(q.float(), k.float(), v.float(), 0.1, "fp32")
    with pytest.raises(ValueError, match="does not take"):
        tfa.flash_attention_bhsd_tiled(q, k, v, 0.1, "fp32", tile=(8, 64))
    for d in (64, 136):  # no TF32 mode outside the benches' head dims, no other tile
        x = torch.zeros(2, 256, d, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="does not take"):
            tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, "fp32")
        with pytest.raises(ValueError, match="does not take"):
            tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, "bf16", tile=(4, 128))
    x = torch.zeros(2, 256, 136, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take head dim 136"):  # no narrow kernel
        tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, "bf16", tile=tfa.NARROW_TILE)
    p = torch.zeros(1, 256, 320, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_multihead(p.float(), p.float(), p.float(), 0.1, 8)
    with pytest.raises(ValueError, match="does not take"):
        tfa.flash_attention_multihead(p, p, p, 0.1, 8, tile=(2, 128))
    with pytest.raises(ValueError, match="does not take"):  # d = 64
        tfa.flash_attention_multihead(p, p, p, 0.1, 5)
    with pytest.raises(ValueError, match="does not take"):  # the block's scale is positive
        tfa.flash_attention_multihead(p, p, p, -0.1, 8)
    assert set(tfa.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_cuda_models_build_on_the_card_by_default():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eta_inversion_tpu_torch.models import load_diffusion_model

    model, _ = load_diffusion_model("tiny")
    assert model.device.type == "cuda"
    assert all(p.is_cuda for p in model.nets.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,d,sk,rows", [
    (32, 4096, 40, 77, 77), (32, 1024, 80, 77, 77), (32, 256, 160, 77, 77),  # sd15
    (8, 300, 64, 256, 256),    # the most keys; ragged Sq
    (4, 200, 8, 13, 13),       # few keys, the smallest head dim
    (16, 4096, 40, 77, 128),   # S2: K/V padded to 128 rows
    (320, 4096, 40, 77, 128),  # S2's folded rows: a block walks several heads
] + [
    # every key bucket (80, 128, 256 keys a score block) and head dim up to
    # 160, ragged Sq (partial 64-row tiles), K/V with more rows than sk
    (3, sq, d, sk, sk + 5) for d in (8, 40, 80, 128, 160) for sk in (1, 77, 128, 200, 256)
    for sq in (65, 1000)
])
def test_cuda_crossk_matches_plain(bh, sq, d, sk, rows):
    """K5's kernel against its plain version within 2% of the largest output,
    one launch counted, and a second launch giving the same bits (no
    atomics, a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (q,) = _inputs((bh, sq, d), seed=21)[:1]
    k, v = _inputs((bh, rows, d), seed=22)[:2]
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.crossk_attention_bhsd(q, k, v, sk, scale)
    want = tfa.crossk_attention_plain(q, k, v, sk, scale)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["crossk_attention"] == 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()
    assert torch.equal(got, tfa.crossk_attention_bhsd(q, k, v, sk, scale))


@pytest.mark.cuda
def test_cuda_crossk_takes_strided_views():
    """q, k, v as views with row and head strides of their own (a packed
    projection's columns, K/V rows past sk) give the contiguous result's
    bits, and a negative scale its plain result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qw, kw, vw = _inputs((6, 1000, 3 * 40), seed=23)
    q, k, v = qw[..., 40:80], kw[:, :90, :40], vw[:, :90, 80:]
    tfa.reset_launch_counts()
    got = tfa.crossk_attention_bhsd(q, k, v, 77, 0.15)
    want = tfa.crossk_attention_bhsd(*(x.contiguous() for x in (q, k, v)), 77, 0.15)
    assert torch.equal(got, want)
    neg = tfa.crossk_attention_bhsd(q, k, v, 77, -0.15)
    plain = tfa.crossk_attention_plain(q, k, v, 77, -0.15)
    torch.cuda.synchronize()
    assert (neg.float() - plain.float()).abs().max().item() \
        <= RTOL * plain.float().abs().max().item()
    assert tfa.LAUNCHES["crossk_attention"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1000, 4097])
@pytest.mark.parametrize("d", [40, 128])
def test_cuda_tiled_bf16_is_the_narrow_kernel(d, s):
    """S1's bf16 products through the tiled entry are the narrow kernel's
    bf16 mode (at d = 40 and at S1's padded 128): within 2% of the plain
    version at a ragged S, counted on the tiled entry's own counter, the
    untiled route's bits, and the same bits on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((6, s, d), seed=24)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bhsd_tiled(q, k, v, scale, "bf16")
    want = tfa.flash_attention_bhsd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in tfa.LAUNCHES.items() if c} == {"flash_attention_bhsd_tiled": 1}
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()
    assert torch.equal(got, tfa.flash_attention_bhsd_fwd(q, k, v, scale)[0])
    assert torch.equal(got, tfa.flash_attention_bhsd_tiled(q, k, v, scale, "bf16",
                                                           tfa.NARROW_TILE))


def _crossk_close(got, q, k, v, sk, scale):
    """got within RTOL of K5's plain version (with the TF32 mode's roundings
    for fp32 operands)."""
    want = tfa.crossk_attention_plain(q, k, v, sk, scale, tf32=q.dtype == torch.float32)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == q.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,sq,d,sk,rows", [
    (2, 256, 40, 77, 77), (2, 256, 168, 77, 77), (2, 256, 40, 300, 300),  # the CPU tests'
    (32, 4096, 40, 77, 77), (32, 1024, 80, 77, 77), (32, 256, 160, 77, 77),  # sd15
    (3, 1000, 8, 257, 260), (3, 65, 160, 1000, 1000), (3, 300, 80, 513, 600),  # 128-key chunks
    (4, 200, 48, 128, 128), (4, 200, 48, 129, 129),  # fp32: one chunk, then two
    (2, 300, 36, 77, 77),  # a head dim that is no multiple of 8: padded to 40
    (2, 200, 512, 300, 300), (2, 100, 200, 5, 9),  # above 160: the forward kernels
    (2, 64, 520, 77, 77), (2, 64, 520, 300, 300), (3, 100, 640, 77, 80),  # above 512
    (2, 64, 640, 300, 300),
    (2, 128, 1024, 77, 77), (2, 128, 1024, 300, 300), (1, 70, 1000, 5, 5),
])
def test_cuda_crossk_takes_what_jax_takes(dtype, bh, sq, d, sk, rows):
    """Every input JAX's crossk_attention_bhsd computes reaches a kernel:
    fp32 on K5's TF32 mode (after the backward's prep kernel writes V^T),
    more than 256 keys in 128-key chunks with an online softmax, a ragged
    head dim zero-padded, head dims above 160 on the forward kernels (above
    512 the fp32 forward's, which stream d, for bf16 operands too, widened
    to fp32 and o rounded back); each within 2% of the plain version,
    counted, and bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(bh + sq + d + sk)
    q = torch.randn(bh, sq, d, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(bh, rows, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.crossk_attention_bhsd(q, k, v, sk, scale)
    _crossk_close(got, q, k, v, sk, scale)
    wide = d > tfa.CROSSK_MAX_HEAD_DIM
    fp32 = dtype == torch.float32
    counts = {n: c for n, c in tfa.LAUNCHES.items() if c}
    assert counts.pop("crossk_attention") == 1
    assert counts.pop("crossk_attention_wide", 0) == int(wide)
    assert counts.pop("crossk_attention_tf32", 0) == int(fp32 and not wide)
    assert counts.pop("crossk_attention_chunked", 0) == int(
        not fp32 and not wide and sk > tfa.CROSSK_MAX_KEYS)
    if fp32:  # V^T by the prep kernel (the wide route counts its own)
        assert counts == ({"flash_attention_fwd_fp32": 1} if wide
                          else {"flash_attention_bwd_tf32_prep": 1})
    elif d > tfa.KERNEL_MAX_HEAD_DIM:  # the fp32 forward on widened q, k, v
        assert counts == {"flash_attention_fwd_fp32": 1}
    else:
        assert counts == {}
    assert torch.equal(got, tfa.crossk_attention_bhsd(q, k, v, sk, scale))


@pytest.mark.cuda
def test_cuda_crossk_refuses_what_the_kernel_does_not_take():
    """K5 refuses only what no route takes: sk above k's rows, no key, a
    scale that is not finite.  A head dim above 512 (refused until K5's
    repair) computes within 2% of the plain version.  fp32, a head dim above
    160, more than 256 keys, a row stride off TMA's 16-byte grain and a last
    dim that is not contiguous compute (the last two on an aligned copy),
    within 2% of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((2, 256, 40))
    tfa.reset_launch_counts()
    _crossk_close(tfa.crossk_attention_bhsd(q.float(), k.float(), v.float(), 77, 0.1),
                  q.float(), k.float(), v.float(), 77, 0.1)
    a = torch.randn(2, 64, 168, device="cuda", dtype=torch.bfloat16)
    _crossk_close(tfa.crossk_attention_bhsd(a, a, a, 64, 0.1), a, a, a, 64, 0.1)
    kk = torch.randn(2, 300, 40, device="cuda", dtype=torch.bfloat16)
    _crossk_close(tfa.crossk_attention_bhsd(q, kk, kk, 257, 0.1), q, kk, kk, 257, 0.1)
    odd = torch.randn(2, 256, 44, device="cuda", dtype=torch.bfloat16)[..., :40]
    _crossk_close(tfa.crossk_attention_bhsd(odd, k, v, 77, 0.1), odd, k, v, 77, 0.1)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)  # q's values, the last dim strided
    _crossk_close(tfa.crossk_attention_bhsd(qt, k, v, 77, 0.1), q, k, v, 77, 0.1)
    assert tfa.LAUNCHES["crossk_attention"] == 5
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="rows of k"):
        tfa.crossk_attention_bhsd(q, k[:, :77], v[:, :77], 78, 0.1)
    with pytest.raises(ValueError, match="at least one key"):
        tfa.crossk_attention_bhsd(q, k, v, 0, 0.1)
    with pytest.raises(ValueError, match="does not take"):  # the scale a kernel cannot use
        tfa.crossk_attention_bhsd(q, k, v, 77, float("inf"))
    assert tfa.LAUNCHES["crossk_attention"] == 0
    # a head dim above 512, refused before the repair, computes
    wide = torch.randn(2, 64, 520, device="cuda", dtype=torch.bfloat16)
    _crossk_close(tfa.crossk_attention_bhsd(wide, wide, wide, 64, 0.1), wide, wide, wide, 64,
                  0.1)
    assert tfa.LAUNCHES["crossk_attention"] == 1


def _geglu(n, c, inner, seed):
    """Seeded bf16 x (n, C) and nn.Linear-layout weights on the card, at
    tests/test_kernels.py's scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, s):
        return (torch.randn(shape, generator=g, device="cuda") * s).bfloat16()

    return (r(n, c, s=0.5), r(2 * inner, c, s=c ** -0.5), r(2 * inner, s=0.1),
            r(c, inner, s=inner ** -0.5), r(c, s=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,inner", [
    (2048, 320, 1280), (512, 640, 2560), (256, 1280, 5120),  # the sd15 levels
    (1000, 320, 1280),   # ragged rows: a partial last row block
    (300, 72, 128),      # C not a multiple of 16, one I step
    (256, 1288, 128),    # C above 1280, ragged against the 128-column tile
    (512, 8, 128),       # C narrower than one 64-column box
    (64, 1280, 5120),    # the mid block at batch 1
    (1024, 1280, 5120),  # the mid block at the 4-row width
])
def test_cuda_geglu_matches_plain(n, c, inner):
    """K6 against its plain version: within 2% of the plain output's largest
    magnitude (both keep the projection in fp32 and round the gated product
    to bf16, so they differ where a product rounds the other way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args = _geglu(n, c, inner, seed=n + c)
    tgeglu.reset_launch_counts()
    got = tgeglu.geglu_mlp_fused(*args)
    want = tgeglu.geglu_mlp_fused_plain(*args)
    torch.cuda.synchronize()
    assert tgeglu.LAUNCHES["geglu_fused"] == 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= RTOL * want.float().abs().max().item()


@pytest.mark.cuda
def test_cuda_geglu_is_a_wgmma_kernel():
    """K6 runs on warpgroup MMA: the geglu library's SASS holds HGMMA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from eta_inversion_tpu_torch.ops import cuda_build

    tgeglu.build_kernels()
    assert cuda_build.sass_count("eti_geglu", "HGMMA") > 0


@pytest.mark.cuda
def test_cuda_geglu_autograd_matches_plain_autograd():
    """Gradients of sum(sin(out)) through geglu_mlp(force_fused=True) (K6
    forward, the plain path's vjp backward) against autograd of the plain
    path, same bf16 inputs: relative L2 within 2%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    base = _geglu(2048, 320, 1280, seed=5)

    def grads(force):
        xs = [t.clone().requires_grad_(True) for t in base]
        torch.sin(tgeglu.geglu_mlp(xs[0].view(2, 1024, 320), *xs[1:],
                                   force_fused=force).float()).sum().backward()
        return [t.grad.float() for t in xs]

    tgeglu.reset_launch_counts()
    got = grads(True)
    assert tgeglu.LAUNCHES["geglu_fused"] == 1
    for g, w, name in zip(got, grads(False), ("x", "w1", "b1", "w2", "b2")):
        assert (g - w).norm().item() <= 2e-2 * w.norm().item(), name


@pytest.mark.cuda
def test_cuda_geglu_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w1, b1, w2, b2 = _geglu(256, 320, 1280, seed=1)
    with pytest.raises(ValueError, match="bfloat16"):
        tgeglu.geglu_mlp_fused(x.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        tgeglu.geglu_mlp_fused(x, w1, b1, w2.t().contiguous().t(), b2)
    # C above 1280 (the JAX gate has no upper bound on C) runs
    big = _geglu(256, 1288, 128, seed=2)
    got, want = tgeglu.geglu_mlp_fused(*big), tgeglu.geglu_mlp_fused_plain(*big)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= \
        RTOL * want.float().abs().max().item()
    odd = _geglu(256, 64, 192, seed=3)
    with pytest.raises(ValueError, match="multiples of 128"):
        tgeglu.geglu_mlp_fused(*odd)
    # the dispatch gate takes fp32 to the plain path, as JAX does, launching nothing
    tgeglu.reset_launch_counts()
    tgeglu.geglu_mlp(x.float(), w1, b1, w2, b2, force_fused=True)
    assert tgeglu.LAUNCHES["geglu_fused"] == 0


@pytest.mark.cuda
def test_cuda_checkpoint_loads_and_matches_the_cpu_load(tmp_path):
    """A tiny diffusers-layout checkpoint (models/weights.save_pretrained of a
    seeded init) loads with device="cuda": every parameter equals the CPU
    load's, and one UNet call matches the CPU model's (fp32, TF32 off for
    the matmuls and cuDNN's convolutions: the tiny UNet's attention stays on
    the plain path, S = 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eta_inversion_tpu_torch.models import load_diffusion_model
    from eta_inversion_tpu_torch.models.weights import save_pretrained

    src, _ = load_diffusion_model("tiny", device="cpu", seed=7)
    save_pretrained(src.nets, str(tmp_path), src.preset)
    cpu, _ = load_diffusion_model("tiny", device="cpu", weights_dir=str(tmp_path))
    card, _ = load_diffusion_model("tiny", device="cuda", weights_dir=str(tmp_path))
    want = cpu.nets.state_dict()
    for k, v in card.nets.state_dict().items():
        assert v.is_cuda and torch.equal(v.cpu(), want[k]), k
    g = torch.Generator().manual_seed(0)
    lat, ctx = torch.randn(2, 4, 8, 8, generator=g), torch.randn(2, 77, 32, generator=g)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = card.unet(lat.cuda(), 501, ctx.cuda()).cpu()
            ref = cpu.unet(lat, 501, ctx)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4), (got - ref).abs().max()
