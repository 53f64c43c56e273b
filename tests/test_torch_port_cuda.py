"""The port's CUDA kernels against their plain versions, on the card: the
forward kernel (K1-K3) with its LSE, the backward kernels (K4a dQ, K4b
dK/dV, head dims up to 512), autograd through the dispatchers, the short-K
cross-attention kernel (K5), the fused GEGLU kernel (K6) with its
autograd.Function, and the microbenchmarks' kernels: the tiled / TF32 flat
kernel (S1, S3) and the multi-head kernel (S4).

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
    assert sum(tfa.LAUNCHES.values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_dispatch_raises_for_a_dtype_the_kernel_refuses(packed):
    """An eligible shape on the card goes to the kernel whatever its dtype:
    fp32 raises instead of quietly taking the plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    b, h, s, d = 1, 2, 1024, 40
    shape = (b, s, h * d) if packed else (b, h, s, d)
    q = torch.zeros(shape, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        if packed:
            tfa.attention_packed(q, q, q, h)
        else:
            tfa.attention(q, q, q)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((2, 256, 64))
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_bhsd(q.float(), k.float(), v.float(), 0.125)
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,s,h,d", [
    ("packed", 1, 4096, 8, 40), ("onepass", 8, 1024, 1, 80), ("blockwise", 1, 4096, 1, 512),
    ("blockwise", 2, 300, 1, 64),
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
    """K4a / K4b above head dim 128 (dQ, dK + dV kept in shared-memory slots)
    against the plain backward; the bound of the narrow heads."""
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
    (16, 4096, 40, None), (16, 4096, 40, (4, 128)), (16, 4096, 40, (2, 64)),
    (8, 1000, 128, (4, 128)),  # S1's pad-128 width; ragged S
    (4, 300, 120, (4, 64)),    # head dim padded to 128 in shared memory only
])
def test_cuda_tf32_mode_matches_plain(bh, s, d, tile):
    """The fp32-operand (TF32) mode and the bf16 mode with the same tile
    against the fp32 plain version: each within 2% of its largest
    magnitude, and TF32 on average closer to it than bf16 (P rounded to
    TF32's 10-bit mantissa, not to bf16's 7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((bh, s, d), seed=17)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bhsd_tiled(q, k, v, scale, operands="fp32", tile=tile)
    bf16 = tfa.flash_attention_bhsd_tiled(q, k, v, scale, operands="bf16", tile=tile)
    want = tfa.flash_attention_bhsd_plain(q.float(), k.float(), v.float(), scale)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_bhsd_tf32"] == 1
    assert tfa.LAUNCHES["flash_attention_bhsd_tiled"] == 1
    for out in (got, bf16):
        err = (out.float() - want).abs().max().item()
        assert err <= RTOL * want.abs().max().item()
    assert _mean_err(got, want) < _mean_err(bf16, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,tile", [
    (2, 4096, 8, 40, None), (2, 4096, 8, 40, (1, 64)), (2, 4096, 8, 40, (2, 32)),
    (2, 4096, 8, 40, (2, 96)),
    (1, 300, 4, 48, None),   # ragged S, fewer heads, an unpadded head dim
    (3, 1000, 2, 40, (2, 96)),  # ragged S in the widest staged tile
])
@pytest.mark.parametrize("operands", ["bf16", "fp32"])
def test_cuda_multihead_matches_plain(b, s, h, d, tile, operands):
    """Both operand modes against the fp32 plain version, within 2% of its
    largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((b, s, h * d), seed=19)
    scale = d ** -0.5
    tfa.reset_launch_counts()
    got = tfa.flash_attention_multihead(q, k, v, scale, h, operands, tile)
    want = tfa.flash_attention_packed_plain(q.float(), k.float(), v.float(), scale, h)
    torch.cuda.synchronize()
    counter = "flash_attention_multihead" + ("_tf32" if operands == "fp32" else "")
    assert tfa.LAUNCHES[counter] == 1 and sum(tfa.LAUNCHES.values()) == 1
    err = (got.float() - want).abs().max().item()
    assert err <= RTOL * want.abs().max().item()


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
    for d in (64, 136):  # no chosen tile or TF32 mode outside the benches' head dims
        x = torch.zeros(2, 256, d, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="does not take"):
            tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, "fp32")
        with pytest.raises(ValueError, match="does not take"):
            tfa.flash_attention_bhsd_tiled(x, x, x, 0.1, "bf16", tile=(4, 128))
    p = torch.zeros(1, 256, 320, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_multihead(p.float(), p.float(), p.float(), 0.1, 8)
    with pytest.raises(ValueError, match="does not take"):
        tfa.flash_attention_multihead(p, p, p, 0.1, 8, tile=(2, 128))
    with pytest.raises(ValueError, match="does not take"):  # d = 64
        tfa.flash_attention_multihead(p, p, p, 0.1, 5)
    many = torch.zeros(1, 256, 16 * 40, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="threads"):  # 16 heads x 2 warps > 512 threads
        tfa.flash_attention_multihead(many, many, many, 0.1, 16)
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
])
def test_cuda_crossk_matches_plain(bh, sq, d, sk, rows):
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


@pytest.mark.cuda
def test_cuda_crossk_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _inputs((2, 256, 40))
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.crossk_attention_bhsd(q.float(), k.float(), v.float(), 77, 0.1)
    a = torch.zeros(2, 64, 168, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 160"):
        tfa.crossk_attention_bhsd(a, a, a, 64, 0.1)
    kk = torch.zeros(2, 300, 40, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256 keys"):
        tfa.crossk_attention_bhsd(q, kk, kk, 257, 0.1)
    with pytest.raises(ValueError, match="rows of k"):
        tfa.crossk_attention_bhsd(q, k[:, :77], v[:, :77], 78, 0.1)


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
    big = _geglu(256, 1288, 128, seed=2)
    with pytest.raises(ValueError, match="up to 1280"):
        tgeglu.geglu_mlp_fused(*big)
    odd = _geglu(256, 64, 192, seed=3)
    with pytest.raises(ValueError, match="multiples of 128"):
        tgeglu.geglu_mlp_fused(*odd)
    # the dispatch gate takes fp32 to the plain path, as JAX does, launching nothing
    tgeglu.reset_launch_counts()
    tgeglu.geglu_mlp(x.float(), w1, b1, w2, b2, force_fused=True)
    assert tgeglu.LAUNCHES["geglu_fused"] == 0
