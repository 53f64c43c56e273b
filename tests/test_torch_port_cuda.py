"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips without a card (a CUDA kernel has no CPU
mode).  Imports neither JAX nor tests/conftest.py's fixtures, so it runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import pytest
import torch

from eta_inversion_tpu_torch.ops import flash_attention as tfa

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
