"""GEGLU feed-forward: the plain path and the fused kernel (K6).

Counterpart of eta_inversion_tpu/ops/geglu.py.  `geglu_mlp_xla` is the plain
path the UNet's FeedForward runs: x.W1 + b1 -> split -> h * gelu(gate) -> .W2
+ b2.  In fp32 the gelu is the exact erf gelu; in bf16 it is the JAX
package's pure-FMA polynomial erf (abs err <= 2e-4), so both packages round
the same function.

`geglu_mlp(..., force_fused=True)` is the opt-in fused entry point, gated as
the JAX one is (bf16, rows a multiple of the JAX row block, C % 8 == 0,
inner % 128 == 0).  A gated call launches the hand-written CUDA kernel
csrc/geglu.cu on a CUDA tensor (which raises for a call it cannot take) and
computes its plain version `geglu_mlp_fused_plain` on a CPU tensor.  The
gradient, as JAX's custom_vjp, differentiates `geglu_mlp_xla`.  Weights are
in nn.Linear's layout: w1 (2I, C), w2 (C, I).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

# odd minimax polynomial for erf on [-3, 3] (eta_inversion_tpu/ops/geglu.py)
ERF_COEF = (1.1283629719137802, -0.37581876264851877, 0.11186273083615,
            -0.025649756925251198, 0.004437909424632624,
            -0.0005535658971878295, 4.614817819605463e-05,
            -2.2677774146116304e-06, 4.9183736107624126e-08)

# launches of the fused kernel since the last reset (counted where the kernel
# is launched, never for the plain version)
LAUNCHES: Dict[str, int] = {"geglu_fused": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def erf_poly(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, -3.0, 3.0)
    z2 = z * z
    p = torch.full_like(z, ERF_COEF[-1])
    for c in ERF_COEF[-2::-1]:
        p = p * z2 + c
    return z * p


def gelu_poly_f32(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu on an fp32 tensor via the polynomial erf."""
    return 0.5 * x * (1.0 + erf_poly(x * (1.0 / math.sqrt(2.0))))


def geglu_mlp_xla(x, w1, b1, w2, b2):
    """w1/b1, w2/b2: nn.Linear weights (out, in) and biases, in the compute
    dtype of x."""
    s = F.linear(x, w1, b1)
    inner = w2.shape[1]
    h, gate = s[..., :inner], s[..., inner:]
    if x.dtype == torch.float32:
        a = h * F.gelu(gate)
    else:
        a = (h.float() * gelu_poly_f32(gate.float())).to(x.dtype)
    return F.linear(a, w2, b2)


def geglu_mlp_fused_plain(x, w1, b1, w2, b2):
    """K6's function on (n, C) x, rounded where the kernel rounds: the
    projection and bias in fp32 (h and gate are not rounded to x's dtype),
    h * gelu(gate) rounded to x's dtype, then .W2 + b2 in fp32, rounded."""
    s = x.float() @ w1.float().t() + b1.float()
    inner = w2.shape[1]
    a = (s[:, :inner] * gelu_poly_f32(s[:, inner:])).to(x.dtype)
    return (a.float() @ w2.float().t() + b2.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_LIBS = (("eti_geglu", ("geglu.cu",)),)
_loaded: Optional[ctypes.CDLL] = None

# the kernel's own limits (csrc/geglu.cu): C a multiple of 8 up to 1280 (its
# fp32 output rows live in registers), inner a multiple of 128 (its I step)
KERNEL_MAX_C = 1280


def build_kernels() -> ctypes.CDLL:
    """Build (at first use, with nvcc) and load the fused GEGLU library."""
    global _loaded
    if _loaded is None:
        from .cuda_build import load_libraries

        (lib,) = load_libraries(_LIBS)
        lib.eti_geglu_fused.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        lib.eti_geglu_fused.restype = ctypes.c_int
        _loaded = lib
    return _loaded


def geglu_mlp_fused(x, w1, b1, w2, b2):
    """K6 on (n, C) x: the kernel for a CUDA tensor, the plain version for a
    CPU one.  The kernel takes contiguous bf16 operands, C a multiple of 8 up
    to 1280 and inner a multiple of 128, and raises otherwise."""
    if x.device.type == "cpu":
        return geglu_mlp_fused_plain(x, w1, b1, w2, b2)
    n, c = x.shape
    inner = w2.shape[1]
    want = {"x": (n, c), "w1": (2 * inner, c), "b1": (2 * inner,), "w2": (c, inner),
            "b2": (c,)}
    for name, t in zip(want, (x, w1, b1, w2, b2)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: expected a CUDA tensor on {x.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: kernel takes bfloat16, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: expected shape {want[name]}, got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel takes contiguous 16-byte aligned data")
    if n == 0:
        raise ValueError("no rows")
    if c % 8 or c > KERNEL_MAX_C:
        raise ValueError(f"C={c}: kernel takes multiples of 8 up to {KERNEL_MAX_C}")
    if inner % 128:
        raise ValueError(f"inner={inner}: kernel takes multiples of 128")
    o = torch.empty_like(x)
    err = build_kernels().eti_geglu_fused(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        o.data_ptr(), n, c, inner, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused GEGLU kernel launch failed: CUDA error {err}")
    LAUNCHES["geglu_fused"] += 1
    return o


class _FusedGeglu(torch.autograd.Function):
    """Counterpart of the JAX custom_vjp `_fused`: the forward is K6, the
    backward differentiates the plain `geglu_mlp_xla` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return geglu_mlp_fused(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, do):
        args = [t.detach().requires_grad_(need)
                for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in args if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(geglu_mlp_xla(*args), wanted, do.to(args[0].dtype)))
        return tuple(next(grads) if t.requires_grad else None for t in args)


def _block_rows(inner: int) -> int:
    """The JAX kernel's row block (eta_inversion_tpu/ops/geglu.py:66), which
    its dispatch gate requires to divide the rows."""
    if inner <= 1280:
        return 2048
    return 512 if inner <= 2560 else 256


def geglu_mlp(x, w1, b1, w2, b2, force_fused: bool = False):
    """GEGLU feed-forward `proj_out(h * gelu(gate))` with `h, gate =
    split(geglu_proj(x))`.  x: (..., C); w1: (2I, C); w2: (C, I) (nn.Linear
    layout); the weights are cast to x's dtype, as the JAX entry point casts
    them.

    The plain path by default, as in JAX; with force_fused, bf16 calls whose
    rows, C and inner pass the JAX gate take K6 (`_FusedGeglu`)."""
    lead = x.shape[:-1]
    c = x.shape[-1]
    inner = w2.shape[1]
    n = int(math.prod(lead)) if lead else 1
    w1, b1, w2, b2 = (t.to(x.dtype) for t in (w1, b1, w2, b2))
    use_fused = (force_fused and x.dtype == torch.bfloat16
                 and n % _block_rows(inner) == 0 and c % 8 == 0 and inner % 128 == 0)
    if not use_fused:
        return geglu_mlp_xla(x, w1, b1, w2, b2)
    out = _FusedGeglu.apply(x.reshape(n, c).contiguous(), w1.contiguous(), b1.contiguous(),
                            w2.contiguous(), b2.contiguous())
    return out.reshape(*lead, c)
