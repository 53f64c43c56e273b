"""Flash attention kernels for Hopper + the attention dispatch.

Counterpart of eta_inversion_tpu/ops/flash_attention.py.  The three Pallas
forward kernels that the main path reaches there compute one function,
exact-softmax attention, and here share one hand-written CUDA kernel
(csrc/flash_attention.cu) behind three wrappers that keep the JAX entry
points' names and signatures:

  * ``flash_attention_packed``           packed (B, S, H*D)       (K1)
  * ``flash_attention_bhsd``, block_k == S  flat (BH, S, D), one pass  (K2)
  * ``flash_attention_bhsd``, block_k <  S  flat (BH, S, D), blockwise (K3)

The kernel sizes its tiles to shared memory and ignores the JAX block sizes;
of those only ``block_k >= S`` is read, to say which TPU kernel a flat call
stands for, so that each keeps its own launch count.  Each wrapper launches
the kernel for a CUDA tensor and raises on anything it does not take; for a
CPU tensor it computes the plain PyTorch version beside it (same exact
softmax in fp32).

The dispatchers `attention` / `attention_packed` gate on device and shape, as
the JAX ones do: long self-attention on the card goes to the wrappers (which
raise for a dtype the kernel does not take), everything else (CPU tensors,
short-K cross-attention, short sequences) to `xla_attention`, the plain path
with the JAX package's ±80 clamped softmax.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

LOG2E = 1.4426950408889634

# launches of each kernel wrapper since the last reset (a launch is counted
# where the kernel is launched, never for the plain version)
LAUNCHES: Dict[str, int] = {
    "flash_attention_packed": 0,
    "flash_attention_bhsd_onepass": 0,
    "flash_attention_bhsd_blockwise": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_LIB_NAME = "eti_flash_attention"
_ptr = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    from .cuda_build import load_library

    lib = load_library(_LIB_NAME, ["flash_attention.cu"])
    fn = lib.eti_flash_attention_fwd
    fn.argtypes = [_ptr] * 4 + [_i32] * 5 + [_i64] * 12 + [ctypes.c_float, _ptr]
    fn.restype = _i32
    return lib


def build_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the attention kernel library."""
    return _library()


# The kernel's own limits (csrc/flash_attention.cu): bf16, head dim a multiple
# of 8 up to 512 (d > 128 keeps the output row in shared memory; the d=512
# tile set takes 165 KB of the block's 227 KB).
KERNEL_MAX_HEAD_DIM = 512


def _check_head_dim(d: int) -> None:
    if d % 8 or not 0 < d <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: kernel takes multiples of 8 up to "
                         f"{KERNEL_MAX_HEAD_DIM}")


def _check_operand(name: str, x: torch.Tensor, ndim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: kernel takes bfloat16, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous, strides {x.stride()}")
    if any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned (strides {x.stride()})")


def _launch(q, k, v, o, batch: int, heads: int, d: int, strides, scale: float) -> None:
    """strides: for each of q, k, v, o a (batch, head, row) element-stride
    triple."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == 0 or sk == 0:
        raise ValueError("empty sequence")
    if batch * heads > 65535:
        raise ValueError(f"batch*heads {batch * heads} exceeds the grid limit")
    if not (q.device == k.device == v.device == o.device):
        raise ValueError("q, k, v on different devices")
    lib = _library()
    flat = [s for triple in strides for s in triple]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.eti_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        batch, heads, sq, sk, d, *flat, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")


# ---------------------------------------------------------------------------
# plain versions (fp32 exact softmax on the given inputs)
# ---------------------------------------------------------------------------

def flash_attention_bhsd_plain(q, k, v, scale: float):
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_packed_plain(q, k, v, scale: float, heads: int):
    b, sq, hd = q.shape
    o = flash_attention_bhsd_plain(_packed_to_flat(q, heads),
                                   _packed_to_flat(k, heads),
                                   _packed_to_flat(v, heads), scale)
    return _flat_to_packed(o, b, heads)


def _packed_to_flat(x, heads: int):
    b, s, hd = x.shape
    d = hd // heads
    return x.reshape(b, s, heads, d).transpose(1, 2).reshape(b * heads, s, d)


def _flat_to_packed(x, b: int, heads: int):
    bh, s, d = x.shape
    return x.reshape(b, heads, s, d).transpose(1, 2).reshape(b, s, heads * d)


# ---------------------------------------------------------------------------
# wrappers (JAX entry-point names)
# ---------------------------------------------------------------------------

def flash_attention_bhsd(q, k, v, scale: float, block_q: int = 512,
                         block_k: int = 512):
    """Flash attention over flat (BH, S, D) inputs.  block_k >= S stands for
    the TPU's one-pass kernel (K2), block_k < S for its blockwise kernel (K3);
    on Hopper both launch the same CUDA kernel, and block_q is ignored."""
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, scale)
    _check_head_dim(q.shape[-1])
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, 3)
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [(x.stride(0), 0, x.stride(1)) for x in (q, k, v, o)]
    _launch(q, k, v, o, bh, 1, d, strides, scale)
    key = ("flash_attention_bhsd_onepass" if block_k >= k.shape[1]
           else "flash_attention_bhsd_blockwise")
    LAUNCHES[key] += 1
    return o


def flash_attention_packed(q, k, v, scale: float, heads: int,
                           block_q: int = 512, block_k: int = 2048):
    """Multi-head flash attention over packed (B, S, H*D) inputs, the UNet's
    projection layout: heads are strides, no transposes materialize (K1).
    block_q / block_k are ignored (kept for the JAX signature)."""
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, scale, heads)
    if heads < 1 or q.shape[-1] % heads:
        raise ValueError(f"width {q.shape[-1]} does not split into {heads} heads")
    _check_head_dim(q.shape[-1] // heads)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, 3)
    b, sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    d = hd // heads
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [(x.stride(0), d, x.stride(1)) for x in (q, k, v, o)]
    _launch(q, k, v, o, b, heads, d, strides, scale)
    LAUNCHES["flash_attention_packed"] += 1
    return o


# the JAX dispatch takes its one-pass kernel (block_k == S) up to this length
# (flash_block_sizes there), and its blockwise kernel above
ONEPASS_MAX_SEQ = 1024


# ---------------------------------------------------------------------------
# plain paths + dispatch
# ---------------------------------------------------------------------------

def xla_attention(q, k, v, scale: float):
    """Plain attention over (B, H, S, D); fp32 softmax with the JAX package's
    single-pass ±80 clamp in place of the row-max subtraction (identical for
    realistic score ranges)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    e = torch.exp(torch.clamp(s * scale, -80.0, 80.0))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


# largest (B, H, Sq, Sk) fp32 score tensor the unchunked plain path may build
_XLA_SCORE_BUDGET = 256 * 1024 * 1024


def _chunk_size(sq: int, rows: int) -> int:
    """Largest q-chunk dividing sq whose score slab fits the budget."""
    fits = [c for c in range(1, sq + 1)
            if sq % c == 0 and rows * c * 4 <= _XLA_SCORE_BUDGET]
    return max(fits) if fits else 1


def xla_attention_chunked(q, k, v, scale: float, chunk: int):
    """xla_attention over q-chunks: only a (B, H, chunk, Sk) slab is live."""
    return torch.cat([xla_attention(q[:, :, i:i + chunk], k, v, scale)
                      for i in range(0, q.shape[2], chunk)], dim=2)


def attention_probs(q, k, scale: float):
    """Materialized attention probabilities (fp32) for hook-carrying layers."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return torch.softmax(s * scale, dim=-1)


def _kernel_eligible(q, sq: int, sk: int, d: int, min_flash_seq: int) -> bool:
    """Device and shape gate of the CUDA kernel: long self-attention on the
    card with a head dim its shared-memory tiles take (multiple of 8, <= 512).
    The dtype is not gated: the wrapper raises for one the kernel refuses."""
    return (q.is_cuda and sq == sk and sq >= min_flash_seq
            and d % 8 == 0 and d <= KERNEL_MAX_HEAD_DIM)


def attention(q, k, v, scale: Optional[float] = None, min_flash_seq: int = 1024):
    """Dispatching attention over (B, H, S, D): the flash kernel for long
    self-attention, the plain path otherwise (chunked over q when the score
    tensor would exceed the budget)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if not _kernel_eligible(q, sq, sk, d, min_flash_seq):
        if b * h * sq * sk * 4 > _XLA_SCORE_BUDGET:
            chunk = _chunk_size(sq, b * h * sk)
            if chunk < sq:
                return xla_attention_chunked(q, k, v, scale, chunk)
        return xla_attention(q, k, v, scale)
    qf = q.reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * h, sk, d).contiguous()
    vf = v.reshape(b * h, sk, d).contiguous()
    o = flash_attention_bhsd(qf, kf, vf, scale=float(scale),
                             block_k=min(sk, ONEPASS_MAX_SEQ))
    return o.reshape(b, h, sq, d)


def attention_packed(q, k, v, heads: int, scale: Optional[float] = None,
                     min_flash_seq: int = 1024):
    """Dispatching self-attention over packed (B, S, H*D) q/k/v, for
    hook-passthrough layers only."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // heads
    if scale is None:
        scale = d ** -0.5
    if heads == 1:
        # single head (VAE mid-attention): packed already is flat
        return attention(q[:, None], k[:, None], v[:, None], scale,
                         min_flash_seq=min_flash_seq)[:, 0]
    if not _kernel_eligible(q, sq, sk, d, min_flash_seq) or heads * d != hd:
        qh = q.reshape(b, sq, heads, d).transpose(1, 2)
        kh = k.reshape(b, sk, heads, d).transpose(1, 2)
        vh = v.reshape(b, sk, heads, d).transpose(1, 2)
        o = xla_attention(qh, kh, vh, scale)
        return o.transpose(1, 2).reshape(b, sq, hd)
    return flash_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(),
                                  scale=float(scale), heads=heads)
