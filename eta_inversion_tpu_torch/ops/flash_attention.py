"""Flash attention kernels for Hopper + the attention dispatch.

Counterpart of eta_inversion_tpu/ops/flash_attention.py.  The three Pallas
forward kernels that the main path reaches there compute one function,
exact-softmax attention, and here share one hand-written CUDA kernel
(csrc/flash_attention.cu) behind three wrappers that keep the JAX entry
points' names and signatures:

  * ``flash_attention_packed``           packed (B, S, H*D)       (K1)
  * ``flash_attention_bhsd``, block_k == S  flat (BH, S, D), one pass  (K2)
  * ``flash_attention_bhsd``, block_k <  S  flat (BH, S, D), blockwise (K3)

The two Pallas backward kernels are two CUDA kernels
(csrc/flash_attention_bwd.cu, head dims up to 512) behind
``flash_attention_bwd_dq`` (K4a) and ``flash_attention_bwd_dkv`` (K4b).
When autograd needs a gradient through a
forward wrapper on the card, the wrapper goes through `_FlashAttention` (the
counterpart of the JAX ``custom_vjp``s ``_flash`` / ``_flash_packed``): its
forward also writes the row logsumexp and saves q, k, v, o and that LSE, and
its backward launches K4a and K4b.  Without a gradient no LSE is written.

The kernel sizes its tiles to shared memory and ignores the JAX block sizes;
of those only ``block_k >= S`` is read, to say which TPU kernel a flat call
stands for, so that each keeps its own launch count.  Each wrapper launches
its kernel for a CUDA tensor and raises on anything it does not take; for a
CPU tensor it computes the plain PyTorch version beside it (same exact
softmax in fp32), which torch differentiates.

The short-K cross-attention kernel (K5) is csrc/crossk_attention.cu behind
``crossk_attention_bhsd``, the JAX entry point of the same name: an opt-in for
callers with flat (BH, Sq, D) layouts, as in JAX.  It also stands for K5's
Pallas prototype S2 (``cross_shortk`` in scripts/attn_microbench3.py), which
passes K/V already padded to 128 rows.

The other Pallas prototypes are reached only by the attention
microbenchmarks (eta_inversion_tpu_torch/microbench), never by a served path:
``flash_attention_bhsd_tiled`` runs K3's kernel with a chosen tile and, for
the fp32-operand products of S1 (``flash`` in scripts/flash_sweep.py) and S3
(``prod_flash`` in scripts/attn_multihead_bench.py), on the TF32 tensor
cores; ``flash_attention_multihead`` is S4 (``v8_multihead`` there), one
block per (batch, q tile) for all heads (csrc/flash_multihead.cu), with bf16
or, as the prototype, fp32 (TF32) operands.

The dispatchers `attention` / `attention_packed` gate on device and shape, as
the JAX ones do: long self-attention on the card goes to the wrappers (which
raise for a dtype the kernel does not take), everything else (CPU tensors,
short-K cross-attention, short sequences) to `xla_attention`, the plain path
with the JAX package's ±80 clamped softmax.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

LOG2E = 1.4426950408889634

# launches of each kernel wrapper since the last reset (a launch is counted
# where the kernel is launched, never for the plain version)
LAUNCHES: Dict[str, int] = {
    "flash_attention_packed": 0,
    "flash_attention_bhsd_onepass": 0,
    "flash_attention_bhsd_blockwise": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkv": 0,
    "crossk_attention": 0,
    "flash_attention_bhsd_tiled": 0,
    "flash_attention_bhsd_tf32": 0,
    "flash_attention_multihead": 0,
    "flash_attention_multihead_tf32": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_ptr = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
_LIBS = (("eti_flash_attention", ("flash_attention.cu",)),
         ("eti_flash_attention_bwd", ("flash_attention_bwd.cu",)),
         ("eti_crossk_attention", ("crossk_attention.cu",)),
         ("eti_flash_multihead", ("flash_multihead.cu",)))
_loaded: Optional[Tuple[ctypes.CDLL, ...]] = None


def build_kernels() -> Tuple[ctypes.CDLL, ...]:
    """Build (at first use, one nvcc per source, side by side) and load the
    forward, backward, short-K and multi-head attention kernel libraries."""
    global _loaded
    if _loaded is None:
        from .cuda_build import load_libraries

        fwd, bwd, crossk, multihead = load_libraries(_LIBS)
        fn = fwd.eti_flash_attention_fwd
        fn.argtypes = [_ptr] * 5 + [_i32] * 8 + [_i64] * 14 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        for fn in (bwd.eti_flash_attention_bwd_dq, bwd.eti_flash_attention_bwd_dkv):
            fn.argtypes = [_ptr] * 8 + [_i32] * 5 + [ctypes.POINTER(_i64), ctypes.c_float,
                                                     _ptr]
            fn.restype = _i32
        fn = crossk.eti_crossk_attention
        fn.argtypes = [_ptr] * 4 + [_i32] * 4 + [_i64] * 8 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = multihead.eti_flash_multihead
        fn.argtypes = [_ptr] * 4 + [_i32] * 8 + [_i64] * 8 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        _loaded = fwd, bwd, crossk, multihead
    return _loaded


# The kernels' own limits (csrc/flash_attention*.cu): bf16, head dim a
# multiple of 8 up to 512 forward and backward (d > 128 keeps the output, or
# the dQ / dK + dV rows, in shared memory; the d=512 tile sets take 165 KB
# forward, 194 KB for dQ and 226 KB for dK + dV of the block's 227 KB).  The
# microbenchmarks' tiles, TF32 mode and multi-head kernel exist only where
# the microbenchmarks run them; their C entry points say which arguments
# they take (UNSUPPORTED otherwise).
KERNEL_MAX_HEAD_DIM = 512
# an entry point's return for arguments it has no instance for (kUnsupported
# in csrc/flash_common.cuh); any other nonzero return is a cudaError_t
UNSUPPORTED = -1


def _launched(err: int, what: str, args: str) -> None:
    if err == UNSUPPORTED:
        raise ValueError(f"{what}: the kernel does not take {args}")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_head_dim(d: int, most: int = KERNEL_MAX_HEAD_DIM) -> None:
    if d % 8 or not 0 < d <= most:
        raise ValueError(f"head dim {d}: kernel takes multiples of 8 up to {most}")


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


def _check_rows(name: str, x: torch.Tensor, rows: int, sq: int) -> None:
    """A per-row fp32 vector (the LSE, D) of rows x sq, contiguous."""
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous() \
            or x.numel() != rows * sq:
        raise ValueError(f"{name}: expected a contiguous CUDA fp32 tensor of {rows} x {sq}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _strides(x: torch.Tensor, heads: Optional[int], d: int) -> Tuple[int, int, int]:
    """(batch, head, row) element strides: packed (B, S, H*D) when `heads` is
    given (head h starts at column h*d), flat (BH, S, D) otherwise."""
    return (x.stride(0), d, x.stride(1)) if heads else (x.stride(0), 0, x.stride(1))


def _layout(q, heads: Optional[int]) -> Tuple[int, int, int]:
    """(batch, heads, head dim) of a flat (heads None) or packed operand."""
    if heads is None:
        return q.shape[0], 1, q.shape[-1]
    if heads < 1 or q.shape[-1] % heads:
        raise ValueError(f"width {q.shape[-1]} does not split into {heads} heads")
    return q.shape[0], heads, q.shape[-1] // heads


def _check_grid(batch: int, heads: int, sq: int, sk: int) -> None:
    if sq == 0 or sk == 0:
        raise ValueError("empty sequence")
    if batch * heads > 65535:
        raise ValueError(f"batch*heads {batch * heads} exceeds the grid limit")


def _check_qkv(q, k, v, heads: Optional[int]) -> None:
    """The forward kernels' operand checks: bf16 CUDA q, k, v of matching
    shapes on one device."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, 3)
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


def _fwd_launch(q, k, v, scale: float, heads: Optional[int], need_lse: bool,
                tf32: bool = False, tile: Optional[Tuple[int, int]] = None):
    """Launch the forward kernel; returns (o, lse or None), lse fp32 (B, H, S)
    packed or (BH, 1, S) flat, the JAX layouts.  `tf32` (no LSE) and `tile`
    where the kernel has an instance for them (ValueError otherwise)."""
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    _check_qkv(q, k, v, heads)
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse, lse_st = None, (0, 0)
    if need_lse:
        lse = torch.empty((batch, h, sq) if heads else (batch, 1, sq),
                          dtype=torch.float32, device=q.device)
        lse_st = (h * sq, sq)
    lib = build_kernels()[0]
    flat = [s for x in (q, k, v, o) for s in _strides(x, heads, d)]
    err = lib.eti_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        batch, h, sq, sk, d, int(tf32), *(tile or (0, 0)), *flat, *lse_st, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launched(err, "flash attention kernel",
              f"head dim {d} with tile {tile} and {'TF32' if tf32 else 'bf16'} operands")
    return o, lse


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


def attention_lse_plain(q, k, scale: float):
    """Natural-log row logsumexp of the scaled scores over flat (BH, S, D),
    (BH, 1, S) fp32: the forward kernels' LSE output (JAX's flat layout; the
    packed (B, H, S) is its reshape)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return torch.logsumexp(s, dim=-1)[:, None, :]


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale: float):
    """K4a's function over flat (BH, S, D): (dQ, D) with P recomputed from
    the LSE (any shape of BH x S) and D = rowsum(dO o O), (BH, S) fp32."""
    dof = do.float()
    dvec = (dof * o.float()).sum(-1)
    p = _probs_from_lse(q, k, lse, scale)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    return dq.to(q.dtype), dvec


def flash_attention_bwd_dkv_plain(q, k, v, lse, do, dvec, scale: float):
    """K4b's function over flat (BH, S, D): (dK, dV) given D."""
    dof = do.float()
    p = _probs_from_lse(q, k, lse, scale)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.float())
    ds = p * (dp - dvec.reshape(p.shape[0], -1)[..., None])
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The arithmetic of the JAX `_flash_bwd_impl` in fp32 einsums over flat
    (BH, S, D) operands and a (BH, 1, S) LSE: (dQ, dK, dV)."""
    dq, dvec = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, lse, do, dvec, scale))


def _probs_from_lse(q, k, lse, scale: float):
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    return torch.exp(s - lse.reshape(s.shape[0], -1)[..., None])


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

def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX custom_vjp `_flash` (heads None: flat) and
    `_flash_packed` (packed): the forward writes the LSE and saves
    (q, k, v, o, lse); the backward launches K4a and K4b.  On CPU tensors
    both take the plain versions (the wrappers' CPU branch itself lets
    autograd differentiate the plain forward instead)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, heads: Optional[int], block_k: int):
        if heads is None:
            o, lse = flash_attention_bhsd_fwd(q, k, v, scale, block_k, need_lse=True)
        else:
            o, lse = flash_attention_packed_fwd(q, k, v, scale, heads, need_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.heads = scale, heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale,
                                         heads=ctx.heads)
        return dq, dk, dv, None, None, None


def flash_attention_bhsd_fwd(q, k, v, scale: float, block_k: int = 512,
                             need_lse: bool = False):
    """The flat forward (K2 when block_k >= S, else K3) with the LSE when
    asked, (o, lse (BH, 1, S) fp32 or None): `_flash_fwd_impl`'s contract."""
    if q.device.type == "cpu":
        o = flash_attention_bhsd_plain(q, k, v, scale)
        return o, attention_lse_plain(q, k, scale) if need_lse else None
    out = _fwd_launch(q, k, v, scale, None, need_lse)
    LAUNCHES[_bhsd_counter(block_k, k.shape[1])] += 1
    return out


def flash_attention_packed_fwd(q, k, v, scale: float, heads: int, need_lse: bool = False):
    """The packed forward (K1) with the LSE when asked, (o, lse (B, H, S)
    fp32 or None): `_packed_fwd_impl`'s contract."""
    if q.device.type == "cpu":
        o = flash_attention_packed_plain(q, k, v, scale, heads)
        lse = None
        if need_lse:
            lse = attention_lse_plain(_packed_to_flat(q, heads), _packed_to_flat(k, heads),
                                      scale).reshape(q.shape[0], heads, -1)
        return o, lse
    out = _fwd_launch(q, k, v, scale, heads, need_lse)
    LAUNCHES["flash_attention_packed"] += 1
    return out


def _bhsd_counter(block_k: int, sk: int) -> str:
    return ("flash_attention_bhsd_onepass" if block_k >= sk
            else "flash_attention_bhsd_blockwise")


def flash_attention_bhsd(q, k, v, scale: float, block_q: int = 512,
                         block_k: int = 512):
    """Flash attention over flat (BH, S, D) inputs.  block_k >= S stands for
    the TPU's one-pass kernel (K2), block_k < S for its blockwise kernel (K3);
    on Hopper both launch the same CUDA kernel, and block_q is ignored.
    Differentiable: on the card through K4a / K4b."""
    if q.device.type != "cpu" and _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, float(scale), None, block_k)
    return flash_attention_bhsd_fwd(q, k, v, scale, block_k)[0]


def flash_attention_packed(q, k, v, scale: float, heads: int,
                           block_q: int = 512, block_k: int = 2048):
    """Multi-head flash attention over packed (B, S, H*D) inputs, the UNet's
    projection layout: heads are strides, no transposes materialize (K1).
    block_q / block_k are ignored (kept for the JAX signature).
    Differentiable: on the card through K4a / K4b, in the packed layout."""
    if q.device.type != "cpu" and _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, float(scale), heads, block_k)
    return flash_attention_packed_fwd(q, k, v, scale, heads)[0]


def flash_attention_bhsd_tiled(q, k, v, scale: float, operands: str = "bf16",
                               tile: Optional[Tuple[int, int]] = None):
    """K3's function over flat (BH, S, D) with the card tile chosen: `tile`
    is (warps of 16 query rows, keys per tile), (4, 64), (2, 64) or (4,
    128); None for the default.  operands "bf16" is K3's kernel (bf16
    tensor-core products); "fp32" contracts fp32 Q, K, P and V on the TF32
    tensor cores, the products of the Pallas prototypes S1 (mm_bf16=False)
    and S3.  For the attention microbenchmarks (counted apart from K2 / K3:
    no served path launches it); no gradient.  On the card it takes bf16,
    and a chosen tile or fp32 operands only at the microbenchmarks' head
    dims (40 native and padded to 128: d of 33-48 or 113-128); it raises
    otherwise.  A CPU tensor takes the plain version (fp32 einsums)."""
    if operands not in ("bf16", "fp32"):
        raise ValueError(f"operands {operands!r}: 'bf16' or 'fp32'")
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, scale)
    o, _ = _fwd_launch(q, k, v, scale, None, need_lse=False, tf32=operands == "fp32",
                       tile=tile)
    LAUNCHES["flash_attention_bhsd_tf32" if operands == "fp32"
             else "flash_attention_bhsd_tiled"] += 1
    return o


def flash_attention_multihead(q, k, v, scale: float, heads: int, operands: str = "bf16",
                              tile: Optional[Tuple[int, int]] = None):
    """K1's function over packed (B, S, H*D) inputs, as the Pallas prototype
    S4 computes it: one block per (batch, q tile) walks all heads, K / V
    tiles staged once for every head.  operands "bf16" are K1's products,
    "fp32" the prototype's own (TF32 tensor cores).  `tile` is (warps per
    head, keys per staged tile), (2, 64), (1, 64), (2, 32) or (2, 96); None
    for (2, 64).  For the attention microbenchmarks (no served path launches
    it); no gradient.  On the card it takes bf16, the microbenchmarks' head
    dim (d of 33-48: SD's 40), and as many heads as its 512 threads and
    shared memory hold, and raises otherwise; a CPU tensor takes the plain
    version."""
    if operands not in ("bf16", "fp32"):
        raise ValueError(f"operands {operands!r}: 'bf16' or 'fp32'")
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, scale, heads)
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    _check_qkv(q, k, v, heads)
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, 1, sq, sk)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = build_kernels()[3]
    err = lib.eti_flash_multihead(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), batch, h, sq, sk, d,
        int(operands == "fp32"), *(tile or (0, 0)),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _launched(err, "multi-head attention kernel",
              f"{h} heads of d={d} with tile {tile} and {operands} operands "
              "(threads, shared memory or head dim)")
    LAUNCHES["flash_attention_multihead_tf32" if operands == "fp32"
             else "flash_attention_multihead"] += 1
    return o


def _bwd_prepare(q, k, v, lse, do, heads: Optional[int]):
    """Checks shared by K4a and K4b; returns (batch, heads, d, sq, sk)."""
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, x, 3)
    if k.shape != v.shape or do.shape != q.shape or k.shape[0] != batch \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)} heads={heads}")
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    _check_rows("lse", lse, batch * h, sq)
    return batch, h, d, sq, sk


def _bwd_strides(xs, heads, d):
    """The kernels' 26 strides: (batch, head, row) of q, k, v, o, dO, dQ, dK,
    dV (None: unused), then the lse's (batch, head)."""
    flat = []
    for x in xs:
        flat += [0, 0, 0] if x is None else list(_strides(x, heads, d))
    return (ctypes.c_longlong * 26)(*flat)


def flash_attention_bwd_dq(q, k, v, o, lse, do, scale: float, heads: Optional[int] = None):
    """K4a: (dQ, D) -- dQ in q's layout, D = rowsum(dO o O) as (BH, S) fp32
    for K4b.  Flat (BH, S, D) operands with a (BH, 1, S) LSE when `heads` is
    None, packed (B, S, H*D) with a (B, H, S) LSE otherwise (the forward's
    LSE layouts)."""
    if q.device.type == "cpu":
        if heads is None:
            return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
        f = [_packed_to_flat(x, heads) for x in (q, k, v, o, do)]
        dq, dvec = flash_attention_bwd_dq_plain(*f[:4], lse, f[4], scale)
        return _flat_to_packed(dq, q.shape[0], heads), dvec
    batch, h, d, sq, sk = _bwd_prepare(q, k, v, lse, do, heads)
    _check_operand("o", o, 3)
    if o.shape != q.shape:
        raise ValueError(f"o{tuple(o.shape)} does not match q{tuple(q.shape)}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dvec = torch.empty((batch * h, sq), dtype=torch.float32, device=q.device)
    strides = _bwd_strides((q, k, v, o, do, dq, None, None), heads, d)
    strides[24], strides[25] = h * sq, sq
    lib = build_kernels()[1]
    err = lib.eti_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), batch, h, sq, sk, d,
        strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention dQ kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq, dvec


def flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale: float,
                            heads: Optional[int] = None):
    """K4b: (dK, dV) in k's layout, given K4a's D; layouts as
    flash_attention_bwd_dq."""
    if q.device.type == "cpu":
        if heads is None:
            return flash_attention_bwd_dkv_plain(q, k, v, lse, do, dvec, scale)
        f = [_packed_to_flat(x, heads) for x in (q, k, v, do)]
        dk, dv = flash_attention_bwd_dkv_plain(*f[:3], lse, f[3], dvec, scale)
        return _flat_to_packed(dk, q.shape[0], heads), _flat_to_packed(dv, q.shape[0], heads)
    batch, h, d, sq, sk = _bwd_prepare(q, k, v, lse, do, heads)
    _check_rows("dvec", dvec, batch * h, sq)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = _bwd_strides((q, k, v, None, do, None, dk, dv), heads, d)
    strides[24], strides[25] = h * sq, sq
    lib = build_kernels()[1]
    err = lib.eti_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch, h, sq, sk, d,
        strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention dK/dV kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, heads: Optional[int] = None):
    """(dQ, dK, dV): K4a, then K4b on the D it wrote (`_flash_bwd_impl`)."""
    dq, dvec = flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads)
    return (dq, *flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale, heads))


# ---------------------------------------------------------------------------
# short-K cross-attention (K5)
# ---------------------------------------------------------------------------

# K5's limits (csrc/crossk_attention.cu): bf16, head dim a multiple of 8 up to
# 160 (SD-1.5's 16x16 and mid levels), at most 256 keys (a warp keeps the
# whole score row in registers)
CROSSK_MAX_HEAD_DIM = 160
CROSSK_MAX_KEYS = 256


def crossk_attention_plain(q, k, v, sk: int, scale: float):
    """K5's function over flat (BH, Sq, D) q and (BH, >= sk, D) k / v: fp32
    scores over the first `sk` keys, exact softmax (row max subtracted),
    probabilities rounded to v's dtype for an fp32 PV product, as the Pallas
    kernel rounds them."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k[:, :sk].float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p.float(), v[:, :sk].float()).to(q.dtype)


def crossk_attention_bhsd(q, k, v, sk: int, scale: float, block_q: int = 1024):
    """Cross-attention over flat (BH, Sq, D) q with a short key range: the
    first `sk` rows of (BH, >= sk, D) k and v (SD: 77 text tokens; K5's
    prototype S2 passes K/V already padded to 128 rows).  The kernel pads in
    shared memory and masks keys >= sk; block_q is ignored (kept for the JAX
    signature).  On the card it takes bf16, a head dim that is a multiple of
    8 up to 160 and sk up to 256, and raises otherwise; a CPU tensor takes
    the plain version.  No gradient: the JAX kernel has none either."""
    if q.device.type == "cpu":
        return crossk_attention_plain(q, k, v, sk, scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, 3)
    bh, sq, d = q.shape
    _check_head_dim(d, CROSSK_MAX_HEAD_DIM)
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 0 < sk <= min(k.shape[1], CROSSK_MAX_KEYS):
        raise ValueError(f"sk={sk}: kernel takes 1 to {CROSSK_MAX_KEYS} keys, "
                         f"at most the {k.shape[1]} rows of k")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    _check_grid(bh, 1, sq, sk)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = build_kernels()[2]
    err = lib.eti_crossk_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, sq, sk, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"short-K attention kernel launch failed: CUDA error {err}")
    LAUNCHES["crossk_attention"] += 1
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
