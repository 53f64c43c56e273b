"""Flash attention kernels for Hopper + the attention dispatch.

Counterpart of eta_inversion_tpu/ops/flash_attention.py.  The three Pallas
forward kernels that the main path reaches there compute one function,
exact-softmax attention, and here share hand-written CUDA kernels behind
three wrappers that keep the JAX entry points' names and signatures:

  * ``flash_attention_packed``           packed (B, S, H*D)       (K1)
  * ``flash_attention_bhsd``, block_k == S  flat (BH, S, D), one pass  (K2)
  * ``flash_attention_bhsd``, block_k <  S  flat (BH, S, D), blockwise (K3)

Head dims up to 128 run on csrc/flash_attention_narrow.cu (wgmma, K/V staged
by TMA, two consumer warpgroups of 64 query rows); wider ones, K3 at the VAE
mid-block attention's d = 512 among them, on csrc/flash_attention_wide.cu
(wgmma, TMA, the output columns split between the warpgroups).

The kernels take bf16 and fp32 operands, as the Pallas kernels do.  fp32
products run on the TF32 tensor cores with fp32 accumulation, whatever
torch.backends.cuda.matmul.allow_tf32 says: forward calls up to head dim 128
on the TF32 mode of the narrow kernel, after a prep kernel that writes V
transposed (`flash_attention_tf32_prep`); the backward (K4a / K4b) after a
prep kernel that writes K, Q and dO transposed and D
(`flash_attention_bwd_tf32_prep`), up to head dim 128 on the TF32 mode of
the narrow backward; above head dim 128, forward (K3 at the VAE's d = 512)
and backward, on csrc/flash_attention_bwd_tf32.cu (materialized scores and
TF32 GEMMs; the forward's V^T from the backward's prep kernel).
`fwd_library` / `bwd_library` are the routing rule, by head dim and dtype;
any other dtype raises.

The two Pallas backward kernels are two CUDA kernels behind
``flash_attention_bwd_dq`` (K4a) and ``flash_attention_bwd_dkv`` (K4b): up to
head dim 128 (the UNet's self-attention, nti's gradients) on
csrc/flash_attention_bwd_narrow.cu (wgmma, every tile staged by TMA), above it
(the VAE mid-block's d = 512) on csrc/flash_attention_bwd.cu (wgmma and
TMA over bf16 scores materialized a stripe of queries at a time, then bf16
GEMMs), both bf16; fp32 on the TF32 routes above; `bwd_library` is the
routing rule.
When autograd needs a gradient through a
forward wrapper on the card, the wrapper goes through `_FlashAttention` (the
counterpart of the JAX ``custom_vjp``s ``_flash`` / ``_flash_packed``): its
forward also writes the row logsumexp and saves q, k, v, o and that LSE, and
its backward launches K4a and K4b.  Without a gradient no LSE is written.

The kernels size their tiles to shared memory and ignore the JAX block sizes;
of those only ``block_k >= S`` is read, to say which TPU kernel a flat call
stands for, so that each keeps its own launch count.  Each wrapper takes the
route its routing rule names for a CUDA tensor and raises on anything that
route does not take; for a CPU tensor it computes the plain PyTorch version
beside it (same exact softmax in fp32), which torch differentiates.

The short-K cross-attention kernel (K5) is csrc/crossk_attention.cu (wgmma,
TMA loads and stores, a persistent grid) behind ``crossk_attention_bhsd``,
the JAX entry point of the same name: an opt-in for callers with flat (BH,
Sq, D) layouts, as in JAX.  It also stands for K5's Pallas prototype S2
(``cross_shortk`` in scripts/attn_microbench3.py), which passes K/V already
padded to 128 rows.

The other Pallas prototypes are reached only by the attention
microbenchmarks (eta_inversion_tpu_torch/microbench), never by a served path:
``flash_attention_bhsd_tiled`` runs S1 (``flash`` in scripts/flash_sweep.py)
on the narrow kernel, its bf16 products on the bf16 mode's one tile
(NARROW_TILE) and its fp32-operand products, as those of S3 (``prod_flash``
in scripts/attn_multihead_bench.py), on the TF32 mode with bf16 operands;
``flash_attention_multihead`` is S4 (``v8_multihead`` there), one block per
(batch, 128 query rows) walking all heads (the narrow kernel's all-heads
block), with bf16 or, as the prototype, fp32 (TF32) products.

The dispatchers `attention` / `attention_packed` gate on device and shape, as
the JAX ones do: long self-attention on the card goes to the wrappers (which
route bf16 and fp32 and raise for another dtype), everything else (CPU
tensors, short-K cross-attention, short sequences) to `xla_attention`, the
plain path with the JAX package's ±80 clamped softmax.
"""

from __future__ import annotations

import ctypes
import math
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
    # of the K4a / K4b launches, the bf16 ones on flash_attention_bwd.cu
    # (head dims above 128); the others ran on flash_attention_bwd_narrow.cu
    "flash_attention_bwd_dq_wide": 0,
    "flash_attention_bwd_dkv_wide": 0,
    # of the forward launches (K1-K3 and S1 / S3's fp32 products), those on
    # the narrow kernel's TF32 mode, and its prep kernel's launches
    "flash_attention_narrow_tf32": 0,
    "flash_attention_tf32_prep": 0,
    # of the forward (K3) launches, the fp32 ones above head dim 128: one a
    # call of the route's kernels in flash_attention_bwd_tf32.cu (V^T prep,
    # then per query stripe the scores and the P V GEMM)
    "flash_attention_fwd_fp32": 0,
    # of the K4a / K4b launches, the fp32 ones: on the narrow backward's TF32
    # mode (head dims up to 128) and on flash_attention_bwd_tf32.cu (above
    # it), and the launches of their prep kernel
    "flash_attention_bwd_dq_tf32": 0,
    "flash_attention_bwd_dkv_tf32": 0,
    "flash_attention_bwd_dq_tf32_wide": 0,
    "flash_attention_bwd_dkv_tf32_wide": 0,
    "flash_attention_bwd_tf32_prep": 0,
    "crossk_attention": 0,
    # of the K5 calls, those on its TF32 mode (fp32), those in 128-key chunks
    # (bf16 above 256 keys), and those above its widest head dim, on the
    # forward kernels (flash_attention_wide.cu, or flash_attention_bwd_tf32.cu's
    # forward for fp32)
    "crossk_attention_tf32": 0,
    "crossk_attention_chunked": 0,
    "crossk_attention_wide": 0,
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
_LIBS = (("eti_flash_attention_bwd", ("flash_attention_bwd.cu",)),
         ("eti_crossk_attention", ("crossk_attention.cu",)),
         ("eti_flash_attention_wide", ("flash_attention_wide.cu",)),
         ("eti_flash_attention_narrow", ("flash_attention_narrow.cu",)),
         ("eti_flash_attention_bwd_narrow", ("flash_attention_bwd_narrow.cu",)),
         ("eti_flash_attention_bwd_tf32", ("flash_attention_bwd_tf32.cu",)))
_loaded: Optional[Dict[str, ctypes.CDLL]] = None


def build_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (at first use, one nvcc per source, side by side) and load the
    wide backward, short-K, wide forward, narrow forward, narrow backward and
    TF32 wide attention kernel libraries: {name in `_LIBS`: library}."""
    global _loaded
    if _loaded is None:
        from .cuda_build import load_libraries

        libs = dict(zip((name for name, _ in _LIBS), load_libraries(_LIBS)))
        bwd, crossk, wide, narrow, bwd_narrow, bwd_tf32 = libs.values()
        for fn in (wide.eti_flash_attention_wide_fwd, narrow.eti_flash_attention_narrow_fwd):
            fn.argtypes = [_ptr] * 5 + [_i32] * 5 + [_i64] * 14 + [ctypes.c_float, _ptr]
            fn.restype = _i32
        fn = narrow.eti_flash_attention_narrow_tf32_fwd
        fn.argtypes = [_ptr] * 5 + [_i32] * 7 + [_i64] * 11 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = narrow.eti_flash_attention_tf32_prep
        fn.argtypes = [_ptr] * 6 + [_i32] * 7 + [_i64] * 15 + [_ptr]
        fn.restype = _i32
        strides = ctypes.POINTER(_i64)
        for fn in (bwd_narrow.eti_flash_attention_bwd_narrow_dq,
                   bwd_narrow.eti_flash_attention_bwd_narrow_dkv):
            fn.argtypes = [_ptr] * 8 + [_i32] * 5 + [strides, ctypes.c_float, _ptr]
            fn.restype = _i32
        fn = bwd.eti_flash_attention_bwd_dq
        fn.argtypes = [_ptr] * 9 + [_i32] * 6 + [strides, ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = bwd.eti_flash_attention_bwd_dkv
        fn.argtypes = [_ptr] * 10 + [_i32] * 6 + [strides, ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = bwd_narrow.eti_flash_attention_bwd_narrow_tf32_dq
        fn.argtypes = [_ptr] * 8 + [_i32] * 6 + [strides, ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = bwd_narrow.eti_flash_attention_bwd_narrow_tf32_dkv
        fn.argtypes = [_ptr] * 10 + [_i32] * 6 + [strides, ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = bwd_narrow.eti_flash_attention_bwd_tf32_prep
        fn.argtypes = [_ptr] * 8 + [_i32] * 7 + [strides, _ptr]
        fn.restype = _i32
        fn = bwd_tf32.eti_flash_attention_bwd_tf32_scores
        fn.argtypes = [_i32] + [_ptr] * 8 + [_i32] * 8 + [strides, ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = bwd_tf32.eti_flash_attention_bwd_tf32_gemm
        fn.argtypes = [_i32] + [_ptr] * 6 + [_i32] * 7 + [strides, ctypes.c_float,
                                                           ctypes.c_float, _i32, _ptr]
        fn.restype = _i32
        fn = bwd_tf32.eti_flash_attention_fwd_tf32_pv
        fn.argtypes = [_ptr] * 5 + [_i32] * 6 + [strides] + [_i64] * 2 + [_ptr]
        fn.restype = _i32
        fn = crossk.eti_crossk_attention
        fn.argtypes = [_ptr] * 4 + [_i32] * 4 + [_i64] * 8 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = crossk.eti_crossk_attention_tf32
        fn.argtypes = [_ptr] * 4 + [_i32] * 5 + [_i64] * 6 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        fn = narrow.eti_flash_attention_narrow_heads_fwd
        fn.argtypes = [_ptr] * 4 + [_i32] * 7 + [_i64] * 8 + [ctypes.c_float, _ptr]
        fn.restype = _i32
        _loaded = libs
    return _loaded


# The kernels' own limits (csrc/flash_attention*.cu): head dim a multiple of
# 8 up to 512 forward and backward.  The forward takes d <= 128 on
# flash_attention_narrow.cu, bf16 or fp32 (its TF32 mode), with a positive
# scale (it folds the scale into the exponent's FFMA), and d in (128, 512]
# on flash_attention_wide.cu, bf16 (Q and two K/V stages take 192 KB at d =
# 512), or flash_attention_bwd_tf32.cu, fp32; the backward takes d <= 128 on
# flash_attention_bwd_narrow.cu (bf16, or fp32 on its TF32 mode) and d in
# (128, 512] on flash_attention_bwd.cu, bf16, or flash_attention_bwd_tf32.cu,
# fp32, both over scores materialized a stripe of queries at a time (a
# scratch of at most BWD_TF32_SCRATCH_BYTES).  The TF32 mode's
# bf16 operands and the multi-head kernel exist only where the
# microbenchmarks run them; their C entry points say which arguments they
# take (UNSUPPORTED otherwise).
KERNEL_MAX_HEAD_DIM = 512
# the widest head dim of the narrow forward and backward; above it the wide
# forward and flash_attention_bwd.cu (kNarrowMaxHeadDim in
# csrc/flash_common.cuh, which their entry points check)
NARROW_MAX_HEAD_DIM = 128
# the narrow kernel's bf16 tile, (query rows a block, keys a staged tile):
# the one tile of flash_attention_bhsd_tiled's bf16 products (S1) and of S4's
# all-heads block
NARROW_TILE = (128, 128)
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


BF16 = (torch.bfloat16,)
# the forward's operand types on the card: bf16, and fp32 on the TF32 mode
FWD_DTYPES = (torch.bfloat16, torch.float32)


def _check_operand(name: str, x: torch.Tensor, ndim: int, dtypes=BF16) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"{name}: kernel takes {names}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous, strides {x.stride()}")
    if any(s * x.element_size() % 16 for s in x.stride()[:-1]) or x.data_ptr() % 16:
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


def _check_qkv(q, k, v, heads: Optional[int], dtypes=BF16) -> None:
    """The forward kernels' operand checks: CUDA q, k, v of one of `dtypes`,
    all of q's, of matching shapes on one device."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, 3, dtypes)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of different dtypes: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


# the forward kernels' libraries (names in _LIBS)
NARROW_LIB, WIDE_LIB = "eti_flash_attention_narrow", "eti_flash_attention_wide"
# the narrow kernel's TF32 mode, a route of NARROW_LIB's library
NARROW_TF32 = "eti_flash_attention_narrow (tf32)"
# fp32 operands where the TF32 mode does not reach, the forward above head
# dim 128: materialized scores and a TF32 GEMM, a route of the library of
# the fp32 backward above 128 (BWD_TF32_LIB)
FWD_TF32_WIDE = "eti_flash_attention_bwd_tf32 (forward)"


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in FWD_DTYPES:
        raise ValueError(f"flash attention kernels take bfloat16 or float32, got {dtype}")


def fwd_library(d: int, tf32: bool = False, tile: Optional[Tuple[int, int]] = None,
                dtype: torch.dtype = torch.bfloat16) -> str:
    """The route a forward call of head dim `d` with operands of `dtype`
    takes on the card.  fp32 operands, or bf16 ones with `tf32` (S1 / S3's
    fp32 products), go to the narrow kernel's TF32 mode up to
    NARROW_MAX_HEAD_DIM; above it fp32 operands go to the forward of
    flash_attention_bwd_tf32.cu (FWD_TF32_WIDE).  bf16 goes to the wgmma
    kernel of its width, flash_attention_narrow.cu up to NARROW_MAX_HEAD_DIM
    and flash_attention_wide.cu above it; a chosen `tile` (S1's bf16
    products) must be the narrow kernel's, NARROW_TILE.  ValueError for what
    no kernel takes: another tile, a tile with TF32 products or above
    NARROW_MAX_HEAD_DIM, bf16 operands with `tf32` above it, another
    dtype."""
    _check_dtype(dtype)
    tf32 = tf32 or dtype == torch.float32
    if tile and (tf32 or d > NARROW_MAX_HEAD_DIM):
        raise ValueError(f"flash attention kernel: the kernel does not take head dim {d} "
                         f"with tile {tile} and {'fp32' if tf32 else 'bf16'} products")
    if tile and tuple(tile) != NARROW_TILE:
        raise ValueError(f"flash attention kernel: the kernel does not take tile {tile}, its "
                         f"tile is {NARROW_TILE} (query rows a block, keys a staged tile)")
    if d > NARROW_MAX_HEAD_DIM:
        if dtype == torch.float32:
            return FWD_TF32_WIDE
        if tf32:
            raise ValueError(f"flash attention kernel: the kernel does not take head dim {d} "
                             "with fp32 products of bfloat16 operands")
        return WIDE_LIB
    return NARROW_TF32 if tf32 else NARROW_LIB


# the backward kernels' libraries (names in _LIBS)
BWD_LIB, BWD_NARROW_LIB = "eti_flash_attention_bwd", "eti_flash_attention_bwd_narrow"
# fp32 operands: the narrow backward's TF32 mode (a route of BWD_NARROW_LIB's
# library) and, above head dim 128, the materialized-score TF32 kernels
BWD_NARROW_TF32 = "eti_flash_attention_bwd_narrow (tf32)"
BWD_TF32_LIB = "eti_flash_attention_bwd_tf32"
BWD_TF32_ROUTES = (BWD_NARROW_TF32, BWD_TF32_LIB)


def bwd_library(d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The route a backward call (K4a and K4b) of head dim `d` with operands
    of `dtype` takes on the card: up to NARROW_MAX_HEAD_DIM the wgmma kernels
    of flash_attention_bwd_narrow.cu, bf16 or (fp32) their TF32 mode; above
    it, up to KERNEL_MAX_HEAD_DIM, flash_attention_bwd.cu for bf16 and
    flash_attention_bwd_tf32.cu for fp32.  ValueError beyond
    KERNEL_MAX_HEAD_DIM or for another dtype."""
    if d > KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the backward kernels take multiples of 8 up to "
                         f"{KERNEL_MAX_HEAD_DIM}")
    _check_dtype(dtype)
    if dtype == torch.float32:
        return BWD_NARROW_TF32 if d <= NARROW_MAX_HEAD_DIM else BWD_TF32_LIB
    return BWD_NARROW_LIB if d <= NARROW_MAX_HEAD_DIM else BWD_LIB


def _fwd_launch(q, k, v, scale: float, heads: Optional[int], need_lse: bool,
                tf32: bool = False, tile: Optional[Tuple[int, int]] = None,
                counter: Optional[str] = None):
    """Take the forward route that `fwd_library` names for CUDA q, k, v of
    q's dtype; returns (o, lse or None), lse fp32 (B, H, S) packed or (BH, 1,
    S) flat, the JAX layouts.  `tf32` and `tile` where the route takes them
    (ValueError otherwise).  A kernel's launch counts on `counter` (when
    given).  No other route is tried."""
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    route = fwd_library(d, tf32, tile, q.dtype)
    if route == NARROW_TF32:
        out = _tf32_launch(q, k, v, scale, heads, need_lse)
    elif route == FWD_TF32_WIDE:
        out = _tf32_wide_launch(q, k, v, scale, heads, need_lse)
    else:
        out = _kernel_launch(q, k, v, scale, heads, need_lse, route)
    if counter is not None:
        LAUNCHES[counter] += 1
    return out


def _kernel_launch(q, k, v, scale: float, heads: Optional[int], need_lse: bool, route: str):
    """The bf16 forward on the library `route` names: NARROW_LIB or
    WIDE_LIB."""
    batch, h, d = _layout(q, heads)
    _check_qkv(q, k, v, heads)
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse, lse_st = _lse_out(q, heads, batch, h, sq, need_lse)
    flat = [s for x in (q, k, v, o) for s in _strides(x, heads, d)]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build_kernels()[route]
    fn = (lib.eti_flash_attention_narrow_fwd if route == NARROW_LIB
          else lib.eti_flash_attention_wide_fwd)
    err = fn(*ptrs, batch, h, sq, sk, d, *flat, *lse_st, float(scale), stream)
    if err:  # the message is built only for a refused launch (a hot path)
        _launched(err, f"flash attention kernel ({route})",
                  f"head dim {d}, scale {scale} with strides "
                  f"{[x.stride() for x in (q, k, v)]}")
    return o, lse


def _lse_out(q, heads: Optional[int], batch: int, h: int, sq: int, need_lse: bool):
    """(the LSE output or None, its (batch, head) element strides)."""
    if not need_lse:
        return None, (0, 0)
    lse = torch.empty((batch, h, sq) if heads else (batch, 1, sq), dtype=torch.float32,
                      device=q.device)
    return lse, (h * sq, sq)


# the head dims, padded to 16, at which the TF32 mode takes bf16 operands
# (and writes a bf16 o): the microbenchmarks' d = 40 and 128
TF32_BF16_HEAD_DIMS = (48, 128)


def _tf32_launch(q, k, v, scale: float, heads: Optional[int], need_lse: bool):
    """The narrow kernel's TF32 mode: the prep kernel, then the forward on
    fp32 q, k (widened when bf16) and the prep's V^T; o in q's dtype."""
    batch, h, d = _layout(q, heads)
    _check_qkv(q, k, v, heads, FWD_DTYPES)  # CUDA tensors: the prep's CPU branch is plain
    if q.dtype == torch.bfloat16 and -(-d // 16) * 16 not in TF32_BF16_HEAD_DIMS:
        raise ValueError(f"flash attention kernel (TF32 mode): the kernel does not take head "
                         f"dim {d} with bfloat16 operands")
    qf, kf, vt = flash_attention_tf32_prep(q, k, v, heads)
    sq, sk = q.shape[1], k.shape[1]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse, lse_st = _lse_out(q, heads, batch, h, sq, need_lse)
    flat = [s for x in (qf, kf, o) for s in _strides(x, heads, d)]
    err = build_kernels()[NARROW_LIB].eti_flash_attention_narrow_tf32_fwd(
        qf.data_ptr(), kf.data_ptr(), vt.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), batch, h, sq, sk, d, vt.shape[-1],
        int(q.dtype == torch.bfloat16), *flat, *lse_st, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _launched(err, "flash attention kernel (TF32 mode)",
                  f"head dim {d} with {q.dtype} operands, scale {scale}, strides "
                  f"{[x.stride() for x in (q, k)]}")
    LAUNCHES["flash_attention_narrow_tf32"] += 1
    return o, lse


# The order in which the TF32 mode's V^T holds each group of 8 keys.  A
# thread's score accumulators of an n8 chunk hold keys {2 t, 2 t + 1} (t =
# lane % 4); the A fragment of a TF32 wgmma step holds its k-columns {t, t +
# 4}.  With V^T's k-rows in this order the accumulators are the A fragment.
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def round_tf32_plain(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest with ties away from
    zero (cvt.rna.tf32.f32); infinities and NaN as they are."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def tf32_transpose_plain(x, heads: Optional[int] = None):
    """x (flat (BH, S, d), or packed with `heads`) as the TF32 kernels' B
    operand: fp32 (BH, d, Spad), Spad = S rounded up to 8, each 8-element
    group along S in TF32_KEY_ORDER, zero past S, rounded to TF32."""
    xf = x if heads is None else _packed_to_flat(x, heads)
    bh, s, d = xf.shape
    spad = -(-s // 8) * 8
    xt = torch.zeros((bh, spad, d), dtype=torch.float32, device=x.device)
    xt[:, :s] = xf.float()
    order = torch.tensor(TF32_KEY_ORDER, device=x.device)
    xt = xt.view(bh, spad // 8, 8, d)[:, :, order].reshape(bh, spad, d)
    return round_tf32_plain(xt.transpose(1, 2).contiguous())


def tf32_prep_plain(q, k, v, heads: Optional[int] = None):
    """The prep kernel's function: (q, k as fp32, V^T) with V^T fp32 (BH, d,
    Spad), Spad = Sk rounded up to 8, each 8-key group in TF32_KEY_ORDER,
    zero past Sk, rounded to TF32 (`tf32_transpose_plain`).  fp32 q and k
    come back as they are."""
    vt = tf32_transpose_plain(v, heads)
    if q.dtype == torch.float32:
        return q, k, vt
    return q.float(), k.float(), vt


def flash_attention_tf32_prep(q, k, v, heads: Optional[int] = None):
    """The TF32 mode's operands from q, k, v (flat, or packed with `heads`):
    (q, k as fp32: themselves when fp32, widened copies in their layout when
    bf16; V^T as `tf32_prep_plain` gives it).  On the card the prep kernel
    (csrc/flash_attention_narrow.cu) writes them; it takes bf16 or fp32
    operands of a head dim that is a multiple of 8 up to 128 and raises
    otherwise.  A CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return tf32_prep_plain(q, k, v, heads)
    batch, h, d = _layout(q, heads)
    _check_head_dim(d, NARROW_MAX_HEAD_DIM)
    _check_qkv(q, k, v, heads, FWD_DTYPES)
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    spad = -(-sk // 8) * 8
    vt = torch.empty((batch * h, d, spad), dtype=torch.float32, device=q.device)
    widen = q.dtype == torch.bfloat16
    qf, kf = ((torch.empty(x.shape, dtype=torch.float32, device=q.device) for x in (q, k))
              if widen else (q, k))
    strides = [s for x in (q, k, v, qf, kf) for s in _strides(x, heads, d)]
    err = build_kernels()[NARROW_LIB].eti_flash_attention_tf32_prep(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qf.data_ptr() if widen else None,
        kf.data_ptr() if widen else None, vt.data_ptr(), batch, h, sq, sk, d, spad, int(widen),
        *strides, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _launched(err, "TF32 prep kernel", f"head dim {d} with {q.dtype} operands")
    LAUNCHES["flash_attention_tf32_prep"] += 1
    return qf, kf, vt


# ---------------------------------------------------------------------------
# fp32 above head dim 128: K3 on materialized scores (flash_attention_bwd_tf32.cu)
# ---------------------------------------------------------------------------

def fwd_tf32_stripe(sq: int, sk: int, bh: int) -> int:
    """Queries a stripe of the fp32 forward above head dim 128 holds: its
    (BH, stripe, Sk) fp32 scores within BWD_TF32_SCRATCH_BYTES, sized as
    `bwd_tf32_stripe` sizes one score array."""
    return bwd_tf32_stripe(sq, sk, bh, 1)


def _tf32_wide_launch(q, k, v, scale: float, heads: Optional[int], need_lse: bool):
    """K3 for fp32 operands above head dim 128 (FWD_TF32_WIDE): V^T from the
    fp32 backward's prep kernel (as `tf32_transpose_plain` gives it), then
    per query stripe the scores kernel's forward mode (the scores in the
    log2 domain and each row's partials per 128-key tile) and the TF32 GEMM
    O = P V, which merges the partials into L (the LSE) and forms P =
    exp2(S - L) into its A fragments.  One count of flash_attention_fwd_fp32
    a call."""
    batch, h, d = _layout(q, heads)
    _check_qkv(q, k, v, heads, (torch.float32,))
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    bh, skpad = batch * h, -(-sk // 8) * 8
    vt = _bwd_tf32_prep_launch(q, v, q, None, heads, kt=True, qdot=False)[0]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse, lse_st = _lse_out(q, heads, batch, h, sq, need_lse)
    stripe = fwd_tf32_stripe(sq, sk, bh)
    scores = torch.empty((bh, stripe, skpad), dtype=torch.float32, device=q.device)
    part = torch.empty((bh, stripe, -(-skpad // BWD_TF32_TILE), 2), dtype=torch.float32,
                       device=q.device)
    strides = _bwd_strides((q, k, None, o, None, None, None, None), heads, d, lse_st)
    c_st = (ctypes.c_longlong * 3)(*_strides(o, heads, d))
    lse_ptr = None if lse is None else lse.data_ptr()
    lib = build_kernels()[BWD_TF32_LIB]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for start in range(0, sq, stripe):
        count = min(stripe, sq - start)
        o_rows = o.data_ptr() + start * o.stride(1) * o.element_size()
        err = lib.eti_flash_attention_bwd_tf32_scores(
            2, q.data_ptr(), k.data_ptr(), None, None, None, None, scores.data_ptr(),
            part.data_ptr(), batch, h, sq, sk, d, start, count, skpad, strides, float(scale),
            stream)
        if not err:
            err = lib.eti_flash_attention_fwd_tf32_pv(
                scores.data_ptr(), part.data_ptr(), vt.data_ptr(), o_rows, lse_ptr, batch, h,
                count, d, skpad, start, c_st, *lse_st, stream)
        if err:
            _launched(err, f"flash attention kernel ({FWD_TF32_WIDE})",
                      f"head dim {d}, scale {scale} with strides "
                      f"{[x.stride() for x in (q, k, v)]}")
    LAUNCHES["flash_attention_fwd_fp32"] += 1
    return o, lse


def flash_attention_fwd_striped_plain(q, k, v, scale: float, stripe: int):
    """The arithmetic of the fp32 forward above head dim 128
    (flash_attention_bwd_tf32.cu) in plain fp32 over flat (BH, S, D)
    operands, without its TF32 roundings: a stripe of `stripe` query rows at
    a time, the scores in the log2 domain with each 8-key group in
    TF32_KEY_ORDER (-inf past Sk, up to Sk rounded up to 8), each row's
    (max, sum of exp2) over each BWD_TF32_TILE keys merged into L, P =
    exp2(S - L), and O = P V^T with V^T in the same key order.  Returns (o,
    lse (BH, 1, S)), `_flash_fwd_impl`'s contract."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    bh, sq, d = qf.shape
    sk = kf.shape[1]
    skpad = -(-sk // 8) * 8
    ntiles = -(-skpad // BWD_TF32_TILE)
    dev = qf.device
    order = torch.tensor(TF32_KEY_ORDER, device=dev)
    perm = torch.arange(skpad, device=dev) // 8 * 8 + order.repeat(skpad // 8)  # position -> key
    vt = torch.zeros((bh, skpad, d), device=dev)
    vt[:, :sk] = vf
    vt = vt[:, perm].transpose(1, 2)
    o = torch.empty((bh, sq, d), device=dev)
    lse = torch.empty((bh, sq), device=dev)
    for start in range(0, sq, stripe):
        rows = slice(start, start + stripe)
        n = qf[:, rows].shape[1]
        s2 = torch.full((bh, n, ntiles * BWD_TF32_TILE), -torch.inf, device=dev)
        s2[..., :sk] = torch.einsum("bqd,bkd->bqk", qf[:, rows], kf) * (scale * LOG2E)
        s2[..., :skpad] = s2[..., perm]
        tiles = s2.view(bh, n, ntiles, BWD_TF32_TILE)
        m = tiles.amax(-1)
        l = torch.exp2(tiles - m[..., None]).sum(-1)  # noqa: E741
        top = m.amax(-1)
        l2 = top + torch.log2((l * torch.exp2(m - top[..., None])).sum(-1))
        p = torch.exp2(s2[..., :skpad] - l2[..., None])
        o[:, rows] = torch.einsum("bqk,bdk->bqd", p, vt)
        lse[:, rows] = l2 / LOG2E
    return o, lse[:, None, :]


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


def _fwd_plain(q, k, v, scale: float, heads: Optional[int], need_lse: bool):
    """The plain forward with the LSE when asked, flat (heads None) or
    packed: the forward wrappers' CPU branch."""
    if heads is None:
        o = flash_attention_bhsd_plain(q, k, v, scale)
        return o, attention_lse_plain(q, k, scale) if need_lse else None
    o = flash_attention_packed_plain(q, k, v, scale, heads)
    lse = None
    if need_lse:
        lse = attention_lse_plain(_packed_to_flat(q, heads), _packed_to_flat(k, heads),
                                  scale).reshape(q.shape[0], heads, -1)
    return o, lse


def flash_attention_bhsd_fwd(q, k, v, scale: float, block_k: int = 512,
                             need_lse: bool = False):
    """The flat forward (K2 when block_k >= S, else K3) with the LSE when
    asked, (o, lse (BH, 1, S) fp32 or None): `_flash_fwd_impl`'s contract."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, scale, None, need_lse)
    return _fwd_launch(q, k, v, scale, None, need_lse,
                       counter=_bhsd_counter(block_k, k.shape[1]))


def flash_attention_packed_fwd(q, k, v, scale: float, heads: int, need_lse: bool = False):
    """The packed forward (K1) with the LSE when asked, (o, lse (B, H, S)
    fp32 or None): `_packed_fwd_impl`'s contract."""
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, scale, heads, need_lse)
    return _fwd_launch(q, k, v, scale, heads, need_lse, counter="flash_attention_packed")


def _bhsd_counter(block_k: int, sk: int) -> str:
    return ("flash_attention_bhsd_onepass" if block_k >= sk
            else "flash_attention_bhsd_blockwise")


def flash_attention_bhsd(q, k, v, scale: float, block_q: int = 512,
                         block_k: int = 512):
    """Flash attention over flat (BH, S, D) inputs.  block_k >= S stands for
    the TPU's one-pass kernel (K2), block_k < S for its blockwise kernel (K3);
    on Hopper both take the route of the head dim and dtype (`fwd_library`),
    and block_q is ignored.
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
    """K3's function over flat (BH, S, D) bf16 inputs with the products of
    the Pallas prototypes S1 and S3.  operands "bf16": S1's bf16 products
    (mm_bf16=True) on the narrow kernel's bf16 mode, the route of K1-K3 up
    to head dim 128, with its one tile, `tile` (query rows a block, keys a
    staged tile) NARROW_TILE or None for it (on the card another tile is
    refused).  "fp32": fp32 Q, K, P and V contracted on the TF32 tensor
    cores, the products of S1 (mm_bf16=False) and S3, on the narrow
    kernel's TF32 mode, whose tiles are its own (on the card a `tile` is
    refused).  For the attention microbenchmarks (counted apart from K2 /
    K3: no served path launches it); no gradient.  On the card it takes
    bf16, bf16 products at every head dim up to 128 and fp32 products only
    at the microbenchmarks' head dims (40 native and padded to 128: d of
    33-48 or 113-128), and raises otherwise.  A CPU tensor takes the plain
    version (fp32 einsums)."""
    if operands not in ("bf16", "fp32"):
        raise ValueError(f"operands {operands!r}: 'bf16' or 'fp32'")
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, scale)
    tf32 = operands == "fp32"
    if tf32 and tile is not None:
        raise ValueError(f"the TF32 mode (operands 'fp32') does not take a tile, {tile}: "
                         "its tiles are its own")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"the microbenchmarks' kernels take bfloat16, got {q.dtype}")
    o, _ = _fwd_launch(q, k, v, scale, None, False, tf32=tf32, tile=tile,
                       counter="flash_attention_bhsd_tf32" if tf32 else "flash_attention_bhsd_tiled")
    return o


# S4's all-heads block (the narrow kernel's HEADS mode): (query rows a
# block, keys a staged tile), the one tile it has
MULTIHEAD_TILE = NARROW_TILE


def flash_attention_multihead(q, k, v, scale: float, heads: int, operands: str = "bf16",
                              tile: Optional[Tuple[int, int]] = None):
    """K1's function over packed (B, S, H*D) inputs, as the Pallas prototype
    S4 computes it: one block per (batch, 128 query rows) walks all heads
    (the all-heads block of flash_attention_narrow.cu), its ring of K / V
    tiles running on from one head to the next.  operands "bf16" are K1's
    products, "fp32" the prototype's own: the TF32 mode, after its prep
    kernel (q, k widened, V^T).  `tile` is (query rows a block, keys a
    staged tile): the block has MULTIHEAD_TILE only, None for it.  For the
    attention microbenchmarks (no served path launches it); no gradient.  On
    the card it takes bf16, the microbenchmarks' head dim (d of 33-48: SD's
    40) with any number of heads, and raises otherwise (another tile too); a
    CPU tensor takes the plain version."""
    if operands not in ("bf16", "fp32"):
        raise ValueError(f"operands {operands!r}: 'bf16' or 'fp32'")
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, scale, heads)
    if tile is not None and tuple(tile) != MULTIHEAD_TILE:
        raise ValueError(f"multi-head attention kernel: the kernel does not take tile {tile}, "
                         f"its block is {MULTIHEAD_TILE} (query rows, keys a staged tile)")
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    _check_qkv(q, k, v, heads)
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, 1, sq, sk)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    tf32 = operands == "fp32"
    if tf32:
        qf, kf, vt = flash_attention_tf32_prep(q, k, v, heads)
        ops, spad, v_st = (qf, kf, vt), vt.shape[-1], (0, 0)
    else:
        ops, spad, v_st = (q, k, v), 0, (v.stride(0), v.stride(1))
    err = build_kernels()[NARROW_LIB].eti_flash_attention_narrow_heads_fwd(
        *(x.data_ptr() for x in ops), o.data_ptr(), batch, h, sq, sk, d, spad, int(tf32),
        ops[0].stride(0), ops[0].stride(1), ops[1].stride(0), ops[1].stride(1), *v_st,
        o.stride(0), o.stride(1), float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _launched(err, "multi-head attention kernel",
                  f"{h} heads of d={d} with {operands} operands, scale {scale}")
    LAUNCHES["flash_attention_multihead_tf32" if tf32 else "flash_attention_multihead"] += 1
    return o


def _bwd_prepare(q, k, v, lse, do, heads: Optional[int], lib: str):
    """Checks shared by K4a and K4b on the route `lib` (fp32 operands on the
    TF32 routes, bf16 on the others); returns (batch, heads, d, sq, sk)."""
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    dtypes = (torch.float32,) if lib in BWD_TF32_ROUTES else BF16
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, x, 3, dtypes)
    if k.shape != v.shape or do.shape != q.shape or k.shape[0] != batch \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} do{tuple(do.shape)} heads={heads}")
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    _check_rows("lse", lse, batch * h, sq)
    return batch, h, d, sq, sk


def _bwd_strides(xs, heads, d, lse_st=(0, 0)):
    """The kernels' 26 strides: (batch, head, row) of q, k, v, o, dO, dQ, dK,
    dV (None: unused), then the lse's (batch, head)."""
    flat = []
    for x in xs:
        flat += [0, 0, 0] if x is None else list(_strides(x, heads, d))
    return (ctypes.c_longlong * 26)(*flat, *lse_st)


def _bwd_route(q, heads: Optional[int]) -> Optional[str]:
    """The backward library of a call (`bwd_library`), None for a CPU tensor
    (the plain version)."""
    if q.device.type == "cpu":
        return None
    return bwd_library(_layout(q, heads)[2], q.dtype)


# of a backward route's launches, the LAUNCHES key that counts them apart
_BWD_SUBSET = {BWD_LIB: "wide", BWD_NARROW_TF32: "tf32", BWD_TF32_LIB: "tf32_wide"}


def _count_bwd(which: str, lib: str) -> None:
    LAUNCHES[f"flash_attention_bwd_{which}"] += 1
    if lib in _BWD_SUBSET:
        LAUNCHES[f"flash_attention_bwd_{which}_{_BWD_SUBSET[lib]}"] += 1


def bwd_tf32_prep_plain(q, k, do, o=None, heads: Optional[int] = None):
    """The TF32 backward's prep kernel's function: (K^T (BH, d, Skpad), Q^T,
    dO^T (BH, d, Sqpad), D (BH, Sq) or None without `o`), the transposes as
    `tf32_transpose_plain` writes them (each 8-element group along S in
    TF32_KEY_ORDER, zero past S, rounded to TF32), D = rowsum(dO o O) in
    fp32."""
    dvec = None
    if o is not None:
        f = (lambda x: x) if heads is None else (lambda x: _packed_to_flat(x, heads))
        dvec = (f(do).float() * f(o).float()).sum(-1)
    return (tf32_transpose_plain(k, heads), tf32_transpose_plain(q, heads),
            tf32_transpose_plain(do, heads), dvec)


def flash_attention_bwd_tf32_prep(q, k, do, o=None, heads: Optional[int] = None,
                                  kt: bool = True, qdot: bool = True):
    """The fp32 backward's operands from fp32 q, k, dO (flat, or packed with
    `heads`): (K^T when `kt`, Q^T and dO^T when `qdot`, D when `o` is given;
    None for the others), as `bwd_tf32_prep_plain` gives them.  On the card
    one launch of the prep kernel (csrc/flash_attention_bwd_narrow.cu)
    writes them all, for the backward's TF32 routes at every head dim (a
    multiple of 8 up to 512); it raises for what it does not take.  A CPU
    tensor takes the plain version."""
    if q.device.type == "cpu":
        out = bwd_tf32_prep_plain(q, k, do, o, heads)
        return (out[0] if kt else None, out[1] if qdot else None,
                out[2] if qdot else None, out[3])
    out = _bwd_tf32_prep_launch(q, k, do, o, heads, kt, qdot)
    LAUNCHES["flash_attention_bwd_tf32_prep"] += 1
    return out


def _bwd_tf32_prep_launch(q, k, do, o, heads: Optional[int], kt: bool, qdot: bool):
    """flash_attention_bwd_tf32_prep's launch on the card, not counted: the
    fp32 forward above head dim 128 also takes its V^T from it (the K^T
    slot) and counts it among its own kernels."""
    batch, h, d = _layout(q, heads)
    _check_head_dim(d)
    f32 = (torch.float32,)
    for name, x in (("q", q), ("k", k), ("do", do)) + ((("o", o),) if o is not None else ()):
        _check_operand(name, x, 3, f32)
    if do.shape != q.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or (o is not None and o.shape != q.shape):
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"do{tuple(do.shape)} heads={heads}")
    sq, sk = q.shape[1], k.shape[1]
    _check_grid(batch, h, sq, sk)
    sqpad, skpad = -(-sq // 8) * 8, -(-sk // 8) * 8
    new = lambda n: torch.empty((batch * h, d, n), dtype=torch.float32, device=q.device)  # noqa: E731
    kt_ = new(skpad) if kt else None
    qt_, dot_ = (new(sqpad), new(sqpad)) if qdot else (None, None)
    dvec = torch.empty((batch * h, sq), dtype=torch.float32, device=q.device) \
        if o is not None else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = build_kernels()[BWD_NARROW_LIB].eti_flash_attention_bwd_tf32_prep(
        q.data_ptr(), k.data_ptr(), do.data_ptr(), ptr(o), ptr(kt_), ptr(qt_), ptr(dot_),
        ptr(dvec), batch, h, sq, sk, d, sqpad, skpad,
        _bwd_strides((q, k, None, o, do, None, None, None), heads, d),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        _launched(err, "TF32 backward prep kernel", f"head dim {d}")
    return kt_, qt_, dot_, dvec


# the scratch a backward call above head dim 128 may hold, fp32 on
# flash_attention_bwd_tf32.cu and bf16 on flash_attention_bwd.cu: the scores
# of a stripe of queries (K4a's dS, K4b's P^T and dS^T)
BWD_TF32_SCRATCH_BYTES = 128 << 20
# the kernels' score tile: stripes are a multiple of it
BWD_TF32_TILE = 128


def bwd_tf32_stripe(sq: int, sk: int, bh: int, arrays: int, elem_bytes: int = 4) -> int:
    """Queries a stripe of the backward above head dim 128 holds: `arrays`
    (BH, stripe, Sk) score arrays of `elem_bytes` elements (4: fp32 on
    flash_attention_bwd_tf32.cu, 2: bf16 on flash_attention_bwd.cu) within
    BWD_TF32_SCRATCH_BYTES, a multiple of BWD_TF32_TILE (at least one), at
    most Sq."""
    per_query = bh * (-(-sk // 8) * 8) * elem_bytes * arrays
    stripe = BWD_TF32_SCRATCH_BYTES // per_query // BWD_TF32_TILE * BWD_TF32_TILE
    return min(max(stripe, BWD_TF32_TILE), sq)


def flash_attention_bwd_striped_plain(q, k, v, o, lse, do, scale: float, stripe: int,
                                      bf16_scores: bool = False):
    """The arithmetic of the backward above head dim 128 in plain fp32 over
    flat (BH, S, D) operands: dQ a stripe of `stripe` query rows at a time,
    dK and dV the stripes' contributions summed in stripe order (fp32
    results).  With `bf16_scores`, flash_attention_bwd.cu's: P and dS (from
    the fp32 P) rounded to bf16 before the output products; otherwise
    flash_attention_bwd_tf32.cu's, less its TF32 rounding."""
    rnd = (lambda x: x.bfloat16().float()) if bf16_scores else (lambda x: x)  # noqa: E731
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    bh, sq, _ = qf.shape
    dvec = (dof * o.float()).sum(-1)
    lse = lse.reshape(bh, sq)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for start in range(0, sq, stripe):
        rows = slice(start, start + stripe)
        s = torch.einsum("bqd,bkd->bqk", qf[:, rows], kf) * scale
        p = torch.exp(s - lse[:, rows, None])
        dp = torch.einsum("bqd,bkd->bqk", dof[:, rows], vf)
        ds = rnd(p * (dp - dvec[:, rows, None]))
        dq[:, rows] = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
        dv = dv + torch.einsum("bqk,bqd->bkd", rnd(p), dof[:, rows])
        dk = dk + torch.einsum("bqk,bqd->bkd", ds, qf[:, rows]) * scale
    return dq, dk, dv


def _check_prep(name: str, x, rows: int, d: int, n: int) -> None:
    """A transposed operand handed in by flash_attention_bwd: (rows, d, n)
    contiguous fp32 on the card."""
    if x is None or not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous() \
            or tuple(x.shape) != (rows, d, n):
        raise ValueError(f"{name}: expected a contiguous CUDA fp32 tensor of "
                         f"{(rows, d, n)}, got {None if x is None else tuple(x.shape)}")


def _bwd_dq_tf32(q, k, v, o, lse, do, scale, heads, lib, prep):
    """K4a on the TF32 routes: the prep (K^T and D; given by
    flash_attention_bwd as `prep`), then the narrow TF32 kernel, or above
    head dim 128 a scores kernel and a GEMM per query stripe."""
    batch, h, d, sq, sk = _bwd_prepare(q, k, v, lse, do, heads, lib)
    _check_operand("o", o, 3, (torch.float32,))
    if o.shape != q.shape:
        raise ValueError(f"o{tuple(o.shape)} does not match q{tuple(q.shape)}")
    kt, _, _, dvec = prep if prep is not None else flash_attention_bwd_tf32_prep(
        q, k, do, o, heads, qdot=False)
    skpad = -(-sk // 8) * 8
    _check_prep("K^T", kt, batch * h, d, skpad)
    _check_rows("dvec", dvec, batch * h, sq)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = _bwd_strides((q, k, v, None, do, dq, None, None), heads, d, (h * sq, sq))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    libs = build_kernels()
    what = f"flash attention dQ kernel ({lib})"
    args = f"head dim {d}, scale {scale} with strides {[x.stride() for x in (q, k, v)]}"
    if lib == BWD_NARROW_TF32:
        err = libs[BWD_NARROW_LIB].eti_flash_attention_bwd_narrow_tf32_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), kt.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), batch, h, sq, sk, d, skpad,
            strides, float(scale), stream)
        if err:
            _launched(err, what, args)
    else:
        stripe = bwd_tf32_stripe(sq, sk, batch * h, 1)
        ds = torch.empty((batch * h, stripe, skpad), dtype=torch.float32, device=q.device)
        c_st = (ctypes.c_longlong * 6)(*_strides(dq, heads, d), 0, 0, 0)
        for start in range(0, sq, stripe):
            count = min(stripe, sq - start)
            err = libs[BWD_TF32_LIB].eti_flash_attention_bwd_tf32_scores(
                0, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dvec.data_ptr(), ds.data_ptr(), None, batch, h, sq, sk, d, start, count, skpad,
                strides, float(scale), stream)
            if not err:
                err = libs[BWD_TF32_LIB].eti_flash_attention_bwd_tf32_gemm(
                    1, ds.data_ptr(), kt.data_ptr(),
                    dq.data_ptr() + start * dq.stride(1) * dq.element_size(), None, None, None,
                    batch, h, count, d, skpad, skpad, 0, c_st, float(scale), 0.0, 0, stream)
            if err:
                _launched(err, what, args)
    _count_bwd("dq", lib)
    return dq, dvec


def _bwd_dkv_tf32(q, k, v, lse, do, dvec, scale, heads, lib, prep):
    """K4b on the TF32 routes: the prep (Q^T and dO^T; given by
    flash_attention_bwd as `prep`), then the narrow TF32 kernel, or above
    head dim 128 a scores kernel and one launch of the GEMM (dV and dK) per
    query stripe, each stripe added to the last."""
    batch, h, d, sq, sk = _bwd_prepare(q, k, v, lse, do, heads, lib)
    _check_rows("dvec", dvec, batch * h, sq)
    _, qt, dot, _ = prep if prep is not None else flash_attention_bwd_tf32_prep(
        q, k, do, None, heads, kt=False)
    sqpad = -(-sq // 8) * 8
    _check_prep("Q^T", qt, batch * h, d, sqpad)
    _check_prep("dO^T", dot, batch * h, d, sqpad)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = _bwd_strides((q, k, v, None, do, None, dk, dv), heads, d, (h * sq, sq))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    libs = build_kernels()
    what = f"flash attention dK/dV kernel ({lib})"
    args = f"head dim {d}, scale {scale} with strides {[x.stride() for x in (q, k, v)]}"
    if lib == BWD_NARROW_TF32:
        err = libs[BWD_NARROW_LIB].eti_flash_attention_bwd_narrow_tf32_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), qt.data_ptr(),
            dot.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            batch, h, sq, sk, d, sqpad, strides, float(scale), stream)
        if err:
            _launched(err, what, args)
    else:
        stripe = bwd_tf32_stripe(sq, sk, batch * h, 2)
        pitch = -(-stripe // 8) * 8
        pt, dst = (torch.empty((batch * h, sk, pitch), dtype=torch.float32, device=q.device)
                   for _ in range(2))
        c_st = (ctypes.c_longlong * 6)(*_strides(dv, heads, d), *_strides(dk, heads, d))
        for start in range(0, sq, stripe):
            count = min(stripe, sq - start)
            width = -(-count // 8) * 8
            err = libs[BWD_TF32_LIB].eti_flash_attention_bwd_tf32_scores(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dvec.data_ptr(), pt.data_ptr(), dst.data_ptr(), batch, h, sq, sk, d, start,
                count, width, strides, float(scale), stream)
            if not err:
                err = libs[BWD_TF32_LIB].eti_flash_attention_bwd_tf32_gemm(
                    2, pt.data_ptr(), dot.data_ptr(), dv.data_ptr(), dst.data_ptr(),
                    qt.data_ptr(), dk.data_ptr(), batch, h, sk, d, width, sqpad, start, c_st,
                    1.0, float(scale), int(start > 0), stream)
            if err:
                _launched(err, what, args)
    _count_bwd("dkv", lib)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, scale: float, heads: Optional[int] = None,
                           prep=None):
    """K4a: (dQ, D) -- dQ in q's layout, D = rowsum(dO o O) as (BH, S) fp32
    for K4b.  Flat (BH, S, D) operands with a (BH, 1, S) LSE when `heads` is
    None, packed (B, S, H*D) with a (B, H, S) LSE otherwise (the forward's
    LSE layouts).  fp32 runs on the TF32 routes after the prep kernel
    (`prep`: its outputs, when the caller launched it)."""
    lib = _bwd_route(q, heads)
    if lib is None:
        if heads is None:
            return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
        f = [_packed_to_flat(x, heads) for x in (q, k, v, o, do)]
        dq, dvec = flash_attention_bwd_dq_plain(*f[:4], lse, f[4], scale)
        return _flat_to_packed(dq, q.shape[0], heads), dvec
    if lib in BWD_TF32_ROUTES:
        return _bwd_dq_tf32(q, k, v, o, lse, do, scale, heads, lib, prep)
    batch, h, d, sq, sk = _bwd_prepare(q, k, v, lse, do, heads, lib)
    _check_operand("o", o, 3, (q.dtype,))
    if o.shape != q.shape:
        raise ValueError(f"o{tuple(o.shape)} does not match q{tuple(q.shape)}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dvec = torch.empty((batch * h, sq), dtype=torch.float32, device=q.device)
    strides = _bwd_strides((q, k, v, o, do, dq, None, None), heads, d, (h * sq, sq))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dq.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if lib == BWD_NARROW_LIB:
        err = build_kernels()[lib].eti_flash_attention_bwd_narrow_dq(
            *ptrs, batch, h, sq, sk, d, strides, float(scale), stream)
    else:  # dS of a stripe of queries at a time in a bf16 scratch
        stripe = bwd_tf32_stripe(sq, sk, batch * h, 1, elem_bytes=2)
        scratch = torch.empty((batch * h, stripe, -(-sk // 8) * 8), dtype=torch.bfloat16,
                              device=q.device)
        err = build_kernels()[lib].eti_flash_attention_bwd_dq(
            *ptrs, scratch.data_ptr(), batch, h, sq, sk, d, stripe, strides, float(scale),
            stream)
    if err:
        _launched(err, f"flash attention dQ kernel ({lib})",
                  f"head dim {d}, scale {scale} with strides {[x.stride() for x in (q, k, v)]}")
    _count_bwd("dq", lib)
    return dq, dvec


def flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale: float,
                            heads: Optional[int] = None, prep=None):
    """K4b: (dK, dV) in k's layout, given K4a's D; layouts and `prep` as
    flash_attention_bwd_dq."""
    lib = _bwd_route(q, heads)
    if lib is None:
        if heads is None:
            return flash_attention_bwd_dkv_plain(q, k, v, lse, do, dvec, scale)
        f = [_packed_to_flat(x, heads) for x in (q, k, v, do)]
        dk, dv = flash_attention_bwd_dkv_plain(*f[:3], lse, f[3], dvec, scale)
        return _flat_to_packed(dk, q.shape[0], heads), _flat_to_packed(dv, q.shape[0], heads)
    if lib in BWD_TF32_ROUTES:
        return _bwd_dkv_tf32(q, k, v, lse, do, dvec, scale, heads, lib, prep)
    batch, h, d, sq, sk = _bwd_prepare(q, k, v, lse, do, heads, lib)
    _check_rows("dvec", dvec, batch * h, sq)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = _bwd_strides((q, k, v, None, do, None, dk, dv), heads, d, (h * sq, sq))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if lib == BWD_NARROW_LIB:
        err = build_kernels()[lib].eti_flash_attention_bwd_narrow_dkv(
            *ptrs, batch, h, sq, sk, d, strides, float(scale), stream)
    else:  # P^T and dS^T of a stripe of queries at a time in a bf16 scratch; with
        # more than one stripe dV and dK are summed in an fp32 workspace
        stripe = bwd_tf32_stripe(sq, sk, batch * h, 2, elem_bytes=2)
        scratch = torch.empty((2, batch * h, sk, -(-stripe // 8) * 8), dtype=torch.bfloat16,
                              device=q.device)
        ws = torch.empty((2, batch * h, sk, d), dtype=torch.float32, device=q.device) \
            if stripe < sq else None
        err = build_kernels()[lib].eti_flash_attention_bwd_dkv(
            *ptrs, scratch.data_ptr(), None if ws is None else ws.data_ptr(), batch, h, sq, sk,
            d, stripe, strides, float(scale), stream)
    if err:
        _launched(err, f"flash attention dK/dV kernel ({lib})",
                  f"head dim {d}, scale {scale} with strides {[x.stride() for x in (q, k, v)]}")
    _count_bwd("dkv", lib)
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float, heads: Optional[int] = None):
    """(dQ, dK, dV): K4a, then K4b on the D it wrote (`_flash_bwd_impl`).
    On the TF32 routes one launch of the prep kernel serves both."""
    prep = None
    if _bwd_route(q, heads) in BWD_TF32_ROUTES:
        prep = flash_attention_bwd_tf32_prep(q, k, do, o, heads)
    dq, dvec = flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads, prep)
    return (dq, *flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale, heads, prep))


# ---------------------------------------------------------------------------
# short-K cross-attention (K5)
# ---------------------------------------------------------------------------

# K5's limits (csrc/crossk_attention.cu): bf16 or fp32 (TF32 products), head
# dim a multiple of 8 up to 160 (SD-1.5's 16x16 and mid levels), any sk >= 1:
# up to 256 bf16 keys in one score block (a warpgroup keeps its 64 rows'
# whole score rows in registers), above it and in fp32 in chunks of 128 keys
# with an online softmax
CROSSK_MAX_HEAD_DIM = 160
CROSSK_MAX_KEYS = 256
CROSSK_CHUNK_KEYS = 128
# K5's routes on the card: its bf16 mode, its TF32 mode (fp32 operands), and
# above CROSSK_MAX_HEAD_DIM the forward route `fwd_library` names (WIDE_LIB or
# FWD_TF32_WIDE, up to KERNEL_MAX_HEAD_DIM)
CROSSK_LIB = "eti_crossk_attention"
CROSSK_TF32 = "eti_crossk_attention (tf32)"


def crossk_attention_plain(q, k, v, sk: int, scale: float, tf32: bool = False):
    """K5's function over flat (BH, Sq, D) q and (BH, >= sk, D) k / v: fp32
    scores over the first `sk` keys, exact softmax (row max subtracted),
    probabilities rounded to v's dtype for an fp32 PV product, as the Pallas
    kernel rounds them.  With `tf32` (fp32 operands: the yardstick of K5's
    TF32 mode) also its roundings: P and V to TF32 (`round_tf32_plain`; Q and
    K, which the tensor cores truncate, as they are)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k[:, :sk].float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    vf = v[:, :sk].float()
    if tf32:
        p, vf = round_tf32_plain(p), round_tf32_plain(vf)
    return torch.einsum("bqk,bkd->bqd", p.float(), vf).to(q.dtype)


def crossk_route(dtype: torch.dtype, d: int, sk: int) -> str:
    """The route a K5 call of head dim `d` (padded to a multiple of 8 first)
    over `sk` keys with operands of `dtype` takes on the card: K5's bf16
    mode (CROSSK_LIB) or TF32 mode (CROSSK_TF32) up to CROSSK_MAX_HEAD_DIM,
    above it the forward route of `fwd_library` with sk keys (masked past
    them, as K5 masks them) up to KERNEL_MAX_HEAD_DIM.  ValueError for what
    no kernel takes: another dtype, sk < 1, a head dim above
    KERNEL_MAX_HEAD_DIM (ROADMAP Queue 3)."""
    _check_dtype(dtype)
    if sk < 1:
        raise ValueError(f"sk={sk}: the short-K kernel takes at least one key")
    dp = -(-d // 8) * 8
    if not 0 < dp <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the short-K routes take head dims up to "
                         f"{KERNEL_MAX_HEAD_DIM}")
    if dp > CROSSK_MAX_HEAD_DIM:
        return fwd_library(dp, dtype=dtype)
    return CROSSK_TF32 if dtype == torch.float32 else CROSSK_LIB


def _tma_ready(x: torch.Tensor, d: int) -> torch.Tensor:
    """x (BH, S, d0) as a TMA operand of head dim d >= d0: x itself when its
    last dim is contiguous and its base and strides 16-byte aligned, else a
    contiguous copy, zero-padded to d columns."""
    d0 = x.shape[-1]
    if d0 == d and x.stride(-1) == 1 and x.data_ptr() % 16 == 0 \
            and all(st * x.element_size() % 16 == 0 for st in x.stride()[:-1]):
        return x
    out = x.new_zeros(x.shape[:-1] + (d,))
    out[..., :d0] = x
    return out


def crossk_kernel_operands(q, k, v, sk: int, scale: float):
    """The checks and operands of a K5 call, read from shapes, types and
    addresses only (no card needed): (route, q, k, v) with k and v cut to
    their first sk rows and each operand, where TMA would refuse it (a head
    dim that is not a multiple of 8, a last dim that is not contiguous, a
    base or stride off the 16-byte grain), an aligned contiguous copy, zero-
    padded to a head dim that is a multiple of 8 (zero columns change
    neither q k^T nor the kept columns of p v).  ValueError for what no
    route takes (`crossk_route`), mismatched shapes, types or devices, sk
    above k's rows, a scale that is not finite."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 3:
            raise ValueError(f"{name}: expected 3 dims, got shape {tuple(x.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v of different dtypes: {q.dtype}, {k.dtype}, {v.dtype}")
    bh, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    route = crossk_route(q.dtype, d, sk)
    if sk > k.shape[1]:
        raise ValueError(f"sk={sk}: more keys than the {k.shape[1]} rows of k")
    if not math.isfinite(scale):
        raise ValueError(f"short-K attention: the kernel does not take scale {scale}")
    _check_grid(bh, 1, sq, sk)
    dp = -(-d // 8) * 8
    return route, _tma_ready(q, dp), _tma_ready(k[:, :sk], dp), _tma_ready(v[:, :sk], dp)


def crossk_attention_bhsd(q, k, v, sk: int, scale: float, block_q: int = 1024):
    """Cross-attention over flat (BH, Sq, D) q with a short key range: the
    first `sk` rows of (BH, >= sk, D) k and v (SD: 77 text tokens; K5's
    prototype S2 passes K/V already padded to 128 rows).  block_q is ignored
    (kept for the JAX signature).  On the card, the route `crossk_route`
    names for the operands `crossk_kernel_operands` makes: K5
    (csrc/crossk_attention.cu, which reads K/V through TMA maps of sk rows,
    the rows past them arriving as zeros, and masks keys >= sk) for head
    dims up to 160, bf16, or fp32 on its TF32 mode after the fp32 backward's
    prep kernel writes V^T (`flash_attention_bwd_tf32_prep`); above 160 the
    port's forward kernels (flash_attention_wide.cu, bf16, or
    flash_attention_bwd_tf32.cu's forward, fp32) on the sk keys.  Every
    call on the card counts on LAUNCHES["crossk_attention"], and by route
    on "crossk_attention_tf32", "_chunked" (bf16 above 256 keys) or "_wide"
    (above head dim 160); it raises for what no route takes.  A
    CPU tensor takes the plain version.  No gradient: the JAX kernel has
    none either."""
    if q.device.type == "cpu":
        return crossk_attention_plain(q, k, v, sk, scale)
    if not q.is_cuda:
        raise ValueError(f"q: expected a CUDA tensor, got {q.device}")
    route, qk, kk, vk = crossk_kernel_operands(q, k, v, sk, scale)  # k, v on q's device
    bh, sq, d = q.shape
    if route not in (CROSSK_LIB, CROSSK_TF32):
        o = _fwd_launch(qk, kk, vk, scale, None, False)[0]
        LAUNCHES["crossk_attention_wide"] += 1
    else:
        o = torch.empty_like(qk, memory_format=torch.contiguous_format)
        lib = build_kernels()[CROSSK_LIB]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        dp = qk.shape[-1]
        if route == CROSSK_TF32:
            vt = flash_attention_bwd_tf32_prep(vk, vk, vk, kt=True, qdot=False)[0]
            LAUNCHES["crossk_attention_tf32"] += 1
            err = lib.eti_crossk_attention_tf32(
                qk.data_ptr(), kk.data_ptr(), vt.data_ptr(), o.data_ptr(), bh, sq, sk, dp,
                vt.shape[-1], qk.stride(0), qk.stride(1), kk.stride(0), kk.stride(1),
                o.stride(0), o.stride(1), float(scale), stream)
        else:
            LAUNCHES["crossk_attention_chunked"] += sk > CROSSK_MAX_KEYS
            err = lib.eti_crossk_attention(
                qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), o.data_ptr(), bh, sq, sk, dp,
                qk.stride(0), qk.stride(1), kk.stride(0), kk.stride(1), vk.stride(0),
                vk.stride(1), o.stride(0), o.stride(1), float(scale), stream)
        if err:
            _launched(err, f"short-K attention kernel ({route})",
                      f"head dim {d}, sk {sk}, scale {scale} with strides "
                      f"{[x.stride() for x in (q, k, v)]}")
    LAUNCHES["crossk_attention"] += 1
    return o if o.shape[-1] == d else o[..., :d]


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
    The dtype is not gated: the wrappers route bf16 and fp32 (`fwd_library`,
    `bwd_library`) and raise for another."""
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
