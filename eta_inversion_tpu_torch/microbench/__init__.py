"""The port's attention microbenchmarks, counterparts of two Pallas
microbenchmark scripts of the JAX package:

  * ``flash_sweep``           scripts/flash_sweep.py (S1): K3's kernel at the
    SD backward-step shape, head dim native or zero-padded to 128 in device
    memory, bf16 or fp32 (TF32) matmul operands, 8 variants.
  * ``attn_multihead_bench``  scripts/attn_multihead_bench.py (S3, S4): the
    per-head flat kernel behind its split / merge transposes (S3) against the
    multi-head kernel on the packed layout (S4), 5 variants.

Each keeps its prototype's variants and names, inputs and timing: a seeded
bf16 (B, S, H*D) input, 8 chained calls per run (c = 0.999 f(c) + 0.001 c),
CUDA-event times after one warm-up chain, and each variant's final output
against the first variant's.  They run on the card unless `--device cpu` is
given; on the CPU the kernels' plain versions run, untimed, at the batch and
sequence length the caller gives.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# the prototypes' shape: SD-1.5's 64x64 self-attention in a pair-batched
# backward step (8 edits x 4 rows), 8 heads of 40; 8 chained calls a run,
# 3 timed runs
B, H, S, D = 32, 8, 4096, 40
LOOPS = 8
REPS = 3


def parse_args(argv, description: str) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--seq", type=int, default=S)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def make_input(b: int, s: int, device: str, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The prototypes' input: randn(B, S, H*D) * 0.1 from RandomState(0)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card is available")
    x = np.random.RandomState(0).randn(b, s, H * D).astype(np.float32) * 0.1
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def split(x: torch.Tensor) -> torch.Tensor:
    """Packed (B, S, H*D) -> flat (B*H, S, D), materialised."""
    b, s, hd = x.shape
    return x.reshape(b, s, H, hd // H).transpose(1, 2).reshape(b * H, s, hd // H)


def merge(o: torch.Tensor, b: int) -> torch.Tensor:
    """Flat (B*H, S, D) -> packed (B, S, H*D), materialised."""
    bh, s, d = o.shape
    return o.reshape(b, bh // b, s, d).transpose(1, 2).reshape(b, s, bh // b * d)


def run_variants(variants: Dict[str, Callable], x0: torch.Tensor,
                 call: Callable[[Callable, torch.Tensor], torch.Tensor],
                 log: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Each variant as its prototype runs it: LOOPS chained steps c =
    0.999 call(fn, c) + 0.001 c from x0 (the first chain is also the
    warm-up), then on the card REPS timed chains between CUDA events.
    Returns per variant its name, ms per call (None on the CPU), the largest
    |difference| of its final output from the first variant's, that output's
    sum and the first variant's max |out|."""
    results, ref = [], None
    for name, fn in variants.items():
        def chain(fn=fn):
            c = x0
            for _ in range(LOOPS):
                c = call(fn, c).to(c.dtype) * 0.999 + c * 0.001
            return c

        out = chain().float()
        ms = None
        if x0.is_cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                chain()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / (REPS * LOOPS)
        if ref is None:
            ref = out
        res = {"name": name, "ms": ms, "max_diff_vs_v0": (out - ref).abs().max().item(),
               "sum": out.sum().item(), "max_abs_v0": ref.abs().max().item()}
        results.append(res)
        if log is not None:
            timing = (f"{ms:8.3f} ms/call" if ms is not None
                      else "   (cpu: plain version, not timed)")
            log(f"{name:28s} {timing}  (sum={res['sum']:.3e}, "
                f"maxdiff_vs_v0={res['max_diff_vs_v0']:.3e} of max|v0| {res['max_abs_v0']:.3e})")
    return results
