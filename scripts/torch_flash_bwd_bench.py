"""Time the port's flash-attention backward (K4a dQ, K4b dK/dV) on a CUDA card
at null-text inversion's two shapes, beside SDPA's whole backward and the
bound, and optionally against the port of another checkout in the same
process, so that two versions are compared on one card.

    python3 scripts/torch_flash_bwd_bench.py                # this checkout, bf16
    python3 scripts/torch_flash_bwd_bench.py --parent DIR   # change, parent, parent, change
    python3 scripts/torch_flash_bwd_bench.py --dtype float32 [--parent DIR]

DIR is a directory of this checkout holding another version of
`eta_inversion_tpu_torch/` (e.g. `git archive` of the parent commit unpacked
under `build/`).  Inputs are made on the card from a seed, as chip_smoke.py's
K4 rows make them: bf16 q, k, v, dO ~ N(0, 1) in the packed (B, S, H*d)
layout, o and the LSE from the plain forward.  Each run prints one JSON line
per shape: K4a, K4b and the pair (K4a then K4b, the function of
`_flash_bwd_impl`) and SDPA's whole backward on the same inputs
(torch.autograd.grad through F.scaled_dot_product_attention: dQ, dK and dV)
as CUDA-event means over REPS calls queued behind a sleep kernel after a
warm-up, and each output's max abs error against the plain backward with
the 2% bound chip_smoke.py uses.  The first time a version runs it also
prints the plain version's time and the device time of each kernel of the
pair and of SDPA's backward per call (torch.profiler over 5 calls).  Every line
carries the bound: the least time the card could take for each kernel's work
(6 and 8 S^2 d flops per head at the bf16 peak, S^2 exponentials each at the
MUFU rate, inputs read and outputs written once at the HBM rate) and their
sum for the pair.  With --parent, a last line says whether the two versions
gave the same bits at each shape (the bf16 kernels are not to change).

--dtype float32 times the fp32 backward (the TF32 routes; the pair's time
includes their prep kernel) at nti's two shapes and the VAE mid-block's (1,
4096, 1, 512), with fp32 inputs, TF32 bounds (495 TFLOP/s, 4-byte tensors)
and two library calls: SDPA's whole backward at the kernels' precision (its
math backend with TF32 matmuls allowed, "sdpa_bwd_ms") and its default fp32
call ("sdpa_default_bwd_ms", the memory-efficient kernel, fp32-accurate).
The card's name and power limit come first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
# (B, S, H, d): nti's 64x64 and 32x32 levels; in fp32 also the VAE mid-block
SHAPES = {"bfloat16": ((1, 4096, 8, 40), (1, 1024, 8, 80)),
          "float32": ((1, 4096, 8, 40), (1, 1024, 8, 80), (1, 4096, 1, 512))}
RTOL = 2e-2
REPS = 50
# H100 SXM at the 700 W limit (NVIDIA data sheet; chip_smoke.py's constants)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
SLEEP_CYCLES_PER_REP = 200_000
SLEEP_CLOCK_HZ = 1.98e9


def _time_ms(fn, reps: int = REPS) -> float:
    """Device ms per call: CUDA events around `reps` calls queued behind a
    sleep kernel that covers three times one call's host time (as
    chip_smoke.py times), so that the host's launch path does not set the
    pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(SLEEP_CYCLES_PER_REP, int(3 * host_s * SLEEP_CLOCK_HZ)) * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_ms(fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel that fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def bound_ms(b, s, h, d, fp32=False) -> dict:
    """The least time for K4a's and K4b's work: the larger of tensor-core
    time (bf16, or TF32 for fp32 operands), exponential time and HBM time,
    each kernel on its own."""
    bh = b * h
    peak, elem = (PEAK_TF32_FLOPS, 4) if fp32 else (PEAK_BF16_FLOPS, 2)
    out = {}
    for name, mult in (("dq", 6), ("dkv", 8)):
        ops = max(mult * bh * s * s * d / peak, bh * s * s / PEAK_EXP)
        nbytes = 6 * bh * s * d * elem + 2 * bh * s * 4  # six tensors, L and D
        out[name] = max(ops, nbytes / PEAK_HBM_BYTES) * 1e3
    out["pair"] = out["dq"] + out["dkv"]
    return out


def _inputs(fa, b, s, h, d, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h * d, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    scale = d ** -0.5
    o = fa.flash_attention_packed_plain(q, k, v, scale, h)
    lse = fa.attention_lse_plain(fa._packed_to_flat(q, h), fa._packed_to_flat(k, h),
                                 scale).reshape(b, h, s)
    return q, k, v, o, lse, do, scale


def _load(root: Path):
    """The ops.flash_attention module of the port under `root`, imported afresh."""
    for name in [m for m in sys.modules if m.startswith("eta_inversion_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module("eta_inversion_tpu_torch.ops.flash_attention")
    finally:
        sys.path.remove(str(root))


def _sdpa_math_tf32(qh, kh, vh, scale):
    """SDPA's math backend with TF32 matmuls allowed: the fp32 library call
    at the kernels' precision."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with sdpa_kernel(SDPBackend.MATH):
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _grad_tf32(oh, xs, doh):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.autograd.grad(oh, xs, doh, retain_graph=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def run(label: str, root: Path, yardsticks: bool, dtype: torch.dtype) -> dict:
    """One version's rows; returns its outputs by shape (for the bit check)."""
    fa = _load(root)
    fa.build_kernels()
    fp32 = dtype == torch.float32
    outputs = {}
    for i, (b, s, h, d) in enumerate(SHAPES[str(dtype).removeprefix("torch.")]):
        q, k, v, o, lse, do, scale = _inputs(fa, b, s, h, d, seed=i, dtype=dtype)
        _, dvec = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads=h)
        dq_fn = lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, heads=h)  # noqa: E731
        dkv_fn = lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, do, dvec, scale, heads=h)  # noqa: E731
        pair = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)  # noqa: E731
        flat = [fa._packed_to_flat(x, h) for x in (q, k, v, o, do)]
        plain = lambda: fa.flash_attention_bwd_plain(*flat[:4], lse, flat[4], scale)  # noqa: E731
        got, want = pair(), plain()
        outputs[(b, s, h, d)] = got
        errs, ok = {}, True
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            errs[name] = (fa._packed_to_flat(x, h).float() - y.float()).abs().max().item()
            ok &= errs[name] <= RTOL * y.float().abs().max().item()
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        oh = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = do.view(b, s, h, d).transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,  # noqa: E731
                                               retain_graph=True)
        extra = {}
        if fp32:  # the library at the kernels' precision, SDPA's fp32 default beside it
            sdpa_default = sdpa_bwd
            oh_tf32 = _sdpa_math_tf32(qh, kh, vh, scale)
            sdpa_bwd = lambda: _grad_tf32(oh_tf32, (qh, kh, vh), doh)  # noqa: E731
            extra["sdpa_default_bwd_ms"] = _time_ms(sdpa_default)
        row = {"run": label, "root": str(root.relative_to(ROOT)) or ".", "shape": [b, s, h, d],
               "dtype": str(dtype), "dq_ms": _time_ms(dq_fn), "dkv_ms": _time_ms(dkv_fn),
               "pair_ms": _time_ms(pair), "sdpa_bwd_ms": _time_ms(sdpa_bwd), **extra,
               "bound_ms": bound_ms(b, s, h, d, fp32), "max_abs_err": errs, "ok": ok}
        if yardsticks:
            row["plain_ms"] = _time_ms(plain, 5)
            row["kernel_ms"] = _kernel_ms(pair)
            row["sdpa_kernel_ms"] = _kernel_ms(sdpa_bwd)
        print(json.dumps(row), flush=True)
        if not ok:
            raise SystemExit(f"{label} at {(b, s, h, d)}: errors {errs} above {RTOL} of the plain")
        del q, k, v, o, lse, do, qh, kh, vh, oh, doh
        torch.cuda.empty_cache()
    return outputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="directory (in this checkout) of the parent's port")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(SHAPES))
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    roots = {"change": ROOT}
    order = ["change"]
    if args.parent:
        roots["parent"] = (ROOT / args.parent).resolve()
        order = ["change", "parent", "parent", "change"]
    seen, outputs = set(), {}
    for label in order:
        outputs[label] = run(label, roots[label], yardsticks=label not in seen, dtype=dtype)
        seen.add(label)
    if args.parent:
        same = {str(shape): all(torch.equal(x, y) for x, y in zip(got, outputs["parent"][shape]))
                for shape, got in outputs["change"].items()}
        diff = {str(shape): max((x.float() - y.float()).abs().max().item()
                                for x, y in zip(got, outputs["parent"][shape]))
                for shape, got in outputs["change"].items()}
        print(json.dumps({"same_bits_as_parent": same, "max_abs_diff_from_parent": diff}),
              flush=True)


if __name__ == "__main__":
    main()
