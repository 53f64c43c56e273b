"""Time the port's TF32 attention forward on a CUDA card, and hold its bf16
forward against another checkout's, in one process.

    python3 scripts/torch_flash_tf32_bench.py                # this checkout
    python3 scripts/torch_flash_tf32_bench.py --parent DIR   # in turns with DIR's port

DIR is a directory of this checkout holding another version of
`eta_inversion_tpu_torch/` (e.g. `git archive` of the parent commit unpacked
under `build/`).  Five groups of rows, one JSON line each:

* "tf32": the fp32 products of the microbenchmarks' prototypes S1 (`flash`,
  mm_bf16=False, at (BH, S, D) = (256, 4096, 40), D native and zero-padded
  to 128 in memory) and S3 (`prod_flash`) through
  `flash_attention_bhsd_tiled(operands="fp32")` on seeded bf16 inputs, timed
  change, parent, parent, change with DIR (where DIR's port may run them on
  another kernel, with the tile SWEEP gives it), the change's prep kernel
  alone, and each version's max and mean
  abs error against the fp32 plain result (16 heads at a time).
* "bf16": the bf16 forward at K1's two and K2's UNet shapes and K3's VAE
  decode shape (d = 512), in turns with DIR's, and whether the two give the
  same bits.
* "fp32": the fp32 forward (the TF32 mode) at K1's and K2's shapes, with
  SDPA on the same fp32 inputs; DIR's port is not asked (an older port may
  refuse fp32).
* "fp32_kernels": the fp32 forward above head dim 128 at K3's VAE shapes
  (materialized scores and a TF32 GEMM in csrc/flash_attention_bwd_tf32.cu)
  in turns with DIR's, each launch of the route timed alone (V^T prep,
  scores, the GEMM that forms P), the errors of O and the LSE against the
  fp32 plain result and a bitwise repeat; then the
  backward (K4a then K4b) from the TF32 forward's LSE at nti's two shapes,
  this checkout only.
* "multihead": S4's all-heads block at the prototypes' (32, 4096, 8, 40) in
  both operand modes, in turns with DIR's multi-head kernel, beside K1's
  route and SDPA (its default call) on the same bf16 inputs, with each
  version's errors against the fp32 plain result (a batch element at a
  time).

SDPA on fp32 inputs is timed twice: its default call (the memory-efficient
kernel, fp32-accurate) and its math backend with TF32 matmuls allowed (the
kernels' precision: TF32 products); for the backward, their whole
backward.

Times are CUDA-event means over REPS calls queued behind a sleep kernel
after a warm-up (as chip_smoke.py times).  Every row carries its bound: the
least time the card could take (tensor-core products at the TF32 or bf16
peak, S^2 exponentials per head at the MUFU rate, inputs read and outputs
written once at the HBM rate; the backward 6 + 8 S^2 d flops a head and six
tensors, LSE and D).  The card's name and power limit come first.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
REPS = 10
RTOL = 2e-2
# H100 SXM at the 700 W limit (NVIDIA data sheet; chip_smoke.py's constants)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
SLEEP_CYCLES_PER_REP = 200_000
SLEEP_CLOCK_HZ = 1.98e9
PLAIN_CHUNK_HEADS = 16
# (name, BH, S, d, D in memory, tile a parent's port needs: None where its TF32
# mode sizes its own tiles and refuses one)
SWEEP = (("S1 TF32, D native", 256, 4096, 40, 40, None),
         ("S1 TF32, D padded to 128", 256, 4096, 40, 128, None),
         ("S3 prod_flash", 256, 4096, 40, 40, None))
# (name, layout, B, S, H, d): K1 at the UNet's 64x64 and 32x32 levels, K2
SERVED = (("K1", "packed", 4, 4096, 8, 40), ("K1", "packed", 2, 1024, 8, 80),
          ("K2", "onepass", 32, 1024, 1, 80), ("K3", "blockwise", 2, 4096, 1, 512))


def _time_ms(fn, reps: int = REPS) -> float:
    """Device ms per call: CUDA events around `reps` calls queued behind a
    sleep kernel that covers three times one call's host time."""
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


def bound_ms(bh, s, d, elem_bytes, tf32) -> float:
    """The least time of a forward call: products at the TF32 (or bf16)
    peak, exponentials at the MUFU rate, q, k, v, o once at the HBM rate."""
    ops = max(4 * bh * s * s * d / (PEAK_TF32_FLOPS if tf32 else PEAK_BF16_FLOPS),
              bh * s * s / PEAK_EXP)
    return max(ops, 4 * bh * s * d * elem_bytes / PEAK_HBM_BYTES) * 1e3


def _load(root: Path):
    """The ops.flash_attention module of the port under `root`, imported
    afresh, its kernels built and loaded (so that it never again imports a
    sibling module, which another version may have replaced)."""
    for name in [m for m in sys.modules if m.startswith("eta_inversion_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        fa = importlib.import_module("eta_inversion_tpu_torch.ops.flash_attention")
    finally:
        sys.path.remove(str(root))
    fa.build_kernels()
    return fa


def _errors(got, exact):
    diff = (got.float() - exact).abs()
    return diff.max().item(), diff.mean().item()


def _turns(fns: dict, order) -> dict:
    """{label: [ms per turn]} over `order` (labels of fns)."""
    out = {label: [] for label in fns}
    for label in order:
        out[label].append(_time_ms(fns[label]))
    return out


def tf32_rows(versions: dict, order) -> None:
    fa = versions["change"]
    for i, (name, bh, s, d, dpad, tile) in enumerate(SWEEP):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.nn.functional.pad(torch.randn(bh, s, d, generator=g, device="cuda"),
                                           (0, dpad - d)).bfloat16() for _ in range(3))
        scale = d ** -0.5
        exact = torch.cat([fa.flash_attention_bhsd_plain(*(x[j:j + PLAIN_CHUNK_HEADS].float()
                                                           for x in (q, k, v)), scale)
                           for j in range(0, bh, PLAIN_CHUNK_HEADS)])
        fns = {label: (lambda m=m, t=tile if label == "parent" else None:
                       m.flash_attention_bhsd_tiled(q, k, v, scale, "fp32", t))
               for label, m in versions.items()}
        row = {"group": "tf32", "name": name, "shape(BH,S,d,D)": [bh, s, d, dpad],
               "bound_ms": bound_ms(bh, s, dpad, 2, True)}
        ok = True
        for label, fn in fns.items():
            err, mean = _errors(fn(), exact)
            row[f"{label}_max_abs_err"], row[f"{label}_mean_abs_err"] = err, mean
            ok &= err <= RTOL * exact.abs().max().item()
        del exact
        row["ms_turns"] = _turns(fns, order)
        row["prep_ms"] = _time_ms(lambda: fa.flash_attention_tf32_prep(q, k, v))
        row["ok"] = ok
        print(json.dumps(row), flush=True)
        if not ok:
            raise SystemExit(f"{name}: a version is off the fp32 plain result by more than "
                             f"{RTOL} of its largest magnitude")
        del q, k, v
        torch.cuda.empty_cache()


def _served_inputs(layout, b, s, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, s, h * d) if layout == "packed" else (b, s, d)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


def _at_tf32(fn):
    """fn run with TF32 matmuls allowed (the fp32 kernels' precision)."""
    def call():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return call


def _sdpa_pair(qh, kh, vh, scale):
    """(SDPA's default call, its math backend at TF32) on (B, H, S, D)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def math():
        with sdpa_kernel(SDPBackend.MATH):
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)

    return (lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale),
            _at_tf32(math))


def _served_call(fa, layout, q, k, v, h, scale):
    if layout == "packed":
        return lambda: fa.flash_attention_packed(q, k, v, scale, heads=h)
    bk = q.shape[1] if layout == "onepass" else 1024
    return lambda: fa.flash_attention_bhsd(q, k, v, scale, block_k=bk)


def served_rows(versions: dict, order) -> None:
    fa = versions["change"]
    for i, (name, layout, b, s, h, d) in enumerate(SERVED):
        scale = d ** -0.5
        # bf16: the same bits as the other version, in turns with it
        q, k, v = _served_inputs(layout, b, s, h, d, torch.bfloat16, 200 + i)
        fns = {label: _served_call(m, layout, q, k, v, h, scale)
               for label, m in versions.items()}
        outs = {label: fn() for label, fn in fns.items()}
        row = {"group": "bf16", "name": name, "shape(B,S,H,d)": [b, s, h, d],
               "bound_ms": bound_ms(b * h, s, d, 2, False),
               "ms_turns": _turns(fns, order)}
        if "parent" in outs:
            row["same_bits_as_parent"] = torch.equal(outs["change"], outs["parent"])
        print(json.dumps(row), flush=True)
        if d > fa.NARROW_MAX_HEAD_DIM:  # fp32 above 128: fp32_kernel_rows
            continue
        # fp32: the TF32 mode, SDPA on the same inputs
        q, k, v = _served_inputs(layout, b, s, h, d, torch.float32, 300 + i)
        run = _served_call(fa, layout, q, k, v, h, scale)
        want = fa._fwd_plain(q, k, v, scale, h if layout == "packed" else None, False)[0]
        err, mean = _errors(run(), want)
        qh, kh, vh = ([x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v)]
                      if layout == "packed" else [x[:, None] for x in (q, k, v)])
        sdpa, sdpa_tf32 = _sdpa_pair(qh, kh, vh, scale)
        row = {"group": "fp32", "name": name, "shape(B,S,H,d)": [b, s, h, d],
               "bound_ms": bound_ms(b * h, s, d, 4, True), "max_abs_err": err,
               "mean_abs_err": mean, "ok": err <= RTOL * want.abs().max().item(),
               "ms_turns": _turns({"change": run, "sdpa": sdpa, "sdpa_math_tf32": sdpa_tf32},
                                  ["change", "sdpa", "sdpa_math_tf32", "sdpa_math_tf32",
                                   "sdpa", "change"]),
               "prep_ms": _time_ms(lambda: fa.flash_attention_tf32_prep(
                   q, k, v, h if layout == "packed" else None))}
        print(json.dumps(row), flush=True)
        if not row["ok"]:
            raise SystemExit(f"fp32 {name}: off the plain result by {err}")


def _k3_launches(fa, q, k, v, scale) -> dict:
    """Each kernel launch of the fp32 forward above head dim 128 alone, as
    `_tf32_wide_launch` makes them on flat (BH, S, d) q, k, v of one stripe:
    {name: fn}, in the order they run."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    skpad = -(-sk // 8) * 8
    assert fa.fwd_tf32_stripe(sq, sk, bh) == sq, "one stripe at the bench's shapes"
    lib = fa.build_kernels()[fa.BWD_TF32_LIB]
    vt = fa._bwd_tf32_prep_launch(q, v, q, None, None, True, False)[0]
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, sq), device=q.device)
    scores = torch.empty((bh, sq, skpad), device=q.device)
    part = torch.empty((bh, sq, -(-skpad // fa.BWD_TF32_TILE), 2), device=q.device)
    strides = fa._bwd_strides((q, k, None, o, None, None, None, None), None, d, (sq, sq))
    c_st = (ctypes.c_longlong * 3)(*fa._strides(o, None, d))
    stream = torch.cuda.current_stream().cuda_stream
    return {
        "prep_vt": lambda: fa._bwd_tf32_prep_launch(q, v, q, None, None, True, False)[0],
        "scores": lambda: lib.eti_flash_attention_bwd_tf32_scores(
            2, q.data_ptr(), k.data_ptr(), None, None, None, None, scores.data_ptr(),
            part.data_ptr(), bh, 1, sq, sk, d, 0, sq, skpad, strides, float(scale), stream),
        "gemm_p_v": lambda: lib.eti_flash_attention_fwd_tf32_pv(
            scores.data_ptr(), part.data_ptr(), vt.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, 1, sq, d, skpad, 0, c_st, sq, sq, stream),
    }


def fp32_kernel_rows(versions: dict, order) -> None:
    fa = versions["change"]
    for i, (b, s, h, d) in enumerate(((2, 4096, 1, 512), (1, 4096, 1, 512))):
        q, k, v = _served_inputs("onepass", b, s, h, d, torch.float32, 400 + i)
        scale = d ** -0.5
        fns = {label: (lambda m=m: m.flash_attention_bhsd_fwd(q, k, v, scale, block_k=1024,
                                                              need_lse=True))
               for label, m in versions.items()}
        want, lse_want = fa._fwd_plain(q, k, v, scale, None, True)
        sdpa, sdpa_tf32 = _sdpa_pair(q[:, None], k[:, None], v[:, None], scale)
        fa.reset_launch_counts()
        fns["change"]()
        row = {"group": "fp32_kernels", "name": "K3 forward", "shape(B,S,H,d)": [b, s, h, d],
               "route": fa.fwd_library(d, dtype=torch.float32),
               "launches": {n: c for n, c in fa.LAUNCHES.items() if c},
               "bound_ms": bound_ms(b, s, d, 4, True)}
        ok = True
        for label, fn in fns.items():
            (o, lse), (o2, lse2) = fn(), fn()
            err, mean = _errors(o, want)
            row[f"{label}_max_abs_err"], row[f"{label}_mean_abs_err"] = err, mean
            row[f"{label}_lse_max_abs_err"] = (lse - lse_want).abs().max().item()
            row[f"{label}_bitwise_repeatable"] = torch.equal(o, o2) and torch.equal(lse, lse2)
            ok &= err <= RTOL * want.abs().max().item()
        for label, fn in (("sdpa", sdpa), ("sdpa_math_tf32", sdpa_tf32)):
            row[f"{label}_mean_abs_err"] = _errors(fn(), want[:, None])[1]
        del want
        row["ms_turns"] = _turns(fns, order)
        row["library_ms_turns"] = _turns(
            {"change": fns["change"], "sdpa": sdpa, "sdpa_math_tf32": sdpa_tf32},
            ["change", "sdpa", "sdpa_math_tf32", "sdpa_math_tf32", "sdpa", "change"])
        row["launch_ms"] = {name: _time_ms(fn) for name, fn in _k3_launches(fa, q, k, v,
                                                                           scale).items()}
        row["ok"] = ok
        print(json.dumps(row), flush=True)
        if not ok:
            raise SystemExit(f"K3 fp32 {(b, s, h, d)}: a version is off the fp32 plain result")
        del q, k, v
        torch.cuda.empty_cache()
    for i, (b, s, h, d) in enumerate(((1, 4096, 8, 40), (1, 1024, 8, 80))):
        q, k, v = _served_inputs("packed", b, s, h, d, torch.float32, 500 + i)
        do = _served_inputs("packed", b, s, h, d, torch.float32, 550 + i)[0]
        scale = d ** -0.5
        o, lse = fa.flash_attention_packed_fwd(q, k, v, scale, h, need_lse=True)
        pair = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, scale, heads=h)  # noqa: E731
        qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        sdpa, sdpa_tf32 = _sdpa_pair(qh, kh, vh, scale)
        oh, oh_tf32 = sdpa(), sdpa_tf32()
        doh = do.view(b, s, h, d).transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,  # noqa: E731
                                               retain_graph=True)
        sdpa_bwd_tf32 = _at_tf32(lambda: torch.autograd.grad(oh_tf32, (qh, kh, vh), doh,
                                                             retain_graph=True))
        fa.reset_launch_counts()
        pair()
        nbytes = 6 * b * h * s * d * 4 + 2 * b * h * s * 4
        ops = max(14 * b * h * s * s * d / PEAK_TF32_FLOPS, 2 * b * h * s * s / PEAK_EXP)
        row = {"group": "fp32_kernels", "name": "K4a + K4b backward",
               "shape(B,S,H,d)": [b, s, h, d], "route": fa.bwd_library(d, torch.float32),
               "launches": {n: c for n, c in fa.LAUNCHES.items() if c},
               "bound_ms": max(ops, nbytes / PEAK_HBM_BYTES) * 1e3,
               "ms_turns": _turns({"change": pair, "sdpa_bwd": sdpa_bwd,
                                   "sdpa_math_tf32_bwd": sdpa_bwd_tf32},
                                  ["change", "sdpa_bwd", "sdpa_math_tf32_bwd",
                                   "sdpa_math_tf32_bwd", "sdpa_bwd", "change"])}
        print(json.dumps(row), flush=True)


def multihead_rows(versions: dict, order) -> None:
    """S4 at the prototypes' shape, both operand modes, in turns with DIR's
    multi-head kernel (its default tile); K1's route and SDPA on the same
    bf16 inputs."""
    fa = versions["change"]
    b, s, h, d = 32, 4096, 8, 40
    q, k, v = _served_inputs("packed", b, s, h, d, torch.bfloat16, 600)
    scale = d ** -0.5
    exact = torch.cat([fa.flash_attention_packed_plain(
        *(x[j:j + 2].float() for x in (q, k, v)), scale, h) for j in range(0, b, 2)])
    qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2) for x in (q, k, v))
    others = {"k1_route_bf16": lambda: fa.flash_attention_packed(q, k, v, scale, heads=h),
              "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
                  qh, kh, vh, scale=scale)}
    for operands in ("bf16", "fp32"):
        fns = {label: (lambda m=m: m.flash_attention_multihead(q, k, v, scale, h, operands))
               for label, m in versions.items()}
        row = {"group": "multihead", "name": f"S4 {operands} operands",
               "shape(B,S,H,d)": [b, s, h, d],
               "bound_ms": bound_ms(b * h, s, d, 2, operands == "fp32")}
        ok = True
        for label, fn in fns.items():
            got = fn()
            err, mean = _errors(got, exact)
            row[f"{label}_max_abs_err"], row[f"{label}_mean_abs_err"] = err, mean
            ok &= err <= RTOL * exact.abs().max().item()
            if label == "change":
                row["bitwise_repeatable"] = torch.equal(got, fn())
            del got
        row["ms_turns"] = _turns(fns, order)
        row["beside_ms_turns"] = _turns({"change": fns["change"], **others},
                                        ["change", "k1_route_bf16", "sdpa", "sdpa",
                                         "k1_route_bf16", "change"])
        if operands == "fp32":
            row["prep_ms"] = _time_ms(lambda: fa.flash_attention_tf32_prep(q, k, v, h))
        row["ok"] = ok
        print(json.dumps(row), flush=True)
        if not ok:
            raise SystemExit(f"S4 {operands}: a version is off the fp32 plain result")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="directory (in this checkout) of another version's port")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                                     "cudnn": torch.backends.cudnn.allow_tf32}}), flush=True)
    versions = {"change": _load(ROOT)}
    order = ["change", "change"]
    if args.parent:
        versions["parent"] = _load((ROOT / args.parent).resolve())
        order = ["change", "parent", "parent", "change"]
    tf32_rows(versions, order)
    served_rows(versions, order)
    fp32_kernel_rows(versions, order)
    multihead_rows(versions, order)


if __name__ == "__main__":
    main()
