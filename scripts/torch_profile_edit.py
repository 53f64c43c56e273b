"""Where one sd15 etainv+ptp edit of the PyTorch port spends its time on a
CUDA card, and the CUDA attention kernels against the plain path end to end.

    python3 scripts/torch_profile_edit.py            # 50 steps, one card

Imports nothing of JAX.  Prints, in order:

  [phases]        host-clock seconds of encode / text / forward loop /
                  backward loop / decode in one edit (synchronized per phase)
  [unet-in-loop]  median host-clock ms per UNet call in each loop
  [unet]          CUDA-event ms per hook-free UNet call at batch 1 and 4
  [profile]       torch.profiler over one edit: device kernel count, summed
                  kernel time and the largest kernels and groups
  [gelu]          the GEGLU's polynomial-erf gelu vs F.gelu on one tensor
  [e2e]           seconds per edit with the kernels and with the plain path,
                  alternated within the call (kernels, plain, plain, kernels,
                  kernels, plain)
  [mem]           torch.cuda.max_memory_allocated over one edit, both ways

The plain path is forced by replacing the dispatch gate
`ops.flash_attention._kernel_eligible` with one that admits nothing, so every
attention call takes `xla_attention` (fp32 scores, materialized).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from eta_inversion_tpu_torch import load_editor, load_inverter  # noqa: E402
from eta_inversion_tpu_torch.models import load_diffusion_model  # noqa: E402
from eta_inversion_tpu_torch.ops import flash_attention as fa  # noqa: E402
from eta_inversion_tpu_torch.ops.geglu import gelu_poly_f32  # noqa: E402

SRC, TGT = "a cat sitting next to a mirror", "a tiger sitting next to a mirror"
CFG = {"is_replace_controller": True, "cross_replace_steps": 0.8, "self_replace_steps": 0.5}


def log(msg: str) -> None:
    print(msg, flush=True)


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _event_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_phases(inv, edit) -> None:
    phase = {}
    names = ("encode", "create_context", "diffusion_forward", "diffusion_backward", "decode")
    for name in names:
        real = getattr(inv, name)

        def timed(*a, _real=real, _name=name, **k):
            out, dt = _synced(lambda: _real(*a, **k))
            phase[_name] = phase.get(_name, 0.0) + dt
            return out

        setattr(inv, name, timed)
    _, total = _synced(edit)
    for name in names:
        delattr(inv, name)
    log(f"[phases] total {total:.3f} s: " + json.dumps({k: round(v, 4) for k, v in phase.items()}))


def profile_unet(model, edit) -> None:
    unet = model.nets["unet"]
    calls = {"fwd": [], "bwd": []}
    real = unet.forward

    def timed(*a, **k):
        out, dt = _synced(lambda: real(*a, **k))
        calls["bwd" if a[0].shape[0] == 4 else "fwd"].append(dt)
        return out

    unet.forward = timed
    edit()
    del unet.forward
    log("[unet-in-loop] " + json.dumps({k: (len(v), round(1e3 * float(np.median(v)), 2))
                                        for k, v in calls.items()}) + " (calls, median ms)")
    lat = torch.randn(4, 4, 64, 64, device="cuda")
    ctx = torch.randn(4, 77, 768, device="cuda")
    for b in (1, 4):
        ms = _event_ms(lambda: model.unet(lat[:b], 500, ctx[:b]), 10)
        log(f"[unet] batch {b}: {ms:.2f} ms/call (hook-free, CUDA events)")


def profile_device(edit) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _synced(edit)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {}
    for e in kernels:
        us = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        t, n = by.get(e.name, (0.0, 0))
        by[e.name] = (t + us, n + 1)
    total = sum(t for t, _ in by.values())
    log(f"[profile] {len(kernels)} device kernels, summed kernel time {total / 1e6:.3f} s; "
        f"wall {wall:.3f} s under the profiler")
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:25]:
        log(f"[profile] {t / 1e3:9.1f} ms {n:7d}x  {name[:120]}")
    groups = dict.fromkeys(("flash_fwd_kernel", "conv/cudnn", "gemm", "norm",
                            "elementwise+copy", "other"), 0.0)
    for name, (t, _) in by.items():
        low = name.lower()
        if "flash_fwd_kernel" in name:
            groups["flash_fwd_kernel"] += t
        elif any(w in low for w in ("cudnn", "conv", "nchwtonhwc", "nhwctonchw")):
            groups["conv/cudnn"] += t
        elif any(w in low for w in ("gemm", "cutlass", "sm90", "xmma")):
            groups["gemm"] += t
        elif "norm" in low or "moments" in low:
            groups["norm"] += t
        elif any(w in low for w in ("elementwise", "copy", "reduce")):
            groups["elementwise+copy"] += t
        else:
            groups["other"] += t
    log("[profile] groups (ms): " + json.dumps({k: round(v / 1e3, 1) for k, v in groups.items()}))


def profile_gelu() -> None:
    g = torch.randn(4, 4096, 1280, device="cuda").bfloat16()
    for tag, fn in (("poly", lambda: gelu_poly_f32(g.float()).bfloat16()),
                    ("exact", lambda: torch.nn.functional.gelu(g))):
        log(f"[gelu] {tag} at (4,4096,1280) bf16: {_event_ms(fn, 20):.3f} ms")


def kernels_vs_plain(edit) -> None:
    gate = fa._kernel_eligible
    plain_gate = lambda *a, **k: False  # noqa: E731
    times = {"kernels": [], "plain": []}
    for tag in ("kernels", "plain", "plain", "kernels", "kernels", "plain"):
        fa._kernel_eligible = gate if tag == "kernels" else plain_gate
        times[tag].append(_synced(edit)[1])
    for tag in ("kernels", "plain"):
        fa._kernel_eligible = gate if tag == "kernels" else plain_gate
        torch.cuda.reset_peak_memory_stats()
        _synced(edit)
        log(f"[mem] peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, {tag}")
    fa._kernel_eligible = gate
    for tag, ts in times.items():
        log(f"[e2e] {tag}: {', '.join(f'{t:.3f}' for t in ts)} s/edit, "
            f"median {np.median(ts):.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    fa.build_kernels()
    model, (pre, _) = load_diffusion_model("sd15", dtype="bfloat16", device="cuda")
    inv = load_inverter(model, "etainv", num_inference_steps=args.steps,
                        eta=((0.6, 0.0), (1.0, 0.7)), noise_sample_count=10)
    editor = load_editor(inv, "ptp")
    img = pre((np.random.RandomState(1).rand(512, 512, 3) * 255).astype(np.uint8))

    def edit():
        return editor.edit(img, SRC, TGT, cfg=dict(CFG), inv_cfg={"edit_word_idx": (1, 1)})

    _synced(edit)  # warm-up
    profile_phases(inv, edit)
    profile_unet(model, edit)
    profile_device(edit)
    profile_gelu()
    kernels_vs_plain(edit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
