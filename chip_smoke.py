"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py                 # all phases, sd15 at 50 steps
    python3 chip_smoke.py --steps 20      # shorter edits
    python3 chip_smoke.py --phases device,build,kernels

Phases, in order; any failure exits non-zero before the last line:

1. device   -- the card's name, and its name and power limit from nvidia-smi.
2. build    -- compile the CUDA kernels from csrc/ with nvcc (timed) and load.
3. kernels  -- each kernel against its plain PyTorch version on the card, on
               the same seeded bf16 inputs, at the main path's shapes; max abs
               error against a bound of 2% of the plain output's largest
               magnitude, and CUDA-event times of both.
4. serving  -- the sd15 etainv+ptp edit server (random weights from a seed)
               answers three 512x512 edits: two submitted concurrently and one
               HTTP POST /v1/edit on 127.0.0.1.  Each result must be a finite
               512x512x3 image, and every kernel's launch count must have grown
               during the edits.  A tiny-preset edit on the card is also held
               against the same edit on the CPU.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from eta_inversion_tpu_torch.ops import flash_attention as fa  # noqa: E402

# The bound scales with the reference: with randn q/k/v the outputs are
# averages over S keys, of size about sqrt(e/S) (max |out| 0.13-0.4 at the
# shapes below), not O(1).  Both sides round the output to bf16 and the kernel
# also rounds the probabilities to bf16 before the PV product (as the TPU
# kernels do): that costs at most about one bf16 ulp of the largest output,
# 0.25-0.65% of max |out| in a CPU simulation at these shapes.  2% of max |out|
# leaves room for that, and a 3% error in the softmax normalisation misses it.
KERNEL_RTOL = 2e-2
# tiny-preset fp32 edit, card vs CPU: different summation orders over 2x10
# UNet calls, same bar as the port's JAX comparison
TINY_TOL = 1e-3

KERNELS = [
    # name, TPU kernel replaced, wrapper counter, shapes (main-path shape first)
    {"name": "K1 flash_attention_packed",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:337 (_packed_fwd_impl -> "
                 "_flash_packed_kernel :295)",
     "counter": "flash_attention_packed",
     "shapes": [("packed", 4, 4096, 8, 40), ("packed", 2, 1024, 8, 80)]},
    {"name": "K2 flash_attention_bhsd (one pass)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:97 (_flash_fwd_impl, "
                 "block_k == S -> _flash_onepass_kernel :41)",
     "counter": "flash_attention_bhsd_onepass",
     "shapes": [("onepass", 32, 1024, 1, 80)]},
    {"name": "K3 flash_attention_bhsd (blockwise)",
     "replaces": "eta_inversion_tpu/ops/flash_attention.py:97 (_flash_fwd_impl, "
                 "block_k < S -> _flash_kernel :62)",
     "counter": "flash_attention_bhsd_blockwise",
     "shapes": [("blockwise", 2, 4096, 1, 512)]},
]


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs one card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); card 0: {name}")
    log(smi.stdout.strip().splitlines()[0])
    return name


def phase_build() -> None:
    from eta_inversion_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    fa.build_kernels()
    info = cuda_build.build_info["eti_flash_attention"]
    log(f"[build] flash attention kernels ready in {time.monotonic() - t0:.1f} s "
        f"(nvcc {info['seconds']:.1f} s) -> {info['path']}")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def _inputs(kind, b, s, h, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, s, h * d) if kind == "packed" else (b, s, d)
    return [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels() -> list:
    rows = []
    for i, kern in enumerate(KERNELS):
        errs, ms, plain_ms = [], None, None
        for j, (kind, b, s, h, d) in enumerate(kern["shapes"]):
            q, k, v = _inputs(kind, b, s, h, d, seed=100 * i + j)
            scale = d ** -0.5
            if kind == "packed":
                run = lambda: fa.flash_attention_packed(q, k, v, scale, heads=h)  # noqa: E731
                plain = lambda: fa.flash_attention_packed_plain(q, k, v, scale, h)  # noqa: E731
            else:
                bk = s if kind == "onepass" else s // 4
                run = lambda: fa.flash_attention_bhsd(q, k, v, scale, block_q=256,  # noqa: E731
                                                      block_k=bk)
                plain = lambda: fa.flash_attention_bhsd_plain(q, k, v, scale)  # noqa: E731
            got = run()
            torch.cuda.synchronize()
            want = plain()
            err = (got.float() - want.float()).abs().max().item()
            bound = KERNEL_RTOL * want.float().abs().max().item()
            if not np.isfinite(err):
                raise RuntimeError(f"{kern['name']} at {(kind, b, s, h, d)}: non-finite output")
            t_k, t_p = _time_ms(run, 20), _time_ms(plain, 5)
            log(f"[kernels] {kern['name']:38s} shape(B,S,H,d)={(b, s, h, d)} "
                f"max_abs_err={err:.3e} (bound {bound:.3e} = {KERNEL_RTOL} x max|plain|) "
                f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms")
            if not err <= bound:
                raise RuntimeError(f"{kern['name']} disagrees with its plain version: "
                                   f"{err} > {bound}")
            errs.append(err)
            if j == 0:
                ms, plain_ms = t_k, t_p
            del q, k, v, got, want
        rows.append({"name": kern["name"], "route": "cuda",
                     "source": "eta_inversion_tpu_torch/csrc/flash_attention.cu",
                     "replaces": kern["replaces"], "counter": kern["counter"],
                     "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms})
    torch.cuda.empty_cache()
    return rows


def _png_to_array(b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _check_image(arr: np.ndarray, what: str, size: int) -> None:
    if arr.shape != (size, size, 3) or arr.dtype != np.uint8:
        raise RuntimeError(f"{what}: expected ({size}, {size}, 3) uint8, got "
                           f"{arr.shape} {arr.dtype}")


def phase_tiny_reference() -> float:
    """The tiny preset's etainv+ptp edit on the card against the same edit on
    the CPU (fp32, TF32 off on both the matmul and the conv path)."""
    from eta_inversion_tpu_torch import load_editor, load_inverter
    from eta_inversion_tpu_torch.models import load_diffusion_model

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    img = np.random.RandomState(0).rand(1, 16, 16, 3).astype(np.float32) * 2 - 1
    cfg = dict(is_replace_controller=True, cross_replace_steps=0.8, self_replace_steps=0.5)
    outs = {}
    for dev in ("cuda", "cpu"):
        model, _ = load_diffusion_model("tiny", device=dev, seed=0)
        if dev == "cpu":  # same weights on both: copy the card's
            model.nets.load_state_dict(outs["weights"])

        def noise_fn(i, shape, dev=dev):  # same candidate noises on both devices
            draw = np.random.RandomState(1000 + i).randn(*shape).astype(np.float32)
            return torch.from_numpy(draw).to(dev)

        inv = load_inverter(model, "etainv", num_inference_steps=10,
                            eta=((0.6, 0.0), (1.0, 0.7)), noise_sample_count=4,
                            noise_fn=noise_fn)
        res = load_editor(inv, "ptp").edit(img, "a cat sitting", "a tiger sitting",
                                           cfg=dict(cfg), inv_cfg={"edit_word_idx": (1, 1)})
        outs[dev] = res["image"].float().cpu().numpy()
        if dev == "cuda":
            outs["weights"] = {k: v.cpu() for k, v in model.nets.state_dict().items()}
    err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"[serving] tiny etainv+ptp edit, card vs CPU: max_abs_err={err:.3e} "
        f"(bound {TINY_TOL})")
    if not err <= TINY_TOL:
        raise RuntimeError(f"tiny edit on the card disagrees with the CPU: {err}")
    return err


def phase_serving(steps: int) -> dict:
    from http.server import ThreadingHTTPServer

    from eta_inversion_tpu_torch import serve
    from eta_inversion_tpu_torch.serving import EditRequest

    args = serve.parse_args([
        "--model", "sd15", "--inverter", "etainv", "--editor", "ptp",
        "--steps", str(steps), "--dtype", "bfloat16", "--max_batch", "1",
        "--device", "cuda",
        "--inverter_kwargs", json.dumps({"eta": [[0.6, 0.0], [1.0, 0.7]],
                                         "noise_sample_count": 10})])
    t0 = time.monotonic()
    server, pre, post = serve.build_server(args)
    torch.cuda.synchronize()
    log(f"[serving] sd15 etainv+ptp server built in {time.monotonic() - t0:.1f} s "
        f"(random weights, seed 0, bf16), {steps} steps per edit"
        + ("" if steps == 50 else " (below the default 50 to fit the time limit)"))
    cfg = {"is_replace_controller": True, "cross_replace_steps": 0.8,
           "self_replace_steps": 0.5}
    inv_cfg = {"edit_word_idx": [1, 1]}
    rs = np.random.RandomState(1)
    images = [(rs.rand(512, 512, 3) * 255).astype(np.uint8) for _ in range(3)]
    prompts = [("a cat sitting next to a mirror", "a tiger sitting next to a mirror"),
               ("a dog running on the beach", "a wolf running on the beach"),
               ("a red car on a street", "a blue car on a street")]
    httpd = None
    try:
        # warm-up edit (cuBLAS/cuDNN plans, allocator); not counted
        server.edit(pre(images[0]), *prompts[0], cfg=cfg, inv_cfg=inv_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.monotonic()
        # two concurrent submits ...
        futs = [server.submit(EditRequest(pre(images[i]), *prompts[i], cfg=cfg,
                                          inv_cfg=inv_cfg)) for i in (0, 1)]
        # ... and one HTTP POST /v1/edit on 127.0.0.1
        serve.EditHandler.server_ctx = (server, pre, post)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.EditHandler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        png = io.BytesIO()
        from PIL import Image

        Image.fromarray(images[2]).save(png, "PNG")
        body, ctype = _multipart({"source_prompt": prompts[2][0],
                                  "target_prompt": prompts[2][1],
                                  "cfg": json.dumps(cfg), "inv_cfg": json.dumps(inv_cfg)},
                                 png.getvalue())
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/edit", data=body,
                                     headers={"Content-Type": ctype}, method="POST")
        with urllib.request.urlopen(req, timeout=900) as r:
            http_res = json.loads(r.read())
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = dict(fa.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        server.shutdown()
    if "image" not in http_res:
        raise RuntimeError(f"HTTP edit failed: {http_res}")
    for i, res in enumerate(results):
        if res is None:
            raise RuntimeError(f"edit {i} returned None")
        img = res["image"]
        if not torch.isfinite(img).all():
            raise RuntimeError(f"edit {i}: non-finite image")
        _check_image(post(img), f"edit {i}", 512)
    _check_image(_png_to_array(http_res["image"]), "HTTP edit", 512)
    log(f"[serving] 3 edits (2 concurrent submits + 1 HTTP POST) in {secs:.2f} s: "
        f"{secs / 3:.2f} s/edit; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    log(f"[serving] kernel launches during the edits: {json.dumps(counts)}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise RuntimeError(f"main path never launched: {missing}")
    return {"seconds_per_edit": secs / 3, "launches": counts, "peak_bytes": peak}


def _multipart(fields: dict, png: bytes):
    boundary = "----etainvsmoke"
    parts = []
    for k, v in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\""
                     f"\r\n\r\n{v}\r\n".encode())
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
                 f"filename=\"in.png\"\r\nContent-Type: image/png\r\n\r\n".encode()
                 + png + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--phases", default="device,build,kernels,serving")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    name = phase_device()
    if "build" in phases:
        phase_build()
    rows = phase_kernels() if "kernels" in phases else []
    launches = {}
    if "serving" in phases:
        phase_tiny_reference()
        launches = phase_serving(args.steps)["launches"]
    for r in rows:
        r["launches"] = launches.get(r.pop("counter"), 0)
    print(json.dumps({"kernels": rows}))
    if set(phases) != {"device", "build", "kernels", "serving"}:
        log(f"partial run ({args.phases}): no result line")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
