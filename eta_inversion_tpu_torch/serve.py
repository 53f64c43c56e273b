"""Edit-serving CLI on the card: a batching HTTP front end.

Counterpart of the repository's serve.py for the PyTorch port:

    python -m eta_inversion_tpu_torch.serve --model sd15 --inverter etainv \
        --editor ptp --steps 50 --max_batch 8 --max_wait_ms 50 --port 8000 \
        --inverter_kwargs '{"eta": [[0.6, 0.0], [1.0, 0.7]], "noise_sample_count": 10}'
    python -m eta_inversion_tpu_torch.serve --model sd15 --inverter nti \
        --editor ptp --inverter_kwargs '{"num_inner_steps": 10}'

API:
  POST /v1/edit   multipart form: image (png/jpg file), source_prompt,
                  target_prompt, optional cfg / inv_cfg (JSON strings)
                  -> {"image": <base64 png>, "latency_s": ...}
  GET  /v1/stats  -> requests, batches, padded slots, dispatches by bucket,
                  mean batch and queue depth
  GET  /healthz   -> 200 once the model is loaded

Concurrent requests are coalesced (serving.BatchingEditServer): for up to
--max_wait_ms after the oldest one arrived, or until --max_batch (at most 8)
are queued, then padded to a bucket of 1, 2, 4 or 8 pairs; bucket 1 runs
editor.edit, the others one pair-batched edit (editing/batched.edit_batch).
--dtype is bfloat16 (the default) or float32: on the card fp32 attention
runs on the TF32 tensor cores: up to head dim 128 on the TF32 modes of the
narrow forward and backward, above it on csrc/flash_attention_bwd_tf32.cu
(ops/flash_attention.py).  Weights are a seeded random init.  --model is
any of the port's presets: sd15, sd21 (512 px), sd21v (768 px,
v-prediction), sdxl (1024 px) and their tiny homologues.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import time
from email import message_from_bytes
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .serving import BatchingEditServer

# the batch sizes the server pads a group to
BUCKETS = (1, 2, 4, 8)


def parse_multipart(headers, body: bytes):
    """Multipart form -> {name: str value | bytes for files} via the stdlib
    email parser."""
    msg = message_from_bytes(
        b"Content-Type: " + headers.get("Content-Type", "").encode() +
        b"\r\nMIME-Version: 1.0\r\n\r\n" + body, policy=HTTP)
    out = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        if part.get_filename():
            out[name] = payload
        else:
            out[name] = payload.decode("utf-8", "replace").strip()
    return out


def build_server(args):
    from . import load_editor, load_inverter
    from .models import load_diffusion_model

    model, (pre, post) = load_diffusion_model(args.model, dtype=args.dtype,
                                              seed=args.seed, device=args.device)
    inverter = load_inverter(model, args.inverter, num_inference_steps=args.steps,
                             **json.loads(args.inverter_kwargs))
    editor = load_editor(inverter, args.editor)
    server = BatchingEditServer(editor, max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms, buckets=BUCKETS,
                                sync_dispatch=args.sync_dispatch)
    return server, pre, post


class EditHandler(BaseHTTPRequestHandler):
    server_ctx = None  # (BatchingEditServer, pre, post), set by main()

    def _json(self, obj, status=200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        batcher, _, _ = type(self).server_ctx
        if self.path == "/healthz":
            self._json({"ok": True})
        elif self.path == "/v1/stats":
            self._json(batcher.stats_snapshot())
        else:
            self._json({"error": "not found"}, status=404)

    def do_POST(self):
        if self.path != "/v1/edit":
            self._json({"error": "not found"}, status=404)
            return
        batcher, pre, post = type(self).server_ctx
        length = int(self.headers.get("Content-Length", "0"))
        form = parse_multipart(self.headers, self.rfile.read(length))

        from PIL import Image, UnidentifiedImageError

        if not form.get("image"):
            self._json({"error": "missing required form field 'image'"}, status=400)
            return
        try:
            img = Image.open(io.BytesIO(form["image"])).convert("RGB")
        except (UnidentifiedImageError, OSError):
            self._json({"error": "field 'image' is not a decodable image"}, status=400)
            return
        cfgs = {}
        for key in ("cfg", "inv_cfg"):
            if form.get(key):
                try:
                    cfgs[key] = json.loads(form[key])
                except (json.JSONDecodeError, UnicodeDecodeError):
                    self._json({"error": f"field '{key}' is not valid JSON"}, status=400)
                    return
        try:
            t0 = time.monotonic()
            res = batcher.edit(pre(img), form.get("source_prompt", ""),
                               form.get("target_prompt", ""),
                               cfg=cfgs.get("cfg"), inv_cfg=cfgs.get("inv_cfg"))
            if res is None:
                self._json({"error": "unsupported inverter/editor combo"}, status=422)
                return
            png = io.BytesIO()
            Image.fromarray(post(res["image"])).save(png, "PNG")
            self._json({"image": base64.b64encode(png.getvalue()).decode(),
                        "latency_s": round(time.monotonic() - t0, 4)})
        except Exception as e:  # the handler thread must answer every request
            self._json({"error": f"internal error: {type(e).__name__}"}, status=500)

    def log_message(self, fmt, *args):
        pass


def parse_args(argv=None):
    from .models import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="sd15", choices=sorted(PRESETS),
                    help="model preset (random weights)")
    ap.add_argument("--inverter", default="etainv")
    ap.add_argument("--editor", default="ptp")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--max_batch", type=int, default=8,
                    help=f"most requests a dispatch takes, up to {BUCKETS[-1]} (groups are "
                         f"padded to a bucket of {BUCKETS})")
    ap.add_argument("--max_wait_ms", type=float, default=50.0,
                    help="longest time the oldest queued request waits for others to "
                         "batch with")
    ap.add_argument("--sync_dispatch", action="store_true",
                    help="wait for the card to finish each dispatch before the next")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--inverter_kwargs", default="{}",
                    help="JSON object of extra inverter arguments (e.g. eta)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    batcher, pre, post = build_server(args)
    EditHandler.server_ctx = (batcher, pre, post)
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), EditHandler)
    print(f"serving {args.model}/{args.inverter}/{args.editor} on {args.device} "
          f"at http://127.0.0.1:{args.port} (max_batch={args.max_batch})")
    try:
        httpd.serve_forever()
    finally:
        batcher.shutdown()


if __name__ == "__main__":
    main()
