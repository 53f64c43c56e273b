"""Edit server: one dispatch thread runs queued edits in arrival order.

Counterpart of eta_inversion_tpu/serving.py at bucket 1: callers block on
futures while the dispatch thread (the only thread that touches the device)
runs ``editor.edit`` for one request at a time.  The JAX server's coalescing
into pair-batched ``edit_batch`` calls (buckets above 1) is not ported yet,
so a server given a bucket or ``max_batch`` above 1 raises ``ValueError``.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import torch


@dataclass(eq=False)
class EditRequest:
    """One edit: image is HWC or NHWC float in [-1, 1] (StablePreprocess
    output); cfg / inv_cfg follow Editor.edit.  Identity semantics (eq=False):
    a generated __eq__ would compare the image arrays."""

    image: Any
    source_prompt: str
    target_prompt: str
    cfg: Optional[Dict[str, Any]] = None
    inv_cfg: Optional[Dict[str, Any]] = None
    future: Future = field(default_factory=Future)


class BatchingEditServer:
    """Queue edit requests and run them, oldest first, on one dispatch thread.

        server = BatchingEditServer(editor)
        fut = server.submit(EditRequest(image, "a cat", "a tiger"))
        result = fut.result()      # {"image", "latent", ...}
        server.shutdown()
    """

    def __init__(self, editor, max_batch: int = 1, buckets: Sequence[int] = (1,),
                 sync_dispatch: bool = False):
        self.editor = editor
        # sync_dispatch: wait for the device to finish an edit before taking
        # the next one (by default the next edit's kernels may queue behind)
        self.sync_dispatch = bool(sync_dispatch)
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        if buckets[-1] > 1 or int(max_batch) > 1:
            raise ValueError("only bucket 1 is ported (pair-batched edit_batch is not): "
                             f"got buckets={buckets}, max_batch={max_batch}")
        self._queue: List[EditRequest] = []
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._closed = False
        self.stats: Dict[str, Any] = {"requests": 0, "edits": 0}
        self._thread = threading.Thread(target=self._dispatch_loop, name="edit-dispatch",
                                        daemon=True)
        self._thread.start()

    # ---- client side ----------------------------------------------------

    def submit(self, req: EditRequest) -> Future:
        with self._wakeup:
            if self._closed:
                raise RuntimeError("server is shut down")
            self._queue.append(req)
            self.stats["requests"] += 1
            self._wakeup.notify()
        return req.future

    def edit(self, image, source_prompt: str, target_prompt: str,
             cfg: Optional[Dict[str, Any]] = None, inv_cfg: Optional[Dict[str, Any]] = None,
             timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Blocking convenience wrapper with Editor.edit's signature."""
        fut = self.submit(EditRequest(image, source_prompt, target_prompt, cfg=cfg,
                                      inv_cfg=inv_cfg))
        return fut.result(timeout=timeout)

    def shutdown(self, wait: bool = True) -> None:
        with self._wakeup:
            self._closed = True
            self._wakeup.notify()
        if wait:
            self._thread.join()

    # ---- dispatch side ---------------------------------------------------

    def _take(self) -> Optional[EditRequest]:
        """Block until work exists; the oldest request, or None once closed
        and drained."""
        with self._wakeup:
            while not self._queue and not self._closed:
                self._wakeup.wait()
            return self._queue.pop(0) if self._queue else None

    def _dispatch_loop(self) -> None:
        # an exception escaping this loop would kill the one dispatch thread
        # and strand every queued future, so each edit is guarded
        while True:
            req = self._take()
            if req is None:
                return
            try:
                self._run(req)
            except Exception as exc:
                if not req.future.done():
                    req.future.set_exception(exc)

    def _run(self, req: EditRequest) -> None:
        with self._lock:
            self.stats["edits"] += 1
        image = torch.as_tensor(req.image).float()
        res = self.editor.edit(image if image.dim() == 4 else image[None],
                               req.source_prompt, req.target_prompt, cfg=req.cfg,
                               inv_cfg=req.inv_cfg)
        if res is not None and self.sync_dispatch and res["image"].is_cuda:
            torch.cuda.synchronize(res["image"].device)
        req.future.set_result(res)

    # ---- introspection ---------------------------------------------------

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self.stats, queue_depth=len(self._queue))
