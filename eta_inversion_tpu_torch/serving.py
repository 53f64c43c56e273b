"""Dynamic-batching edit server: the serving tier.

Counterpart of eta_inversion_tpu/serving.py.  Callers block on futures while
one dispatch thread (the only thread that touches the device) turns the
arrival process into pair-batched edits:

- Requests are coalesced for at most ``max_wait_ms`` after the oldest one
  arrived, or until ``max_batch`` are queued, whichever comes first.
- A group is padded up to a bucket size (default 1/2/4/8) by repeating its
  last request, so the card sees a handful of batch shapes.
- Requests whose scalar ptp options disagree cannot share one controller
  (editing/batched.py::_merged_ptp_cfg), so the batcher groups them by a
  compatibility key and runs the oldest request's group first.
- Bucket 1 runs ``editor.edit``; larger buckets ``edit_batch``, whose B rows
  run the same kernel routes as B = 1 at a larger batch.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .editing.batched import SCALAR_PTP_KEYS, edit_batch


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
    enqueued_at: float = field(default_factory=time.monotonic)

    def compat_key(self) -> Tuple:
        """Requests with equal keys may share a batch."""
        cfg = self.cfg or {}
        return tuple((k, cfg.get(k)) for k in SCALAR_PTP_KEYS)


class BatchingEditServer:
    """Coalesce concurrent edit requests into bucketed batched edits.

        server = BatchingEditServer(editor, max_batch=8, max_wait_ms=50)
        fut = server.submit(EditRequest(image, "a cat", "a tiger"))
        result = fut.result()      # {"image", "latent", ...} sliced to B = 1
        server.shutdown()
    """

    def __init__(self, editor, max_batch: int = 8, max_wait_ms: float = 50.0,
                 buckets: Sequence[int] = (1, 2, 4, 8), sync_dispatch: bool = False):
        self.editor = editor
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        # sync_dispatch: wait for the device to finish a group before taking
        # the next one (by default the next group's kernels may queue behind)
        self.sync_dispatch = bool(sync_dispatch)
        self.buckets = sorted(set(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        if not 1 <= self.max_batch <= self.buckets[-1]:
            raise ValueError(f"max_batch={self.max_batch} must be servable by the largest "
                             f"bucket, {self.buckets[-1]}")
        self._queue: List[EditRequest] = []
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._closed = False
        # dispatch_sizes counts dispatches by bucket (a long-running server's
        # stats do not grow)
        self.stats: Dict[str, Any] = {"requests": 0, "batches": 0, "padded_slots": 0,
                                      "dispatch_sizes": {}}
        self._thread = threading.Thread(target=self._dispatch_loop, name="edit-batcher",
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

    def _take_group(self) -> Optional[List[EditRequest]]:
        """Block until work exists, coalesce up to max_wait / max_batch, then
        return the oldest request's compatibility group (FIFO fairness); None
        once closed and drained."""
        with self._wakeup:
            while not self._queue and not self._closed:
                self._wakeup.wait()
            if not self._queue:
                return None
            deadline = self._queue[0].enqueued_at + self.max_wait_s
            while len(self._queue) < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._wakeup.wait(timeout=remaining)
            key = self._queue[0].compat_key()
            group = [r for r in self._queue if r.compat_key() == key][: self.max_batch]
            taken = {id(r) for r in group}
            self._queue = [r for r in self._queue if id(r) not in taken]
            return group

    def _bucket(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def _dispatch_loop(self) -> None:
        # an exception escaping this loop would kill the one dispatch thread
        # and strand every queued future, so the whole body is guarded
        while True:
            group: Optional[List[EditRequest]] = None
            try:
                group = self._take_group()
                if group is None:
                    return
                self._run_group(group)
            except Exception as exc:
                for r in group or ():
                    if not r.future.done():
                        r.future.set_exception(exc)
                if group is None:  # _take_group failed: fail what is queued
                    with self._lock:
                        stranded, self._queue = self._queue, []
                    for r in stranded:
                        if not r.future.done():
                            r.future.set_exception(exc)

    def _run_group(self, group: List[EditRequest]) -> None:
        n = len(group)
        bucket = self._bucket(n)
        reqs = group + [group[-1]] * (bucket - n)  # pad with repeats
        with self._lock:
            self.stats["batches"] += 1
            self.stats["padded_slots"] += bucket - n
            sizes = self.stats["dispatch_sizes"]
            sizes[bucket] = sizes.get(bucket, 0) + 1
        images = [torch.as_tensor(r.image).float() for r in reqs]
        images = torch.cat([x if x.dim() == 4 else x[None] for x in images])
        if bucket == 1:
            r = reqs[0]
            res = self.editor.edit(images, r.source_prompt, r.target_prompt, cfg=r.cfg,
                                   inv_cfg=r.inv_cfg)
        else:
            res = edit_batch(self.editor, images, [r.source_prompt for r in reqs],
                             [r.target_prompt for r in reqs], cfgs=[r.cfg for r in reqs],
                             inv_cfgs=[r.inv_cfg for r in reqs])
        if res is not None and self.sync_dispatch and res["image"].is_cuda:
            torch.cuda.synchronize(res["image"].device)
        for i, r in enumerate(group):
            # None: an unsupported combination, Editor.edit's contract
            r.future.set_result(None if res is None else {k: v[i: i + 1] for k, v in res.items()})

    # ---- introspection ---------------------------------------------------

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            s = dict(self.stats, dispatch_sizes=dict(self.stats["dispatch_sizes"]),
                     queue_depth=len(self._queue))
            if s["batches"]:
                s["mean_batch"] = s["requests"] / s["batches"]
            return s
