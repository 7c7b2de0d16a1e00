"""BatchingFrontend — the port of ``paddlebox_tpu/serving/frontend.py``
(``BatchingFrontend`` :50-…).

Callers :meth:`submit` single examples and get a Future. A dispatcher
thread coalesces up to ``max_batch`` requests (or what arrived within
``max_wait_s``), scores them once through the server and scatters the
results. The batch is scored at its own size: the reference pads to
``max_batch`` so that XLA compiles one shape, but eager PyTorch takes
any batch, and pad rows would only add host lookup work. A batch
mixing requests with and without dense features is split and each
group scored on its own. Per-request wall time (submit → result) lands in a time-windowed
reservoir; :meth:`stats` reports recent p50/p99/max, batch sizes and
failures. A submit racing :meth:`stop` never leaves a pending future.
Requests and failures count as ``serving.frontend_requests`` /
``serving.frontend_failures``. With ``flags.serving_trace_sample`` = N
every Nth batch's coalesce window is a ``serve/wait`` span, the queue
half of request latency (the server's ``serve/score`` is the other).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.serving.obs import LatencyWindow


class _Request:
    __slots__ = ("ids", "mask", "dense", "future", "t0")

    def __init__(self, ids, mask, dense):
        self.ids = ids
        self.mask = mask
        self.dense = dense
        self.future: Future = Future()
        self.t0 = time.perf_counter()


def _fail(r: _Request) -> None:
    """Resolve a request that will never be dispatched."""
    try:
        r.future.set_exception(
            RuntimeError("frontend stopped before dispatch"))
    # pblint: disable=silent-except -- lost the resolve race: the other
    # side (drain or dispatch) already set this future, which is the
    # outcome this failsafe exists to guarantee
    except Exception:   # noqa: BLE001
        pass


class BatchingFrontend:
    def __init__(self, server, *, max_batch: int = 256,
                 max_wait_s: float = 0.002, max_latencies: int = 100_000,
                 window_s: float | None = None):
        self.server = server
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._q: queue.Queue[_Request | None] = queue.Queue()
        # windowed: stats() reports RECENT traffic
        self._lat = LatencyWindow(
            float(flags.serving_window_s or 30.0)
            if window_s is None else float(window_s),
            cap=int(max_latencies))
        self._lat_lock = threading.Lock()
        self._batches = 0
        self._gathers = 0          # coalesce windows, for the span sample
        self._batched_reqs = 0
        self._failures = 0
        self._inflight = 0                 # submitted, not yet resolved
        self._inflight_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stopping = False

    # ---- client side -----------------------------------------------------

    def submit(self, ids: np.ndarray, mask: np.ndarray,
               dense: np.ndarray | None = None) -> Future:
        """One example: ids uint64 (T,), mask bool (T,), dense f32 (F,).
        Resolves to its probability (a scalar, or (tasks,))."""
        if self._thread is None:
            raise RuntimeError("frontend not started (call start())")
        r = _Request(np.asarray(ids), np.asarray(mask, bool),
                     None if dense is None else np.asarray(dense,
                                                           np.float32))
        # registered before the put: dispatch may resolve it first
        with self._inflight_lock:
            self._inflight += 1
        r.future.add_done_callback(self._dec_inflight)
        self._q.put(r)
        # stop() may have drained the queue between the thread check and
        # the put: a request in a dead queue would block its caller
        if self._stopping:
            _fail(r)
        return r.future

    def score(self, ids, mask, dense=None, timeout: float = 30.0):
        """Blocking :meth:`submit`."""
        return self.submit(ids, mask, dense).result(timeout=timeout)

    def _dec_inflight(self, _f) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        """Requests submitted and not yet resolved."""
        return self._inflight

    # ---- dispatcher ------------------------------------------------------

    def start(self) -> "BatchingFrontend":
        if self._thread is not None:
            return self
        self._stopping = False
        self._thread = mon_ctx.spawn(self._run, name="serving-frontend")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stopping = True
        self._q.put(None)              # wake the dispatcher
        self._thread.join(timeout=30)
        self._thread = None
        # fail what is still queued: no caller may block forever
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None and not r.future.done():
                _fail(r)

    def _gather(self) -> list[_Request]:
        """Block for the first request, then coalesce until max_batch or
        the max_wait deadline."""
        first = self._q.get()
        if first is None:
            return []
        # sampled request tracing: every Nth batch's coalesce window is a
        # serve/wait span. 0 = one flag check
        self._gathers += 1
        n = int(flags.serving_trace_sample)
        ctx = (monitor.span("serve/wait", max_batch=self.max_batch)
               if n > 0 and self._gathers % n == 0
               else contextlib.nullcontext())
        with ctx:
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    r = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if r is None:
                    break
                batch.append(r)
        return batch

    def _run(self) -> None:
        while not self._stopping:
            batch = self._gather()
            if not batch:
                continue
            # dense presence changes the predict signature: a mixed batch
            # is dispatched as its two homogeneous groups
            with_dense = [r for r in batch if r.dense is not None]
            without = [r for r in batch if r.dense is None]
            for group in (with_dense, without):
                if group:
                    self._dispatch(group)

    def _dispatch(self, batch: list[_Request]) -> None:
        # claim each future before scoring: one cancelled while queued
        # drops out, and a later cancel() is a no-op
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        n = len(batch)
        try:
            ids = np.stack([r.ids for r in batch])
            mask = np.stack([r.mask for r in batch])
            dense = (np.stack([r.dense for r in batch])
                     if batch[0].dense is not None else None)
            out = self.server.predict(ids, mask, dense)
        except Exception as e:   # noqa: BLE001 — fails this batch only
            self._failures += n
            monitor.counter_add("serving.frontend_failures", n)
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        now = time.perf_counter()
        wall = time.time()
        lats = [(now - r.t0) * 1e3 for r in batch]
        with self._lat_lock:
            for ms in lats:
                self._lat.add(ms, now=wall)
        self._batches += 1
        self._batched_reqs += n
        monitor.counter_add("serving.frontend_requests", n)
        for i, r in enumerate(batch):
            r.future.set_result(out[i])

    # ---- accounting ------------------------------------------------------

    def stats(self) -> dict:
        """count/failures are cumulative while the latency window holds
        samples, and the percentiles cover that window; an empty window
        (an idle spell) reports a count of 0 and no percentiles, as the
        reference does."""
        with self._lat_lock:
            snap = self._lat.snapshot()
        if not snap["count"]:
            return {"count": 0, "failures": int(self._failures)}
        return {
            "count": int(self._batched_reqs),
            "failures": int(self._failures),
            "batches": int(self._batches),
            "mean_batch": round(self._batched_reqs
                                / max(self._batches, 1), 2),
            "window_count": int(snap["count"]),
            "p50_ms": round(snap["p50_ms"], 3),
            "p99_ms": round(snap["p99_ms"], 3),
            "max_ms": round(snap["max_ms"], 3),
        }
