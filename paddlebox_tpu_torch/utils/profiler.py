"""Tracing, counters, the non-finite guard and the dump streams — the
port of ``paddlebox_tpu/utils/profiler.py``.

- ``RecordEvent`` spans and chrome-trace timelines (platform/profiler.cc
  RecordEvent; device_tracer.cc:815): spans collected by a process-global
  profiler into a bounded ring (``flags.profiler_max_events``, oldest
  dropped first, ``profiler.dropped_spans`` counts them), tagged with the
  current pass/step (``monitor.context``), with ``record_instant``
  markers at pass boundaries and checkpoint commits, and written by
  :func:`export_chrome_trace`. The device-side trace is
  ``torch.profiler`` with CUDA activity (:func:`start_device_trace`) —
  CUPTI's role, as ``jax.profiler`` plays it in the JAX package; its
  Chrome trace names the CUDA kernels, and the pass markers recorded
  while it runs land in it as ranges.
- global stat counters (platform/monitor.h ``STAT_ADD``): the registry
  lives in :mod:`paddlebox_tpu_torch.monitor.registry`; ``stat_add`` /
  ``stat_get`` / ``stat_set`` here are shims over the same object.
- the non-finite guard's helpers, :func:`find_nonfinite` and
  :func:`dump_tree`, and :class:`DumpStream` (DumpField / DumpParam).

Trees are nested dicts, lists and tuples of NumPy arrays or tensors; a
leaf is named by JAX's ``keystr`` of its path (``['params']['mlp'][0]
['w']``), dict keys in sorted order, as the JAX package names them.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
from typing import Any, Iterable

import numpy as np

from paddlebox_tpu_torch.config import flags as _flags
from paddlebox_tpu_torch.monitor import context as _mon_ctx
from paddlebox_tpu_torch.monitor.registry import STATS, StatRegistry  # noqa: F401

# ---------------------------------------------------------------------------
# RecordEvent spans + chrome trace
# ---------------------------------------------------------------------------

_events: collections.deque = collections.deque()
_events_lock = threading.Lock()
_enabled = False
_dropped = 0
_t0 = time.perf_counter()
# the torch.profiler session of start_device_trace, and where it writes
_device_trace: Any = None
_device_trace_path: str | None = None


def enable_profiler() -> None:
    """Start collecting RecordEvent spans (profiler.cc EnableProfiler)."""
    global _enabled, _t0, _dropped
    with _events_lock:
        _events.clear()
        _dropped = 0
        _t0 = time.perf_counter()
    _enabled = True


def disable_profiler() -> None:
    global _enabled
    _enabled = False


def profiler_events() -> list[dict]:
    with _events_lock:
        return list(_events)


def dropped_spans() -> int:
    """Spans evicted from the ring since enable_profiler()."""
    return _dropped


def _append_event(ev: dict) -> None:
    global _dropped
    cap = _flags.profiler_max_events
    with _events_lock:
        if cap and len(_events) >= cap:
            _events.popleft()
            _dropped += 1
            STATS.add("profiler.dropped_spans", 1)
        _events.append(ev)


def _ctx_args(extra: dict | None = None) -> dict | None:
    """pass/step tags for a chrome event (None outside a pass, no args key)."""
    c = _mon_ctx.current()
    if c.pass_id is None and not extra:
        return None
    args = {} if c.pass_id is None else {"pass_id": c.pass_id,
                                         "step": c.step}
    if extra:
        args.update(extra)
    return args


def record_span(name: str, start: float, end: float,
                args: dict | None = None) -> None:
    """Record one complete span (perf_counter endpoints). Spans that
    straddle an enable_profiler() reset belong to neither trace."""
    if not _enabled or start < _t0:
        return
    ev = {
        "name": name,
        "ph": "X",
        "ts": (start - _t0) * 1e6,        # chrome trace is in µs
        "dur": (end - start) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
    }
    a = _ctx_args(args)
    if a:
        ev["args"] = a
    _append_event(ev)


def record_instant(name: str, args: dict | None = None) -> None:
    """Record a chrome-trace instant marker (``ph: i``): pass boundaries
    and checkpoint commits, so a timeline reads in pass units. While a
    device trace runs, the marker also lands in it as a zero-length
    ``record_function`` range."""
    if _device_trace is not None:
        import torch
        with torch.profiler.record_function(name):
            pass
    if not _enabled:
        return
    ev = {
        "name": name,
        "ph": "i",
        "s": "g",                          # global-scope instant line
        "ts": (time.perf_counter() - _t0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
    }
    a = _ctx_args(args)
    if a:
        ev["args"] = a
    _append_event(ev)


class RecordEvent:
    """Named span: context manager or decorator. ``with
    RecordEvent("translate"): ...`` records a complete event when the
    profiler is enabled; negligible cost when disabled. (Spans that
    should also reach the telemetry stream use ``monitor.span``, which
    forwards here when the profiler is on.)"""

    def __init__(self, name: str):
        self.name = name
        self._start: float | None = None

    def __enter__(self):
        # latch enabled-ness here: a span half-open when the profiler
        # flips on is skipped, not emitted with a garbage start
        self._start = time.perf_counter() if _enabled else None
        return self

    def __exit__(self, *exc):
        if _enabled and self._start is not None:
            record_span(self.name, self._start, time.perf_counter())
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with RecordEvent(self.name):
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", self.name)
        return wrapped


def export_chrome_trace(path: str) -> int:
    """Write the collected spans and instant markers as a
    chrome://tracing / Perfetto JSON file (atomically: a crash mid-export
    leaves no torn trace under the final name). Returns the number of
    events written."""
    from paddlebox_tpu_torch.utils.checkpoint import atomic_file
    evs = profiler_events()
    with atomic_file(path) as tmp:
        with open(tmp, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return len(evs)


def start_device_trace(logdir: str, device=None) -> None:
    """Begin a device-level trace: ``torch.profiler`` with CPU and CUDA
    activity (CUPTI), the counterpart of the JAX package's
    ``jax.profiler.start_trace``. Runs on the card unless ``device="cpu"``
    (host activity only); :func:`stop_device_trace` writes the Chrome
    trace to ``<logdir>/trace.json``."""
    global _device_trace, _device_trace_path
    import torch

    from paddlebox_tpu_torch.device import resolve_device
    if _device_trace is not None:
        raise RuntimeError("a device trace is already running")
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    os.makedirs(logdir, exist_ok=True)
    _device_trace, _device_trace_path = prof, os.path.join(logdir,
                                                           "trace.json")


def stop_device_trace() -> str:
    """End the device trace and write its Chrome trace; returns the
    file's path."""
    global _device_trace, _device_trace_path
    prof, path = _device_trace, _device_trace_path
    if prof is None:
        raise RuntimeError("no device trace is running")
    _device_trace = _device_trace_path = None
    prof.__exit__(None, None, None)
    prof.export_chrome_trace(path)
    return path


# ---------------------------------------------------------------------------
# StatRegistry shims (platform/monitor.h); new call sites use
# monitor.counter_add / gauge_set
# ---------------------------------------------------------------------------

def stat_add(name: str, value: float = 1.0) -> None:  # STAT_ADD(name, v)
    STATS.add(name, value)


def stat_get(name: str) -> float:
    return STATS.get(name)


def stat_set(name: str, value: float) -> None:
    STATS.set(name, value)


# ---------------------------------------------------------------------------
# the non-finite guard and the dump streams
# ---------------------------------------------------------------------------


def host_array(leaf) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_keystr(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_keystr(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_keystr(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def find_nonfinite(tree: Any) -> list[str]:
    """Paths of the leaves holding nan/inf (empty: all finite)."""
    bad = []
    for path, leaf in _flatten_keystr(tree):
        arr = host_array(leaf)
        if (np.issubdtype(arr.dtype, np.floating)
                and not np.isfinite(arr).all()):
            bad.append(path)
    return bad


def dump_tree(path: str, tree: Any) -> str:
    """Snapshot a tree to ``<path>.npz``, one member per leaf named by its
    path (the dump-all-scope of the non-finite trip). Returns the file
    written."""
    flat = {p: host_array(leaf) for p, leaf in _flatten_keystr(tree)}
    out = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **flat)
    return out


def _col_formatter(v):
    """Per-instance formatter of one dump column, run on the writer
    thread: a 1-D array (a scalar an instance), a 2-D array (a
    multi-value float slot, comma-joined) or an ``(ids, mask)`` pair (a
    sparse slot, the masked ids comma-joined)."""
    if isinstance(v, tuple):
        ids, mask = v
        return lambda i: ",".join(
            str(x) for x, ok in zip(ids[i], mask[i]) if ok)
    if getattr(v, "ndim", 1) >= 2:
        return lambda i: ",".join(f"{x:g}" for x in v[i])
    return lambda i: f"{v[i]}"


class DumpStream:
    """Background-thread line dumper (DumpField / DumpParam).

    The trainer enqueues lines and per-batch field jobs; a writer thread
    formats and writes them to ``path``. A write error stops the writing
    (the queue keeps draining, so producers never block) and is raised
    by ``close``. The writer inherits the spawner's pass/step context
    (``monitor.context.spawn``), so its ``dump_stream.lines`` counts and
    ``dump_fields_written`` events are tagged with the pass dumped."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._q: queue.Queue[str | tuple | None] = queue.Queue(maxsize=4096)
        self._error: BaseException | None = None
        self._f = open(path, mode)
        self._thread = _mon_ctx.spawn(self._drain, name="pbt-dump-writer")
        self._thread.start()

    def _drain(self):
        from paddlebox_tpu_torch.monitor.hub import _HUB
        while True:
            job = self._q.get()
            if job is None:
                break
            if self._error is not None:      # after a write error: keep
                continue                     # consuming, write nothing
            try:
                if isinstance(job, str):
                    self._f.write(job)
                    STATS.add("dump_stream.lines", 1)
                else:                        # a write_fields job
                    step, preds, labels, cols = job
                    fmts = {k: _col_formatter(v) for k, v in cols.items()}
                    out = []
                    for i in range(len(preds)):
                        tail = "".join(f" {k}:{fmt(i)}"
                                       for k, fmt in fmts.items())
                        out.append(f"{step} {i} {preds[i]:.6f} "
                                   f"{labels[i]:g}{tail}\n")
                    self._f.write("".join(out))
                    STATS.add("dump_stream.lines", len(out))
                    if _HUB._enabled:        # tagged from THIS thread
                        _HUB.event("dump_fields_written", lines=len(out),
                                   dump_step=int(step))
            except BaseException as e:       # raised by close()
                self._error = e

    def write(self, line: str) -> None:
        if not line.endswith("\n"):
            line += "\n"
        self._q.put(line)

    def write_fields(self, step: int, preds: Iterable[float],
                     labels: Iterable[float],
                     extra: dict[str, Any] | None = None) -> None:
        """Per-instance dump: ``step <i> pred label [k:v ...]`` lines.
        Only the copy to the host happens here; the per-instance string
        formatting runs on the writer thread."""
        preds = host_array(preds).reshape(-1)
        labels = host_array(labels).reshape(-1)

        def col(v):
            if isinstance(v, tuple):         # (ids, mask) sparse slot pair
                return tuple(host_array(x) for x in v)
            v = host_array(v)
            return v if getattr(v, "ndim", 1) >= 2 else v.reshape(-1)

        cols = {k: col(v) for k, v in (extra or {}).items()}
        self._q.put((int(step), preds, labels, cols))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._f.close()
        if self._error is not None:
            raise RuntimeError(
                f"DumpStream writer failed for {self.path}") from self._error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
