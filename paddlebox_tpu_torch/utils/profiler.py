"""The non-finite guard's and the dump streams' helpers — the port's
copy of three pieces of ``utils/profiler.py``: ``find_nonfinite``,
``dump_tree`` and ``DumpStream``. The rest of the profiler (timers,
traces, step probes) is not ported yet (ROADMAP queue 1).

Trees are nested dicts, lists and tuples of NumPy arrays or tensors; a
leaf is named by JAX's ``keystr`` of its path (``['params']['mlp'][0]
['w']``), dict keys in sorted order, as the JAX package names them.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Iterable

import numpy as np


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
    by ``close``."""

    def __init__(self, path: str, mode: str = "w"):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._q: queue.Queue[str | tuple | None] = queue.Queue(maxsize=4096)
        self._error: BaseException | None = None
        self._f = open(path, mode)
        # pblint: disable=thread-context -- the port has no
        # monitor.context to inherit yet (ROADMAP queue 1 item 12): the
        # writer thread emits no telemetry
        self._thread = threading.Thread(target=self._drain,
                                        name="pbt-dump-writer", daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            job = self._q.get()
            if job is None:
                break
            if self._error is not None:      # after a write error: keep
                continue                     # consuming, write nothing
            try:
                if isinstance(job, str):
                    self._f.write(job)
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
