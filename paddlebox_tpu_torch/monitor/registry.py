"""Process-global stat counters — the port's copy of
``paddlebox_tpu/monitor/registry.py`` (platform/monitor.h's
``StatRegistry``).

Counters stay process-CUMULATIVE, like the reference's ``STAT_ADD``
globals; the hub derives per-pass deltas by snapshotting at pass
boundaries (see :meth:`TelemetryHub.begin_pass`). ``utils.profiler``
re-exports ``StatRegistry`` / ``STATS`` / ``stat_add`` as shims.
"""

from __future__ import annotations

import threading


class StatRegistry:
    """Thread-safe named counters (monitor.h:76 StatRegistry singleton)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, float] = {}

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._stats[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._stats.get(name, 0.0)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._stats)

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        snap = self.snapshot()
        return " ".join(f"{k}={snap[k]:g}" for k in sorted(snap))


STATS = StatRegistry()            # process-global, like the reference
