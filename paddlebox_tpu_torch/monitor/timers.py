"""Per-stage wall-clock timers, hub-aware — the port's copy of
``paddlebox_tpu/monitor/timers.py``.

The reference instruments every per-card stage: read/trans/cal/sync/main
times printed by ``log_for_profile`` (boxps_worker.cc:746-759) plus the
pull/push/dense-sync timers in DeviceBoxData (box_wrapper.h:375-391).
``StageTimers`` is that instrument, moved under the telemetry hub: totals
feed the per-pass flight record's stage split (the trainer diffs them at
pass boundaries), and when the hub's event stream is on each stage scope
additionally emits a tagged span event — so the "read" wait, the pack
thread's "translate", and the post-loop "drain" all land in the JSONL
with their pass/step identity. While a ``torch.profiler`` session runs,
each scope also opens the range ``pbt/<stage>`` on the profiler's clock,
so a device trace names the host work around each idle gap. Disabled
cost: two global checks per scope (the hub's, the profiler's).
"""

from __future__ import annotations

import importlib
import time

from paddlebox_tpu_torch.monitor.hub import _HUB, _Span

# the module itself: its profiler gate is rebound when torch loads (the
# package's ``hub`` attribute is the accessor function)
_hub = importlib.import_module("paddlebox_tpu_torch.monitor.hub")


class _Scope:
    """One timed entry into a stage. ``seconds`` holds its wall time once
    it has closed."""

    __slots__ = ("_timers", "_stage", "_span", "_range", "_t0", "seconds")

    def __init__(self, timers: "StageTimers", stage: str, span):
        self._timers = timers
        self._stage = stage
        self._span = span
        self.seconds = 0.0

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()          # the span opens the range
        else:
            self._range = (_hub.open_range(self._stage)
                           if _hub._torch_profiler._is_profiler_enabled
                           else None)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = self.seconds = time.perf_counter() - self._t0
        t, stage = self._timers, self._stage
        t.total[stage] = t.total.get(stage, 0.0) + dt
        t.count[stage] = t.count.get(stage, 0) + 1
        if self._span is not None:
            self._span.__exit__(*exc)
            return False
        if self._range is not None:
            self._range.__exit__(None, None, None)
        h = _HUB
        if h._enabled and (t._emit_stages is None
                           or stage in t._emit_stages):
            rec = h._record("span", f"{t._emit_prefix}/{stage}", None)
            rec["dur_s"] = dt
            h._dispatch(rec)
        return False


class StageTimers:
    def __init__(self, stages: list[str], emit_prefix: str = "stage",
                 emit_stages: set | None = None,
                 spans: dict[str, str] | None = None):
        """``emit_stages``: stages whose scopes emit hub span events
        ``<emit_prefix>/<stage>`` (None = all). ``spans``: stages whose
        scope is also a ``monitor.span`` of the given name (the trainer's
        "train" is its ``train_step`` span): one scope keeps the stage's
        total, emits the span under its own name and opens one range,
        ``pbt/<stage>``. Totals accumulate for EVERY stage regardless."""
        self.total: dict[str, float] = {s: 0.0 for s in stages}
        self.count: dict[str, int] = {s: 0 for s in stages}
        self._emit_prefix = emit_prefix
        self._emit_stages = emit_stages
        self._spans = spans or {}

    def __call__(self, stage: str) -> _Scope:
        name = self._spans.get(stage)
        return _Scope(self, stage, None if name is None
                      else _Span(_HUB, name, {}, range_name=stage))

    def snapshot(self) -> dict[str, float]:
        """Current totals (the flight record's stage-split input)."""
        return dict(self.total)
