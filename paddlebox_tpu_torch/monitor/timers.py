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
with their pass/step identity. Disabled cost: one global check per scope
(``utils.timer`` re-exports this class for back-compat).
"""

from __future__ import annotations

import contextlib
import time

from paddlebox_tpu_torch.monitor.hub import _HUB


class StageTimers:
    def __init__(self, stages: list[str], emit_prefix: str = "stage",
                 emit_stages: set | None = None):
        """``emit_stages``: stages whose scopes emit hub span events (None
        = all). Totals accumulate for EVERY stage regardless — callers
        exclude stages another span already covers (e.g. the trainer's
        "train" scope wraps the same interval as its ``train_step`` span)
        so the hot loop never double-emits one measurement."""
        self.total: dict[str, float] = {s: 0.0 for s in stages}
        self.count: dict[str, int] = {s: 0 for s in stages}
        self._emit_prefix = emit_prefix
        self._emit_stages = emit_stages

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            dt = t1 - t0
            self.total[stage] = self.total.get(stage, 0.0) + dt
            self.count[stage] = self.count.get(stage, 0) + 1
            h = _HUB
            if h._enabled and (self._emit_stages is None
                               or stage in self._emit_stages):
                rec = h._record("span", f"{self._emit_prefix}/{stage}",
                                None)
                rec["dur_s"] = dt
                h._dispatch(rec)

    def mean(self, stage: str) -> float:
        c = self.count.get(stage, 0)
        return self.total.get(stage, 0.0) / c if c else 0.0

    def snapshot(self) -> dict[str, float]:
        """Current totals (the flight record's stage-split input)."""
        return dict(self.total)

    def report(self) -> str:
        """One log_for_profile-style line."""
        parts = [f"{s}={self.total[s]:.3f}s/{self.count[s]}"
                 for s in self.total]
        return " ".join(parts)

    def reset(self) -> None:
        for s in self.total:
            self.total[s] = 0.0
            self.count[s] = 0
