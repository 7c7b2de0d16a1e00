"""Serving-side observability — the port of
``paddlebox_tpu/serving/obs.py`` (``LatencyWindow``, ``VersionStats``,
``score_kl``, ``ServingObs`` :51-…).

- :class:`LatencyWindow`: a time-windowed latency reservoir, so a
  swap-induced p99 step shows once old samples age out.
- :class:`VersionStats`: one served version's window — request count,
  latency, a score histogram (for the candidate-vs-stable KL) and a
  bounded FIFO of pending scores that delayed labels join back to.
- :class:`ServingObs`: the server's per-window bookkeeping: ``record``
  per scored batch, ``observe_labels`` when labels arrive,
  ``due`` / ``commit`` on the window cadence. ``commit`` returns the
  ``serving_window`` record's fields, which the server emits as a hub
  event; the doctor's serving rules (``monitor/doctor.py``) read them.

No thread of its own: the callers hold one lock around every call.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.metrics.metric import MetricRegistry

# score-histogram geometry for the candidate-vs-stable divergence: 20
# equal buckets over [0, 1), and the epsilon that keeps KL finite when a
# bucket is empty on one side
SCORE_BUCKETS = 20
_KL_EPS = 1e-6

# bounded pending-score FIFO per version: labels more than this many
# batches late are dropped (and counted)
MAX_PENDING_BATCHES = 64


class LatencyWindow:
    """Time-windowed latency reservoir. Capped: past ``cap`` samples the
    oldest drop first."""

    def __init__(self, window_s: float = 30.0, cap: int = 100_000):
        self.window_s = float(window_s)
        self._cap = int(cap)
        self._samples: collections.deque = collections.deque()

    def add(self, ms: float, now: float | None = None) -> None:
        now = time.time() if now is None else now
        self._samples.append((now, float(ms)))
        while len(self._samples) > self._cap:
            self._samples.popleft()

    def prune(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def snapshot(self, now: float | None = None) -> dict:
        """{"count", "p50_ms", "p99_ms", "max_ms"} over the window
        (count 0 and no percentiles when it is empty)."""
        self.prune(now)
        if not self._samples:
            return {"count": 0}
        lats = np.asarray([ms for _, ms in self._samples])
        return {"count": int(lats.size),
                "p50_ms": float(np.percentile(lats, 50)),
                "p99_ms": float(np.percentile(lats, 99)),
                "max_ms": float(lats.max())}

    def hedge_threshold_ms(self, factor: float, *, min_count: int = 20,
                           floor_ms: float = 1.0,
                           now: float | None = None) -> float | None:
        """The router's hedging trigger (``serving/router.py``):
        ``factor`` x the windowed p99, or None while the window holds
        fewer than ``min_count`` samples (a threshold from a handful of
        samples would hedge on noise). ``floor_ms`` keeps a very fast
        window from hedging every request."""
        if factor <= 0.0:
            return None
        snap = self.snapshot(now)
        if snap["count"] < int(min_count):
            return None
        return max(float(floor_ms), float(factor) * float(snap["p99_ms"]))


class VersionStats:
    """One served version's window: latency, scores, pending labels."""

    __slots__ = ("version", "role", "latency", "requests", "hist",
                 "score_sum", "score_count", "pending", "pending_dropped")

    def __init__(self, version: int, role: str, window_s: float = 30.0):
        self.version = int(version)
        self.role = str(role)
        self.latency = LatencyWindow(window_s)
        self.requests = 0
        self.hist = np.zeros(SCORE_BUCKETS, dtype=np.int64)
        self.score_sum = 0.0
        self.score_count = 0
        self.pending: collections.deque = collections.deque()
        self.pending_dropped = 0

    def record(self, scores, lat_ms: float,
               now: float | None = None) -> None:
        s = np.asarray(scores, dtype=np.float64).reshape(-1)
        self.requests += int(s.size)
        self.latency.add(lat_ms, now)
        idx = np.clip((s * SCORE_BUCKETS).astype(np.int64), 0,
                      SCORE_BUCKETS - 1)
        np.add.at(self.hist, idx, 1)
        self.score_sum += float(s.sum())
        self.score_count += int(s.size)
        self.pending.append(s)
        while len(self.pending) > MAX_PENDING_BATCHES:
            self.pending.popleft()
            self.pending_dropped += 1

    def pop_pending(self, n: int):
        """The oldest pending score batch of length ``n``, or None."""
        for i, s in enumerate(self.pending):
            if s.size == n:
                del self.pending[i]
                return s
        return None

    def reset_window(self) -> None:
        self.requests = 0
        self.hist[:] = 0
        self.score_sum = 0.0
        self.score_count = 0


def score_kl(p_hist: np.ndarray, q_hist: np.ndarray) -> float:
    """KL(p || q) between two score histograms, epsilon-smoothed."""
    p = np.asarray(p_hist, dtype=np.float64) + _KL_EPS
    q = np.asarray(q_hist, dtype=np.float64) + _KL_EPS
    p /= p.sum()
    q /= q.sum()
    return float(np.sum(p * np.log(p / q)))


class ServingObs:
    """The server's per-window serving bookkeeping."""

    def __init__(self, window_s: float | None = None,
                 slo_ms: float | None = None):
        self.window_s = float(flags.serving_window_s
                              if window_s is None else window_s)
        self.slo_ms = float(flags.serving_slo_ms
                            if slo_ms is None else slo_ms)
        self.versions: dict[int, VersionStats] = {}
        # host-side AUC states: labels arrive as numpy arrays
        self.metrics = MetricRegistry()
        self.total = LatencyWindow(self.window_s or 30.0)
        self.served = 0
        self.window_start = time.time()
        self.windows_committed = 0

    def ensure_version(self, version: int, role: str) -> VersionStats:
        vs = self.versions.get(int(version))
        if vs is None:
            vs = VersionStats(version, role, self.window_s or 30.0)
            self.versions[int(version)] = vs
            self.metrics.init_metric(f"v{int(version)}", method="plain",
                                     phase=-1)
        vs.role = str(role)
        return vs

    def drop_version(self, version: int) -> None:
        self.versions.pop(int(version), None)

    def record(self, version: int, role: str, scores, lat_ms: float,
               served: bool, now: float | None = None) -> None:
        """One scored batch on ``version``; ``served`` marks the copy
        whose answer went back (a shadow score is not serving volume)."""
        self.ensure_version(version, role).record(scores, lat_ms, now)
        if served:
            self.total.add(lat_ms, now)
            self.served += int(np.asarray(scores).reshape(-1).size)

    def observe_labels(self, labels, version: int | None = None,
                       preds=None) -> dict:
        """Join delayed labels to pending scores and feed each version's
        AUC. With ``preds`` and ``version`` the join is the caller's;
        otherwise the oldest pending batch of the labels' length on every
        version that scored it is consumed. Returns {version: joined}."""
        lab = np.asarray(labels, dtype=np.float64).reshape(-1)
        joined: dict[int, int] = {}
        if preds is not None and version is not None:
            self.ensure_version(version, self.versions[int(version)].role
                                if int(version) in self.versions
                                else "stable")
            self.metrics.add_data(f"v{int(version)}", np.asarray(preds),
                                  lab)
            joined[int(version)] = int(lab.size)
            return joined
        for vid, vs in self.versions.items():
            s = vs.pop_pending(int(lab.size))
            if s is None:
                continue
            self.metrics.add_data(f"v{vid}", s, lab)
            joined[vid] = int(lab.size)
        return joined

    def due(self, now: float | None = None) -> bool:
        if self.window_s <= 0:
            return False
        now = time.time() if now is None else now
        return (now - self.window_start) >= self.window_s

    def version_fields(self) -> dict:
        """Per-version attribution: role, windowed latency, score mean,
        AUC once labels arrived, candidate-vs-stable score KL."""
        stable = next((v for v in self.versions.values()
                       if v.role == "stable"), None)
        out: dict[str, dict] = {}
        for vid, vs in self.versions.items():
            snap = vs.latency.snapshot()
            entry: dict = {"role": vs.role, "requests": int(vs.requests)}
            if snap["count"]:
                entry["p50_ms"] = snap["p50_ms"]
                entry["p99_ms"] = snap["p99_ms"]
            if vs.score_count:
                entry["score_mean"] = vs.score_sum / vs.score_count
            msg = self.metrics.get_metric_msg(f"v{vid}")
            if msg.get("size", 0) > 0 and msg.get("auc", -1) >= 0:
                entry["auc"] = float(msg["auc"])
            if (vs.role == "candidate" and stable is not None
                    and vs.score_count and stable.score_count):
                entry["score_kl"] = score_kl(vs.hist, stable.hist)
            if vs.pending_dropped:
                entry["pending_dropped"] = int(vs.pending_dropped)
            out[str(vid)] = entry
        return out

    def commit(self, now: float | None = None, **extra) -> dict:
        """Close the window: the serving record's fields (the caller
        merges its own counters through ``extra``), then reset the window
        accumulators. AUC states and pending labels survive commits."""
        now = time.time() if now is None else now
        snap = self.total.snapshot(now)
        fields = {
            "window_s": round(now - self.window_start, 3),
            "requests": int(self.served),
            "failures": 0,
            "swaps": 0,
            "version_lag": 0,
            "slo_ms": float(self.slo_ms),
            "p50_ms": float(snap.get("p50_ms", 0.0)),
            "p99_ms": float(snap.get("p99_ms", 0.0)),
            "versions": self.version_fields(),
        }
        for k, v in extra.items():
            if v is not None:
                fields[k] = v
        for vs in self.versions.values():
            vs.reset_window()
        self.served = 0
        self.window_start = now
        self.windows_committed += 1
        return fields
