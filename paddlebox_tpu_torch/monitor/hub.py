"""TelemetryHub — counters, gauges, timers, spans and pass flight records
behind one API with pluggable sinks; the port of
``paddlebox_tpu/monitor/hub.py``.

The reference ships the pieces separately: ``StatRegistry``/``STAT_ADD``
globals (platform/monitor.h:76,129), ``log_for_profile``'s per-card stage
lines (boxps_worker.cc:746-759) and chrome-trace timelines. The hub
unifies them, and every emission is tagged with the pass/step it belongs
to (``monitor.context``), including emissions from background threads
(the pack thread, the feed thread, the dump writer, checkpoint commits).

Cost model: the hub is DISABLED by default and the disabled path is one
attribute check — instrumentation stays in the code permanently, like
``STAT_ADD`` in the reference. Counters/gauges are always live (the
``STATS`` registry); the *event stream* is what enabling turns on.

Pass lifecycle: ``begin_pass`` snapshots the cumulative counters;
``end_pass`` commits a **flight record** — stage-time split, examples/s,
STATS deltas since the pass began, the metric-registry snapshot — to
every sink and keeps the last records in memory. ``BoxPS`` drives the
lifecycle; a bare ``Trainer.train_pass`` opens its own pass scope when
none is active (``open_pass_auto``), so standalone runs still produce
flight records.

The read side hooks in here (JAX ``hub.py:54-98, :221, :278, :359-405``):
inside a pass the world trace samples (``flags.trace``, ``monitor/
trace.py``) every span and event carries ``trace_id`` / ``span_id`` /
``parent_span_id``, the flight record is the pass-root span, and the
per-pass device capture (``flags.trace_device``) opens at ``begin_pass``
and closes at ``end_pass`` / ``abort_pass``; with ``flags.doctor_live``
``end_pass`` runs the doctor's rules over the committed records before
the scope closes (``doctor.finding`` events, ``last_doctor_findings``;
a broken rule set counts ``doctor.errors`` and never stops the pass).
With those flags off, which is their default, a record carries exactly
the fields it had before.
"""

from __future__ import annotations

import collections
import re
import sys
import threading
import time

from paddlebox_tpu_torch.monitor import context
from paddlebox_tpu_torch.monitor.registry import STATS
from paddlebox_tpu_torch.monitor.sinks import Sink  # noqa: F401  (re-export)

_prof = None
_trace = None


def _profiler():
    """Lazy handle on utils.profiler (it imports us; we must not import it
    at module level). First touched at runtime, never during import."""
    global _prof
    if _prof is None:
        from paddlebox_tpu_torch.utils import profiler as p
        _prof = p
    return _prof


def _tracer():
    """Lazy handle on monitor.trace (the world-trace layer): keeps the
    monitor package import-light and lets ``python -m
    paddlebox_tpu_torch.monitor.trace`` run as __main__ without a double
    import. Touched only on the hub's enabled paths."""
    global _trace
    if _trace is None:
        from paddlebox_tpu_torch.monitor import trace as t
        _trace = t
    return _trace


# the ranges a scope opens in a running torch.profiler session:
# ``pbt/<stage or span name>``
RANGE_PREFIX = "pbt/"


class _UntilTorchLoads:
    """Stands in for ``torch.autograd.profiler`` while torch is not
    loaded (no profiler can run then), so the monitor imports without
    torch; the first read after torch loads puts the module in its place,
    and from then on the gate is one attribute read of a module global
    that every thread sees."""

    def __getattr__(self, name):
        global _torch_profiler
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _torch_profiler = mod
        return getattr(mod, name)


_torch_profiler = _UntilTorchLoads()


def open_range(name: str):
    """Open the profiler range ``pbt/<name>`` (on the profiler's clock) and
    return it for the caller to close; called only while
    ``_torch_profiler._is_profiler_enabled``."""
    rf = _torch_profiler.record_function(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


class _Span:
    """Timed scope: chrome-trace span (when the profiler is on) + hub span
    event (when the hub is on) + the torch.profiler range ``pbt/<name>``
    (while a profiler session runs; ``range_name`` renames it). Disabled
    cost: three module-global checks (a fourth — ``trace._ACTIVE`` —
    only on the already-enabled path). Inside a traced pass the scope
    also pushes a span id onto the trace stack, so the committed record
    carries its own ``span_id`` and ``parent_span_id`` (the world trace's
    parent links)."""

    __slots__ = ("_hub", "_name", "_fields", "_t0", "_trace", "_range",
                 "_range_name")

    def __init__(self, hub, name, fields, range_name=None):
        self._hub = hub
        self._name = name
        self._fields = fields
        self._range_name = name if range_name is None else range_name

    def __enter__(self):
        self._range = (open_range(self._range_name)
                       if _torch_profiler._is_profiler_enabled else None)
        if self._hub._enabled or _profiler()._enabled:
            self._t0 = time.perf_counter()
            tr = _tracer()
            self._trace = (tr.push_span(self._name)
                           if tr._ACTIVE else None)
        else:
            self._t0 = None
            self._trace = None
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(None, None, None)
        t0 = self._t0
        if t0 is None:
            return False
        t1 = time.perf_counter()
        tr = self._trace
        ids = _tracer().pop_span(tr) if tr is not None else None
        prof = _profiler()
        if prof._enabled:
            prof.record_span(self._name, t0, t1)
        h = self._hub
        if h._enabled:
            rec = h._record("span", self._name, self._fields)
            rec["dur_s"] = t1 - t0
            if ids is not None:
                rec["span_id"], rec["parent_span_id"] = ids
            h._dispatch(rec)
        return False

    def __call__(self, fn):
        def wrapped(*a, **kw):
            with _Span(self._hub, self._name, self._fields,
                       self._range_name):
                return fn(*a, **kw)
        wrapped.__name__ = getattr(fn, "__name__", self._name)
        return wrapped


class _OpenPass:
    __slots__ = ("handle", "t0", "stats0", "owner", "stage_seconds",
                 "steps", "examples", "train_seconds", "extra",
                 "boundary_seconds", "boundary_split")

    def __init__(self, handle, stats0, owner):
        self.handle = handle
        self.t0 = time.perf_counter()
        self.stats0 = stats0
        self.owner = owner
        self.stage_seconds: dict[str, float] = {}
        self.steps = 0
        self.examples = 0
        self.train_seconds = 0.0
        self.extra: dict = {}
        # the pass-boundary account accumulates like stage_seconds:
        # phased programs run several train_passes per pass
        self.boundary_seconds = 0.0
        self.boundary_split: dict[str, float] | None = None


class TelemetryHub:
    """One per process (module singleton :func:`hub`); see module doc."""

    FLIGHT_KEEP = 64              # in-memory ring of flight records

    def __init__(self):
        self._lock = threading.Lock()
        self._sinks: tuple = ()
        self._enabled = False
        self._gauges: set[str] = set()
        self._pass: _OpenPass | None = None
        self._auto_pass_id = 0
        self._flight_records: collections.deque = collections.deque(
            maxlen=self.FLIGHT_KEEP)
        self.sink_errors = 0
        # findings of the last live-doctor evaluation (flags.doctor_live;
        # BoxPS.end_pass returns them too)
        self.last_doctor_findings: list | None = None
        # sinks detached by the 3-strike rule / closed by disable(), kept
        # for summary(): a silently-detached JSONL sink must be visible
        self._detached: collections.deque = collections.deque(maxlen=8)
        self._closed: collections.deque = collections.deque(maxlen=8)

    # ---- sinks / enablement ---------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, *sinks: Sink) -> None:
        """Attach sinks and turn the event stream on. Idempotent; extra
        calls add sinks. Turning on from disabled starts a fresh sink-
        health session (the previous session's detached/closed sinks
        drop out of summary())."""
        with self._lock:
            if not self._enabled:
                self._detached.clear()
                self._closed.clear()
            self._sinks = self._sinks + tuple(sinks)
            self._enabled = True

    def disable(self) -> None:
        """Turn the event stream off and close every sink (joins the JSONL
        writer thread). Counters/gauges stay live; the closed sinks'
        final health stays readable through :meth:`summary` until the
        next :meth:`enable`."""
        with self._lock:
            sinks, self._sinks = self._sinks, ()
            was_enabled, self._enabled = self._enabled, False
            if was_enabled:
                self._closed.clear()
        for s in sinks:
            try:
                s.flush()
                s.close()
            except Exception:
                self.sink_errors += 1
            self._closed.append(s)

    def sinks(self) -> tuple:
        return self._sinks

    # ---- counters / gauges (always live — the STATS registry) -----------

    def counter_add(self, name: str, value: float = 1.0) -> None:
        STATS.add(name, value)

    def gauge_set(self, name: str, value: float) -> None:
        STATS.set(name, value)
        self._gauges.add(name)

    # ---- events / spans --------------------------------------------------

    def _record(self, type_: str, name: str, fields: dict | None) -> dict:
        c = context.current()
        rec = {"ts": time.time(), "type": type_, "name": name,
               "pass_id": c.pass_id, "step": c.step, "phase": c.phase,
               "thread": threading.current_thread().name}
        if fields:
            rec["fields"] = fields
        tr = _tracer()
        if tr._ACTIVE:                # world trace: one check when off
            tid, enclosing = tr.current_ids()
            rec["trace_id"] = tid
            rec["parent_span_id"] = enclosing
        return rec

    def event(self, name: str, type: str = "event", **fields) -> None:
        """Emit one tagged event to the sinks. No-op when disabled."""
        if not self._enabled:
            return
        self._dispatch(self._record(type, name, fields))

    def span(self, name: str, **fields) -> _Span:
        """Timed scope (context manager or decorator); see :class:`_Span`."""
        return _Span(self, name, fields)

    def _dispatch(self, rec: dict) -> None:
        """Error-isolated fan-out: a sink that raises is counted and, after
        3 failures, detached — telemetry never takes down training."""
        for s in self._sinks:
            try:
                s.emit(rec)
            except Exception:
                self.sink_errors += 1
                STATS.add("monitor.sink_errors", 1)
                n = getattr(s, "_hub_errors", 0) + 1
                try:
                    s._hub_errors = n
                except AttributeError:
                    n = 3
                if n >= 3:
                    with self._lock:
                        self._sinks = tuple(x for x in self._sinks
                                            if x is not s)
                        self._detached.append(s)
                    STATS.add("monitor.sinks_detached", 1)

    # ---- pass lifecycle --------------------------------------------------

    def begin_pass(self, pass_id: int, phase: int | None = None,
                   owner: str = "box") -> None:
        """Open the pass scope: set the propagated context, snapshot the
        cumulative counters (per-pass deltas diff against this), mark the
        chrome trace. Cheap enough to run unconditionally."""
        if self._pass is not None:
            # a stale scope (crashed pass without abort) must not leak its
            # identity into the new pass
            self.abort_pass(reason="implicit: begin_pass over an open pass")
        handle = context.enter_pass(pass_id, phase)
        self._pass = _OpenPass(handle, STATS.snapshot(), owner)
        self._auto_pass_id = max(self._auto_pass_id, int(pass_id))
        # world trace: the sampling decision, the pass-root span and the
        # (optional) device-capture window — before the pass_begin event,
        # so it is the first stamped record of a traced pass
        _tracer().on_begin_pass(int(pass_id), self._enabled)
        if self._enabled:
            self.event("pass_begin", type="lifecycle", owner=owner)
        _profiler().record_instant("pass_begin", {"pass_id": int(pass_id)})

    def open_pass_auto(self) -> bool:
        """Trainer-owned scope when no BoxPS lifecycle is driving: opens a
        pass with an auto-incremented id and returns True iff this call
        opened it (the caller then owns the matching end/abort)."""
        if self._pass is not None:
            return False
        self._auto_pass_id += 1
        self.begin_pass(self._auto_pass_id, owner="trainer")
        return True

    def record_train(self, stage_seconds: dict | None = None,
                     steps: int = 0, examples: int = 0,
                     seconds: float = 0.0,
                     boundary_seconds: float = 0.0,
                     boundary_split: dict | None = None,
                     **extra) -> None:
        """Trainer contribution to the open pass's flight record (stage
        split, throughput inputs, boundary account, loss/auc extras).
        Accumulates — phased programs run several train_passes per pass;
        extras are last-write-wins."""
        p = self._pass
        if p is None:
            return
        for k, v in (stage_seconds or {}).items():
            p.stage_seconds[k] = p.stage_seconds.get(k, 0.0) + float(v)
        p.steps += int(steps)
        p.examples += int(examples)
        p.train_seconds += float(seconds)
        p.boundary_seconds += float(boundary_seconds or 0.0)
        if boundary_split is not None:
            split = p.boundary_split
            if split is None:
                split = p.boundary_split = {}
            for k, v in boundary_split.items():
                split[k] = split.get(k, 0.0) + float(v)
        p.extra.update({k: v for k, v in extra.items() if v is not None})

    def end_pass(self, metrics=None, **extra) -> dict | None:
        """Commit the pass flight record and close the scope. Returns the
        record (always built, also with no sink attached); emitted to
        sinks only when enabled."""
        p = self._pass
        if p is None:
            return None
        self._pass = None
        c = context.current()
        seconds = time.perf_counter() - p.t0
        snap = STATS.snapshot()
        delta = {k: round(v - p.stats0.get(k, 0.0), 6)
                 for k, v in snap.items()
                 if v != p.stats0.get(k, 0.0)}
        msnap: dict[str, dict] = {}
        if metrics is not None:
            for name in metrics.names():
                try:
                    msnap[name] = {k: float(v) for k, v in
                                   metrics.get_metric_msg(name).items()}
                except Exception:      # a broken metric must not block
                    msnap[name] = {"error": 1.0}
                    self.counter_add("monitor.metric_snapshot_errors")
        rec = self._record("flight_record", "pass", None)
        rec.update({
            "seconds": round(seconds, 6),
            "train_seconds": round(p.train_seconds, 6),
            "steps": p.steps,
            "examples": p.examples,
            "examples_per_sec": round(p.examples / seconds, 3)
            if seconds > 0 else 0.0,
            "stage_seconds": {k: round(v, 6)
                              for k, v in p.stage_seconds.items()},
            "stats_delta": delta,
            "metrics": msnap,
            "owner": p.owner,
        })
        merged = dict(p.extra)
        merged.update(extra)
        # the accumulated boundary account wins over anything a caller
        # put in extras under the same names
        if p.boundary_seconds or p.boundary_split is not None:
            merged["boundary_seconds"] = round(p.boundary_seconds, 6)
        if p.boundary_split is not None:
            merged["boundary_split"] = {k: round(v, 6) for k, v
                                        in p.boundary_split.items()}
        if merged:
            rec["extra"] = {k: v for k, v in merged.items()}
        if _tracer()._ACTIVE:
            # the flight record IS the pass-root span of the world trace
            # (the merger renders it as the per-rank pass slice)
            rec["span_id"] = _tracer().pass_root_id()
            rec["parent_span_id"] = None
        self._flight_records.append(rec)
        if self._enabled:
            self._dispatch(rec)
        _profiler().record_instant("pass_end", {"pass_id": c.pass_id})
        # the live doctor (flags.doctor_live): the rules run over the
        # committed records before the pass scope closes, so the
        # doctor.finding events carry this pass's tag. Lazy imports: the
        # doctor imports this module, and the analysis layer must never
        # take down the training it observes
        self.last_doctor_findings = None
        try:
            from paddlebox_tpu_torch.config import flags as _flags
            if _flags.doctor_live:
                from paddlebox_tpu_torch.monitor import doctor as _doctor
                self.last_doctor_findings = _doctor.run_live(self)
        except Exception:
            STATS.add("doctor.errors", 1)
        _tracer().on_end_pass()       # close the trace window + device
        context.exit_pass(p.handle)   # capture (no-op when untraced)
        return rec

    def abort_pass(self, reason: str = "") -> None:
        """Close the scope without a flight record (the pass raised)."""
        p = self._pass
        if p is None:
            return
        self._pass = None
        if self._enabled:
            self.event("pass_aborted", type="lifecycle",
                       reason=str(reason)[:200])
        _tracer().on_end_pass()
        context.exit_pass(p.handle)

    def flight_records(self) -> list[dict]:
        return list(self._flight_records)

    # ---- exposition / embed ----------------------------------------------

    # Alert series the JAX package's run doctor keys off — always
    # exported, zero-filled when untouched, so a scrape target never
    # gains or loses series depending on which subsystem has fired yet.
    # Kept identical to the reference so one alert reads both packages.
    ALERT_COUNTERS = ("exchange.overflow_retries",
                      "exchange.overflow_dropped",
                      "tiering.admitted", "tiering.evicted",
                      "spill.cache_hits", "spill.cache_misses",
                      "trainer.nan_trips", "doctor.findings",
                      "resilience.peer_lost", "resilience.peer_stalled",
                      "serving.publish_failures")
    ALERT_GAUGES = ("tiering.hot_rows",)

    # sink-health exposition: a wedged/detached JsonlSink reads as
    # exactly that instead of as a mysteriously short event stream
    SINK_GAUGES = ("monitor.sinks_attached", "monitor.sinks_unhealthy",
                   "monitor.sinks_detached_now", "monitor.sinks_closed",
                   "monitor.sink_dropped_events",
                   "monitor.sink_latched_errors")

    def _sink_gauges(self) -> dict:
        health = self.sink_health()
        by_state: dict[str, int] = {"attached": 0, "detached": 0,
                                    "closed": 0}
        for s in health:
            by_state[s["state"]] = by_state.get(s["state"], 0) + 1
        return {
            "monitor.sinks_attached": by_state["attached"],
            "monitor.sinks_unhealthy": sum(
                1 for s in health
                if s.get("dropped") or s.get("error")
                or s["state"] == "detached"),
            "monitor.sinks_detached_now": by_state["detached"],
            "monitor.sinks_closed": by_state["closed"],
            "monitor.sink_dropped_events": sum(
                s.get("dropped", 0) for s in health),
            "monitor.sink_latched_errors": sum(
                1 for s in health if s.get("error")),
        }

    def prometheus_text(self, prefix: str = "pbtpu") -> str:
        """Prometheus text exposition of the counter/gauge registry (names
        sanitized to the metric charset; gauges are the names set through
        :meth:`gauge_set`, everything else a counter). The alert series
        are always present, the derived ``tiering.hot_hit_rate`` gauge —
        RAM-tier hits over total reads — is computed here, and the sink
        health exports as the ``monitor.sinks_*`` gauges."""
        snap = STATS.snapshot()
        gauges = set(self._gauges) | set(self.ALERT_GAUGES)
        for k in self.ALERT_COUNTERS + self.ALERT_GAUGES:
            snap.setdefault(k, 0.0)
        seen = snap.get("spill.cache_hits", 0.0) \
            + snap.get("spill.cache_misses", 0.0)
        snap["tiering.hot_hit_rate"] = (
            snap.get("spill.cache_hits", 0.0) / seen if seen else 0.0)
        gauges.add("tiering.hot_hit_rate")
        for k, v in self._sink_gauges().items():
            snap[k] = float(v)
            gauges.add(k)
        out: list[str] = []
        for k in sorted(snap):
            n = prefix + "_" + re.sub(r"[^a-zA-Z0-9_:]", "_", k)
            kind = "gauge" if k in gauges else "counter"
            out.append(f"# TYPE {n} {kind}")
            out.append(f"{n} {snap[k]:g}")
        return "\n".join(out) + "\n"

    @staticmethod
    def _sink_info(s, state: str) -> dict:
        info = {"type": type(s).__name__, "state": state,
                "strikes": int(getattr(s, "_hub_errors", 0) or 0),
                "dropped": int(getattr(s, "dropped", 0) or 0)}
        for k in ("written", "rotations"):
            v = getattr(s, k, None)
            if v is not None:
                info[k] = int(v)
        err = getattr(s, "error", None)
        if err is not None:
            info["error"] = repr(err)[:200]
        path = getattr(s, "path", None)
        if path:
            info["path"] = path
            info["segments"] = len(getattr(s, "segments", None) or ())
        return info

    def sink_health(self) -> list[dict]:
        """Per-sink health for this telemetry session: live sinks, sinks
        the 3-strike rule detached, and sinks disable() closed — with
        queue-drop counts, latched write errors and rotation state."""
        return ([self._sink_info(s, "attached") for s in self._sinks]
                + [self._sink_info(s, "detached") for s in self._detached]
                + [self._sink_info(s, "closed") for s in self._closed])

    def summary(self) -> dict:
        """Compact snapshot for artifact embeds."""
        sinks = self.sink_health()
        dropped = sum(i["dropped"] for i in sinks)
        return {"enabled": self._enabled,
                "counters": STATS.snapshot(),
                "gauges": sorted(self._gauges),
                "sink_errors": self.sink_errors,
                "events_dropped": dropped,
                "sinks": sinks,
                "flight_records": list(self._flight_records)[-8:]}


_HUB = TelemetryHub()


def hub() -> TelemetryHub:
    return _HUB


def start_metrics_endpoint(port: int = 0, host: str = "127.0.0.1"):
    """Training-side ``/metrics``: a stdlib HTTP endpoint serving the
    hub's Prometheus exposition — the twin of ServingServer's
    ``/metrics``. port=0 binds an ephemeral port; read it off the
    returned server's ``server_address[1]``; call ``.shutdown()`` to
    stop."""
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path.startswith("/metrics"):
                body = _HUB.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
            else:
                body = b"not found\n"
                self.send_response(404)
                self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # quiet: telemetry is the log
            pass

    srv = http.server.ThreadingHTTPServer((host, int(port)), _Handler)
    t = context.spawn(srv.serve_forever, name="pbt-metrics-http")
    t.start()
    srv._pbtpu_thread = t        # joinable after shutdown()
    return srv


# module-level conveniences (the instrumented call-site surface)

def counter_add(name: str, value: float = 1.0) -> None:
    STATS.add(name, value)


def gauge_set(name: str, value: float) -> None:
    _HUB.gauge_set(name, value)


def event(name: str, type: str = "event", **fields) -> None:
    if _HUB._enabled:                 # inline the fast path
        _HUB._dispatch(_HUB._record(type, name, fields))


def span(name: str, **fields) -> _Span:
    return _Span(_HUB, name, fields)
