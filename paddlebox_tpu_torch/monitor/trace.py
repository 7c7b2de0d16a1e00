"""World trace — cross-rank distributed tracing over the telemetry hub;
the port of ``paddlebox_tpu/monitor/trace.py``. Records, flow points and
the merged Chrome trace are the reference's formats, so either package's
merger reads the other's streams.

The reference instruments every per-card stage (``log_for_profile``,
boxps_worker.cc:746-759) but only *per process*: an operator chasing a
slow pass across a fleet reads N disjoint logs and correlates them by
wall clock and eyesight. This module makes one pass ONE causal timeline:

- **Trace context** — inside a sampled pass (``flags.trace`` +
  ``flags.trace_sample_passes``) every hub record carries
  ``trace_id`` / ``span_id`` / ``parent_span_id``. The trace_id is
  deterministic (``<run>:<pass>``) so every rank of a run stamps the
  SAME id with zero coordination; span ids are process-unique. The
  span stack is a contextvar (threads spawned through
  ``monitor.context.spawn`` inherit it) with a pass-root fallback for
  plain threads — the same two-tier design as ``monitor.context``.
- **Flow points** — ``flow(kind, key, role)`` emits a ``trace.flow``
  event; points sharing ``(kind, key)`` across rank streams become
  Chrome flow arrows in the merged trace. The exchange stamps one per
  routed batch (key ``p<pass>.s<step>`` — deterministic, so no bytes
  cross the wire for tracing), and the publisher/serving pair stamps
  ``publish``/``v<version>`` so a serving swap links back to the
  ``end_pass`` that produced it (the trace ids also ride the donefile
  entry itself — the cross-process propagation).
- **Clock correction** — hosts disagree on wall time. The heartbeat
  plane (distributed/resilience.py) already round-trips through the
  rendezvous store; its payloads now carry publish wall-clock + an echo
  of each observed peer, which yields an NTP-style offset estimate per
  (observer, peer) pair, emitted as ``trace.clock_probe`` events.
  :func:`estimate_clock_offsets` reduces the probes to one offset per
  rank (relative to the lowest-named rank) and the merger shifts every
  rank's timestamps by it — skewed hosts land aligned.
- **Merged timeline** — :func:`merge_roots` turns N per-rank telemetry
  roots (local dirs or remote roots, rotated segments — the same
  inputs as ``monitor/aggregate.py``) into ONE Chrome-trace-event JSON:
  rank → process, thread → thread, flight records as per-pass slices,
  spans as slices, flow arrows for the exchange and publish→swap edges.
  Open it in Perfetto (ui.perfetto.dev) or chrome://tracing.
- **Device capture** — ``flags.trace_device`` starts a ``torch.profiler``
  trace with CUDA activity (``utils.profiler.start_device_trace``) at
  every sampled ``begin_pass`` and stops it at ``end_pass``, writing
  ``trace_device_dir/pass-NNNNN/trace.json`` (Chrome trace: the card's
  kernels beside the host ops), linked to the host spans by the pass
  markers both carry. A no-op only when the trainer's device is the CPU
  (:func:`note_device`); a capture failure is counted
  (``trace.device_capture_errors``), never raised.

Cost discipline: tracing disabled costs ONE module-flag check per scope
(``_ACTIVE``) — the same contract as the hub's disabled event path,
asserted by a micro-test. An unsampled pass pays one sampling decision
at ``begin_pass`` and nothing per step.

CLI::

    python -m paddlebox_tpu_torch.monitor.trace RANK_DIR... \
        [-o world_trace.json] [--rank-names 4,5,7] [--json]
"""

from __future__ import annotations

import contextvars
import json
import os
import sys
import uuid
import zlib

from paddlebox_tpu_torch.config import flags as config_flags
from paddlebox_tpu_torch.monitor import aggregate as agg_lib
from paddlebox_tpu_torch.monitor.registry import STATS

# ---------------------------------------------------------------------------
# trace context (the write side)
# ---------------------------------------------------------------------------

# THE one-check gate: every per-record/per-scope helper returns
# immediately when this is False (the hub checks it inline too)
_ACTIVE = False

_TRACE_ID: str | None = None
_PASS_ROOT: str | None = None          # pass-root span id (plain-thread
                                       # fallback parent, like context._global)
_SID_PREFIX = f"{os.getpid() & 0xFFFFFF:06x}{uuid.uuid4().hex[:4]}"
_sid_counter = 0

# per-thread span stack (immutable tuple — pushes are context-local, so
# concurrent spans on the pack/feed/dump threads never interleave)
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "pbtpu_trace_spans", default=())

# device-capture state (one window per sampled pass), and the device the
# newest Trainer runs on (note_device): the capture follows the trainer
_device_dir: str | None = None
_capture_device: str | None = None
# the newest capture's Chrome trace file (read it after end_pass)
last_device_trace: str | None = None

# has this process EVER opened a pass scope? A training process owns
# the trace window via begin/end_pass sampling; a co-located serving
# poll must then never re-activate tracing between or inside passes
# (ensure_service is for pass-less standalone servers only)
_SAW_PASS = False


def _new_span_id() -> str:
    global _sid_counter
    _sid_counter += 1                 # GIL-atomic enough for an id
    return f"{_SID_PREFIX}-{_sid_counter}"


def active() -> bool:
    return _ACTIVE


def trace_id() -> str | None:
    return _TRACE_ID


def _run_id() -> str:
    return config_flags.trace_run_id or "run"


def on_begin_pass(pass_id: int, hub_enabled: bool) -> bool:
    """Hub hook at ``begin_pass``: decide sampling, open the pass-root
    span, and (``flags.trace_device``) start the device-capture window.
    Returns whether this pass is traced."""
    global _ACTIVE, _TRACE_ID, _PASS_ROOT, _SAW_PASS
    _SAW_PASS = True
    if not (config_flags.trace and hub_enabled):
        _ACTIVE = False
        return False
    n = max(1, int(config_flags.trace_sample_passes))
    if int(pass_id) % n != 0 and n > 1:
        _ACTIVE = False
        return False
    _TRACE_ID = f"{_run_id()}:{int(pass_id)}"
    _PASS_ROOT = _new_span_id()
    _ACTIVE = True
    _maybe_start_device_capture(int(pass_id))
    return True


def on_end_pass() -> None:
    """Hub hook at ``end_pass``/``abort_pass``: close the window."""
    global _ACTIVE, _TRACE_ID, _PASS_ROOT
    _stop_device_capture()
    _ACTIVE = False
    _TRACE_ID = None
    _PASS_ROOT = None


def ensure_service(name: str) -> bool:
    """Pass-less processes (the serving server) have no ``begin_pass``
    to sample at; with ``flags.trace`` on, activate a standing trace
    scope named after the service so swap-side records/flow points are
    stamped and mergeable. Returns whether tracing is active.

    In a process that ALSO trains (co-located publisher+server), the
    pass lifecycle owns the window — this is a no-op there, so a poll
    thread can never re-activate tracing inside an unsampled pass or
    stamp between-pass records into a bogus service trace (swap records
    of a co-located server are stamped by the enclosing traced pass
    instead)."""
    global _ACTIVE, _TRACE_ID, _PASS_ROOT
    if not config_flags.trace or _SAW_PASS:
        return _ACTIVE
    if not _ACTIVE:
        _TRACE_ID = f"{_run_id()}:{name}"
        _PASS_ROOT = _new_span_id()
        _ACTIVE = True
    return True


def push_span(name: str) -> tuple:
    """Open a span scope on this thread's stack; returns the token for
    :func:`pop_span`. (The hub's ``_Span`` drives this — instrumented
    code never calls it directly.)"""
    sid = _new_span_id()
    stack = _stack.get()
    token = _stack.set(stack + (sid,))
    return (sid, token)


def pop_span(handle: tuple) -> tuple:
    """Close the span scope; returns ``(span_id, parent_span_id)`` for
    the record stamp."""
    sid, token = handle
    stack = _stack.get()
    parent = stack[-2] if len(stack) >= 2 else _PASS_ROOT
    try:
        _stack.reset(token)
    except ValueError:         # popped from a different Context: best
        _stack.set(stack[:-1])  # effort — the stamp below is still right
    return sid, parent


def current_ids() -> tuple:
    """(trace_id, enclosing_span_id) at this point — the stamp for
    EVENT records (a point belongs to the span it fired inside; the
    pass root when no span is open on this thread)."""
    stack = _stack.get()
    return _TRACE_ID, (stack[-1] if stack else _PASS_ROOT)


def pass_root_id() -> str | None:
    return _PASS_ROOT


def flow(kind: str, key: str, role: str = "point", **fields) -> None:
    """Emit one flow point: records sharing ``(kind, key)`` across rank
    streams become ONE flow arrow in the merged trace (role ``src``
    anchors the arrow tail when present; otherwise the earliest
    corrected point does). No-op unless the pass is traced — one check."""
    if not _ACTIVE:
        return
    from paddlebox_tpu_torch.monitor.hub import event as hub_event
    hub_event("trace.flow", type="flow", kind=str(kind), key=str(key),
              role=str(role), **fields)


def flow_propagated(kind: str, key: str, role: str,
                    parent: "dict | None", **fields) -> None:
    """Flow point activated by a PROPAGATED trace context (a donefile
    entry's ``{"trace_id", "span_id"}``) instead of the local window:
    the producing run traced this artifact, so the consumer-side point
    must emit even in a process with no trace scope of its own (a
    serving host with default flags, a co-located tailer polling
    between passes). The parent ids ride the fields — the merger pairs
    the edge under the PRODUCER's run and draws the parent link. No-op
    when there is neither a propagated parent nor a local window."""
    if not parent and not _ACTIVE:
        return
    parent = parent or {}
    from paddlebox_tpu_torch.monitor.hub import event as hub_event
    hub_event("trace.flow", type="flow", kind=str(kind), key=str(key),
              role=str(role),
              parent_trace_id=parent.get("trace_id"),
              parent_span_id=parent.get("span_id"), **fields)


# ---------------------------------------------------------------------------
# device capture (flags.trace_device — per-pass torch.profiler window)
# ---------------------------------------------------------------------------

def note_device(device) -> None:
    """Record the device the training runs on (``Trainer`` calls this
    when it is built): the per-pass capture follows it, and is a no-op
    on the CPU."""
    global _capture_device
    _capture_device = str(getattr(device, "type", device))


def _capture_on_card() -> bool:
    if _capture_device is not None:
        return _capture_device == "cuda"
    import torch
    return torch.cuda.is_available()


def _maybe_start_device_capture(pass_id: int) -> None:
    global _device_dir
    if not config_flags.trace_device or _device_dir is not None:
        return
    try:
        if not _capture_on_card():
            return                      # a CPU trainer: nothing to capture
        import tempfile

        from paddlebox_tpu_torch.utils import profiler
        root = config_flags.trace_device_dir or os.path.join(
            tempfile.gettempdir(), "pbtpu_device_trace")
        logdir = os.path.join(root, f"pass-{pass_id:05d}")
        profiler.start_device_trace(logdir, device="cuda")
        _device_dir = logdir
        from paddlebox_tpu_torch.monitor.hub import event as hub_event
        hub_event("trace.device_capture", type="flow", logdir=logdir,
                  state="started")
    except Exception:
        # tracing must never take down the training it observes
        STATS.add("trace.device_capture_errors", 1)
        _device_dir = None


def _stop_device_capture() -> None:
    global _device_dir, last_device_trace
    if _device_dir is None:
        return
    logdir, _device_dir = _device_dir, None
    try:
        import torch

        from paddlebox_tpu_torch.utils import profiler
        # the pass's kernels finish inside the window they were captured in
        torch.cuda.synchronize()
        last_device_trace = profiler.stop_device_trace()
        from paddlebox_tpu_torch.monitor.hub import event as hub_event
        hub_event("trace.device_capture", type="flow", logdir=logdir,
                  state="stopped")
    except Exception:
        STATS.add("trace.device_capture_errors", 1)


# ---------------------------------------------------------------------------
# clock-offset estimation (the read side of the heartbeat probes)
# ---------------------------------------------------------------------------

def ntp_offset(t0: float, t1: float, t2: float, t3: float
               ) -> tuple[float, float]:
    """The symmetric estimate from one heartbeat round trip (the
    heartbeat, ``distributed.resilience.HeartbeatMonitor``, emits each
    as a ``trace.clock_probe`` event): the observer publishes at ``t0``
    (its clock), the peer reads that at ``t1`` and publishes its echo at
    ``t2`` (peer clock), the observer reads the echo at ``t3``. Returns
    ``(offset, rtt)`` with ``offset ~= peer_clock - observer_clock``
    (delay asymmetry is the error term, bounded by rtt/2)."""
    offset = ((t1 - t0) + (t2 - t3)) / 2.0
    rtt = (t3 - t0) - (t2 - t1)
    return offset, rtt


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0


def estimate_clock_offsets(probes: "list[dict]",
                           ranks: "list[int]") -> dict:
    """Per-rank clock offset (seconds, relative to the anchor = lowest
    rank) from ``trace.clock_probe`` samples.

    Each probe is ``{observer, peer, offset_s}`` with ``offset_s ~=
    clock(peer) - clock(observer)``. Pairwise medians (robust to the
    odd slow store round-trip) feed a BFS from the anchor, so
    multi-host chains resolve transitively; a rank no probe reaches
    keeps offset 0 (uncorrected — reported as such)."""
    pair: dict[tuple[int, int], list[float]] = {}
    for p in probes:
        try:
            obs, peer = int(p["observer"]), int(p["peer"])
            off = float(p["offset_s"])
        except (KeyError, TypeError, ValueError):
            continue
        pair.setdefault((obs, peer), []).append(off)
        pair.setdefault((peer, obs), []).append(-off)
    est = {k: _median(v) for k, v in pair.items()}
    offsets = {r: 0.0 for r in ranks}
    corrected = set()
    if not ranks:
        return {"offsets_s": offsets, "corrected": []}
    anchor = min(ranks)
    corrected.add(anchor)
    frontier = [anchor]
    while frontier:
        a = frontier.pop()
        for (obs, peer), off in est.items():
            if obs == a and peer in offsets and peer not in corrected:
                # clock(peer) = clock(obs) + off
                offsets[peer] = offsets[a] + off
                corrected.add(peer)
                frontier.append(peer)
    return {"offsets_s": {r: round(v, 6) for r, v in offsets.items()},
            "corrected": sorted(corrected)}


# ---------------------------------------------------------------------------
# stream reading + world merge (the read side)
# ---------------------------------------------------------------------------

# record kinds the merger keeps; everything else is counted only (a
# day-scale stream must merge in bounded memory)
KEEP_TYPES = ("span", "flight_record", "lifecycle", "flow")
MAX_RECORDS_PER_RANK = 200_000


def read_trace_records(root: str) -> dict:
    """One rank's trace-relevant records, in stream order (all rotated
    segments — the aggregate module's discovery/ordering rules)."""
    files = agg_lib.discover_stream_files(root)
    kept: list[dict] = []
    probes: list[dict] = []
    dropped = 0
    n = 0
    for path in files:
        for line in agg_lib._iter_lines(root, path):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue                 # schema errors are aggregate's job
            n += 1
            name = rec.get("name")
            if name == "trace.clock_probe":
                probes.append(rec.get("fields") or {})
                continue
            if rec.get("type") in KEEP_TYPES:
                if len(kept) >= MAX_RECORDS_PER_RANK:
                    dropped += 1
                    continue
                kept.append(rec)
    return {"root": root, "events": n, "records": kept,
            "clock_probes": probes, "dropped": dropped}


def _tid_for(thread_name: str, tids: dict) -> int:
    if thread_name not in tids:
        tids[thread_name] = len(tids) + 1   # 0 = the pass track
    return tids[thread_name]


def _flow_id(kind: str, key: str, n: int) -> int:
    return zlib.crc32(f"{kind}:{key}:{n}".encode()) & 0x7FFFFFFF


def merge_streams(streams: "list[dict]", labels: "list[int]") -> dict:
    """Merge per-rank record streams (:func:`read_trace_records` shapes)
    into one Chrome-trace-event JSON. Returns the trace dict with the
    machine summary under ``["pbtpu"]`` (Perfetto ignores foreign top-
    level keys): clock offsets applied, flow edges with corrected
    latencies, and per-rank record counts."""
    clock = estimate_clock_offsets(
        [p for st in streams for p in st["clock_probes"]], list(labels))
    offsets = clock["offsets_s"]

    events: list[dict] = []
    flow_points: dict[tuple, list] = {}
    spans = 0
    span_records = 0          # type=="span" only — "is there a trace
    t_min = None              # plane here at all" (flights always exist)
    # cross-process parent links: a serving request span
    # carries the producing run's ids in its FIELDS (propagated through
    # the donefile entry) — pair them with the parent span's merged
    # location to draw publish -> request arrows across process
    # boundaries
    span_locs: dict[str, dict] = {}
    linked: list[dict] = []

    def corrected(rank: int, ts: float) -> float:
        return float(ts) - offsets.get(rank, 0.0)

    # first sweep: find the global origin so Perfetto ts stay small
    for label, st in zip(labels, streams):
        for rec in st["records"]:
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            start = corrected(label, ts) - float(rec.get("dur_s") or
                                                 rec.get("seconds") or 0.0)
            t_min = start if t_min is None else min(t_min, start)
    t0 = t_min or 0.0

    def us(rank: int, ts: float, back_s: float = 0.0) -> float:
        return round((corrected(rank, ts) - back_s - t0) * 1e6, 3)

    for label, st in zip(labels, streams):
        tids: dict[str, int] = {}
        events.append({"name": "process_name", "ph": "M", "pid": label,
                       "args": {"name": f"rank {label}"}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": label, "args": {"sort_index": label}})
        events.append({"name": "thread_name", "ph": "M", "pid": label,
                       "tid": 0, "args": {"name": "pass"}})
        for rec in st["records"]:
            ts = rec.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            typ = rec.get("type")
            name = rec.get("name")
            args = {k: rec.get(k) for k in
                    ("pass_id", "step", "trace_id", "span_id",
                     "parent_span_id") if rec.get(k) is not None}
            if rec.get("fields"):
                args.update(rec["fields"])
            if typ == "flight_record":
                dur = float(rec.get("seconds") or 0.0)
                events.append({
                    "name": f"pass {rec.get('pass_id')}", "ph": "X",
                    "pid": label, "tid": 0,
                    "ts": us(label, ts, dur), "dur": round(dur * 1e6, 3),
                    "args": args})
                spans += 1
            elif typ == "span":
                dur = float(rec.get("dur_s") or 0.0)
                tid = _tid_for(rec.get("thread") or "main", tids)
                start_us = us(label, ts, dur)
                events.append({
                    "name": name, "ph": "X", "pid": label, "tid": tid,
                    "ts": start_us, "dur": round(dur * 1e6, 3),
                    "args": args})
                spans += 1
                span_records += 1
                sid = rec.get("span_id")
                if isinstance(sid, str):
                    span_locs.setdefault(sid, {"rank": label, "tid": tid,
                                               "ts_us": start_us})
                f = rec.get("fields") or {}
                if isinstance(f.get("parent_span_id"), str):
                    linked.append({"name": name, "rank": label,
                                   "tid": tid, "ts_us": start_us,
                                   "parent_span_id": f["parent_span_id"],
                                   "parent_trace_id":
                                       f.get("parent_trace_id")})
            elif typ == "flow" and name == "trace.flow":
                f = rec.get("fields") or {}
                pt = {"rank": label,
                      "tid": _tid_for(rec.get("thread") or "main", tids),
                      "ts_us": us(label, ts),
                      "corrected_s": corrected(label, ts),
                      "role": f.get("role", "point"),
                      "fields": f, "args": args}
                # group key includes the RUN prefix of the trace_id
                # (trace_run_id) — two runs sharing a telemetry root
                # must never pair their flow points into phantom edges.
                # A propagated parent_trace_id wins: a consumer-side
                # point (the serving swap) pairs under the PRODUCER's
                # run, whatever the consumer's local flags say
                run = str(f.get("parent_trace_id")
                          or rec.get("trace_id") or "").split(":", 1)[0]
                flow_points.setdefault(
                    (str(f.get("kind")), str(f.get("key")), run),
                    []).append(pt)
            else:                        # lifecycle -> instant marker
                tid = _tid_for(rec.get("thread") or "main", tids)
                events.append({"name": name, "ph": "i", "s": "t",
                               "pid": label, "tid": tid,
                               "ts": us(label, ts), "args": args})
        for tname, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": label,
                           "tid": tid, "args": {"name": tname}})

    # flow arrows: per (kind, key) group, the src-role (else earliest)
    # point anchors; every other point is an arrow head. One id per
    # edge — chrome's s/f pairing is strictly 1:1.
    edges: list[dict] = []
    for (kind, key, run), pts in sorted(flow_points.items()):
        pts.sort(key=lambda p: p["ts_us"])
        srcs = [p for p in pts if p["role"] == "src"]
        src = srcs[0] if srcs else pts[0]
        n = 0
        for p in pts:
            if p is src:
                continue
            n += 1
            fid = _flow_id(kind, f"{run}/{key}", n)
            cat = f"flow.{kind}"
            events.append({"name": f"{kind}:{key}", "ph": "s", "id": fid,
                           "cat": cat, "pid": src["rank"],
                           "tid": src["tid"], "ts": src["ts_us"]})
            events.append({"name": f"{kind}:{key}", "ph": "f", "bp": "e",
                           "id": fid, "cat": cat, "pid": p["rank"],
                           "tid": p["tid"], "ts": p["ts_us"]})
            edges.append({
                "kind": kind, "key": key,
                "src_rank": src["rank"], "dst_rank": p["rank"],
                "latency_s": round(p["corrected_s"]
                                   - src["corrected_s"], 6),
                "fields": {k: v for k, v in p["fields"].items()
                           if k not in ("kind", "key", "role")}})
    # parent-link arrows: one s/f pair from the parent span
    # (the producing pass's publish) to each propagated-linked child
    # span (a serving request) — NOT a flow edge (the cross-rank-flow
    # doctor rule keys off flow() points only), so it gets its own
    # counter. Parents outside the merged roots still count as linked:
    # the ids are stamped either way.
    linked_edges = 0
    for n, lk in enumerate(sorted(linked, key=lambda p: p["ts_us"]), 1):
        src = span_locs.get(lk["parent_span_id"])
        if src is None:
            continue
        linked_edges += 1
        fid = _flow_id("parent", lk["parent_span_id"], n)
        events.append({"name": f"parent:{lk['name']}", "ph": "s",
                       "id": fid, "cat": "flow.parent",
                       "pid": src["rank"], "tid": src["tid"],
                       "ts": src["ts_us"]})
        events.append({"name": f"parent:{lk['name']}", "ph": "f",
                       "bp": "e", "id": fid, "cat": "flow.parent",
                       "pid": lk["rank"], "tid": lk["tid"],
                       "ts": lk["ts_us"]})
    events.sort(key=lambda e: (e.get("ts", -1), e.get("pid", 0)))
    summary = {
        "ranks": list(labels),
        "events": len(events),
        "spans": spans,
        "span_records": span_records,
        "linked_spans": len(linked),
        "linked_edges": linked_edges,
        "flow_points": sum(len(v) for v in flow_points.values()),
        "flow_edges": edges,
        "clock_offsets_s": {str(r): v
                            for r, v in offsets.items()},
        "clock_corrected_ranks": clock["corrected"],
        "records_dropped": sum(st["dropped"] for st in streams),
    }
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "pbtpu": summary}


def merge_roots(roots: "list[str]",
                rank_names: "list[int] | None" = None) -> dict:
    """N per-rank telemetry roots (local dirs / .jsonl files / remote
    roots) -> one merged Chrome trace. Rank naming follows the
    aggregate/Heartbeat convention (``aggregate.rank_label``)."""
    streams = [read_trace_records(r) for r in roots]
    labels = [agg_lib.rank_label(r, i, rank_names)
              for i, r in enumerate(roots)]
    return merge_streams(streams, labels)


def write_trace(trace: dict, path: str) -> str:
    """Atomic write (tmp -> fsync -> replace): a monitoring cron must
    never ship a torn half-trace under the final name."""
    from paddlebox_tpu_torch.utils.checkpoint import atomic_file
    with atomic_file(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(trace, f)
    return path


def summarize(trace: dict) -> dict:
    """The embeddable machine summary of a merged trace (the doctor's
    cross-rank-flow rule reads it)."""
    return dict(trace.get("pbtpu") or {})


# ---------------------------------------------------------------------------
# in-memory capture (one process, no files)
# ---------------------------------------------------------------------------

def records_to_stream(records: "list[dict]") -> dict:
    """A :func:`read_trace_records`-shaped stream from in-memory hub
    records (a MemorySink ring)."""
    kept = [r for r in records if r.get("type") in KEEP_TYPES]
    probes = [r.get("fields") or {} for r in records
              if r.get("name") == "trace.clock_probe"]
    return {"root": "<memory>", "events": len(records), "records": kept,
            "clock_probes": probes, "dropped": 0}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def render_text(summary: dict, out_path: str | None) -> str:
    lines = [f"world trace: {summary['spans']} span(s), "
             f"{summary['flow_points']} flow point(s), "
             f"{len(summary['flow_edges'])} flow edge(s) across "
             f"ranks {summary['ranks']}"]
    offs = summary.get("clock_offsets_s") or {}
    if any(v for v in offs.values()):
        lines.append("clock offsets (s, vs anchor): "
                     + " ".join(f"rank{r}={v:+.6f}"
                                for r, v in sorted(offs.items())))
    for e in summary["flow_edges"][:16]:
        lines.append(f"  {e['kind']}:{e['key']} rank{e['src_rank']} -> "
                     f"rank{e['dst_rank']} ({e['latency_s'] * 1e3:.3f}ms)")
    if out_path:
        lines.append(f"wrote {out_path} — open it at ui.perfetto.dev "
                     "(or chrome://tracing)")
    return "\n".join(lines)


def main(argv: "list[str] | None" = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    out_path = None
    for opt in ("-o", "--out"):
        if opt in argv:
            i = argv.index(opt)
            try:
                out_path = argv[i + 1]
            except IndexError:
                print(f"{opt} wants a path", file=sys.stderr)
                return 2
            del argv[i:i + 2]
    rank_names = None
    if "--rank-names" in argv:
        i = argv.index("--rank-names")
        try:
            rank_names = [int(x) for x in argv[i + 1].split(",") if x]
        except (IndexError, ValueError):
            print("--rank-names wants a comma-separated int list",
                  file=sys.stderr)
            return 2
        del argv[i:i + 2]
    roots = [a for a in argv if not a.startswith("-")]
    if not roots:
        print("usage: python -m paddlebox_tpu_torch.monitor.trace "
              "<telemetry_dir>... [-o world_trace.json] "
              "[--rank-names 4,5,7] [--json]", file=sys.stderr)
        return 2
    try:
        trace = merge_roots(roots, rank_names=rank_names)
    except (OSError, ValueError) as e:
        print(f"trace: cannot read telemetry roots: {e}", file=sys.stderr)
        return 2
    summary = summarize(trace)
    if summary["spans"] == 0 and not summary["flow_edges"]:
        print(f"trace: no trace records found under {roots} "
              "(was flags.trace on, and the pass sampled?)",
              file=sys.stderr)
        return 2
    if out_path is None:
        out_path = "world_trace.json"
    write_trace(trace, out_path)
    summary["out"] = out_path
    print(json.dumps(summary, default=str) if as_json
          else render_text(summary, out_path), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
