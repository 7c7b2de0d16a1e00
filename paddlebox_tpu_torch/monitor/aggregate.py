"""Cross-rank flight-record aggregation — the READ side of the hub; the
port of ``paddlebox_tpu/monitor/aggregate.py``, reading either
package's streams.

Every rank emits a tagged JSONL event stream (one flight record per
pass) under a per-rank dir on local disk or a remote root. The
reference's operators watched per-pass stats and AUC lines across the
fleet by eye (log_for_profile, boxps_worker.cc:746-759). This module
turns N per-rank streams into one per-pass **world view**: which ranks
reported the pass, the rank-skew distribution of every stage, the
straggler by name, and the exchange-traffic / spill-tier imbalance
across shards — the facts the critical-path attributor and the run
doctor reason over.

Inputs are telemetry roots: a directory holding ``events.jsonl`` (plus
any rotated segments — :func:`order_segments` restores write order), a
direct path to one ``.jsonl`` file, or an ``hdfs://``-style remote dir
(read through :mod:`paddlebox_tpu_torch.utils.fs`, imported lazily so the
monitor package stays import-light).

Rank naming follows ``HeartbeatMonitor(rank_names=…)``: position i in
the roots list is named ``rank_names[i]`` when given (the launcher's
ORIGINAL rank ids — elastic shrunk worlds renumber densely), else the
``rank<N>`` number in the root's basename, else i — so the straggler the
aggregate names is the same rank the watchdog would name.
"""

from __future__ import annotations

import json
import os
import posixpath
import re

from paddlebox_tpu_torch.monitor import flight

# event names whose records are retained as evidence for the doctor;
# every other event is counted but not kept (a day-scale stream must
# aggregate in bounded memory)
EVIDENCE_EVENTS = ("peer_lost", "peer_stalled", "nan_guard",
                   "exchange_overflow", "pass_aborted",
                   "serving_publish_failed", "doctor.finding",
                   "sink_dropped", "sink_rotated", "resume_election",
                   "trace.clock_probe",
                   # self-healing runtime: what the controller
                   # did to the run, and the elastic grow it triggered
                   "remediation_applied", "remediation_reverted",
                   "world_grow",
                   # serving plane: the per-window serving
                   # flight record the doctor's serving rules read
                   "serving_window",
                   # serving fleet: the per-window fleet
                   # record the doctor's fleet-degraded rule reads, plus
                   # the supervision/promotion lifecycle events
                   "fleet_window", "fleet_replica_quarantined",
                   "fleet_promote_hold", "fleet.serving_stale")
KEEP_PER_NAME = 16
# serving window records retained per rank (one per window cadence — a
# day at 30s windows is ~3k records; cap keeps pathological streams
# bounded while holding far more history than the doctor's rules read)
MAX_SERVING_RECORDS = 512

_SEG_RE = re.compile(r"\.(\d{3,})\.jsonl$")
_RANK_RE = re.compile(r"rank[_-]?(\d+)", re.IGNORECASE)


# ---------------------------------------------------------------------------
# stream discovery + reading (local or remote)
# ---------------------------------------------------------------------------

def order_segments(names: list[str]) -> list[str]:
    """JSONL segment files in write order: per stem, the unnumbered base
    segment first, then numbered rotation segments ascending (the
    JsonlSink naming — sinks.segment_path)."""
    def key(name):
        base = posixpath.basename(name)
        m = _SEG_RE.search(base)
        if m:
            return (_SEG_RE.sub(".jsonl", base), 1, int(m.group(1)))
        return (base, 0, 0)
    return sorted(names, key=key)


def _is_remote(path: str) -> bool:
    return "://" in path and not path.lower().startswith("file://")


def discover_stream_files(root: str) -> list[str]:
    """The ordered JSONL segment files of one telemetry root."""
    if root.endswith(".jsonl"):
        return [root]
    if _is_remote(root):
        from paddlebox_tpu_torch.utils import fs as fs_lib
        fs, _ = fs_lib.resolve(root)
        entries = fs.ls(root)
    else:
        entries = [os.path.join(root, n) for n in sorted(os.listdir(root))]
    jsonl = []
    for e in entries:
        # ls may return full paths (LocalFS, hadoop -ls) or bare names
        if "/" not in e and not _is_remote(root):
            e = os.path.join(root, e)
        elif "/" not in e:
            e = posixpath.join(root, e)
        if e.endswith(".jsonl"):
            jsonl.append(e)
    return order_segments(jsonl)


def _iter_lines(root: str, path: str):
    if _is_remote(root):
        from paddlebox_tpu_torch.utils import fs as fs_lib
        fs, _ = fs_lib.resolve(root)
        yield from fs.read_lines(path)
    else:
        with open(path, errors="replace") as f:
            yield from f


def read_stream(root: str, trace_out: "dict | None" = None) -> dict:
    """Parse one rank's stream (all segments, in order) into the compact
    per-rank account: schema-validated flight records, counts + retained
    samples of the evidence events, and every schema error found.

    With ``trace_out`` (an empty dict), the SAME pass over the lines
    also collects the world-trace plane — ``trace_out`` is filled to the
    ``trace.read_trace_records`` shape (kept span/flow/lifecycle/flight
    records, clock probes, bounded by the trace module's per-rank cap)
    so a consumer needing both views parses every rotated segment
    once, not twice."""
    files = discover_stream_files(root)
    flights: list[dict] = []
    servings: list[dict] = []
    fleets: list[dict] = []
    errors: list[str] = []
    event_counts: dict[str, int] = {}
    evidence: dict[str, list[dict]] = {}
    threads: set[str] = set()
    n = 0
    keep_types: tuple = ()
    max_trace = 0
    if trace_out is not None:
        # lazy: trace imports this module at top level — the cycle is
        # broken by deferring this side (same as merge_world_trace)
        from paddlebox_tpu_torch.monitor import trace as trace_lib
        keep_types = trace_lib.KEEP_TYPES
        max_trace = trace_lib.MAX_RECORDS_PER_RANK
        trace_out.update(root=root, events=0, records=[],
                         clock_probes=[], dropped=0)
    for path in files:
        seg = posixpath.basename(path)
        for lineno, line in enumerate(_iter_lines(root, path), 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"{seg}:{lineno}: unparseable JSON ({e})")
                continue
            n += 1
            name = rec.get("name")
            typ = rec.get("type")
            if trace_out is not None:
                trace_out["events"] += 1
                if name == "trace.clock_probe":
                    trace_out["clock_probes"].append(
                        rec.get("fields") or {})
                elif typ in keep_types:
                    if len(trace_out["records"]) >= max_trace:
                        trace_out["dropped"] += 1
                    else:
                        trace_out["records"].append(rec)
            if typ != "meta":
                if typ == "flight_record":
                    errs = flight.validate_flight_record(rec)
                elif typ == "serving_record":
                    errs = flight.validate_serving_record(rec)
                elif typ == "fleet_record":
                    errs = flight.validate_fleet_record(rec)
                else:
                    errs = flight.validate_event(rec)
                for e in errs:
                    errors.append(f"{seg}:{lineno} ({name}): {e}")
            if typ == "flight_record":
                flights.append(rec)
            elif typ == "serving_record" \
                    and len(servings) < MAX_SERVING_RECORDS:
                servings.append(rec)
            elif typ == "fleet_record" \
                    and len(fleets) < MAX_SERVING_RECORDS:
                fleets.append(rec)
            if rec.get("thread"):
                threads.add(rec["thread"])
            if isinstance(name, str):
                event_counts[name] = event_counts.get(name, 0) + 1
                if name in EVIDENCE_EVENTS:
                    kept = evidence.setdefault(name, [])
                    if len(kept) < KEEP_PER_NAME:
                        kept.append(rec)
    flights.sort(key=lambda r: (r.get("pass_id") or 0, r.get("ts") or 0))
    servings.sort(key=lambda r: r.get("ts") or 0)
    fleets.sort(key=lambda r: r.get("ts") or 0)
    return {"root": root, "files": files, "events": n,
            "flight_records": flights, "serving_records": servings,
            "fleet_records": fleets,
            "errors": errors,
            "event_counts": event_counts, "evidence": evidence,
            "threads": sorted(threads)}


# ---------------------------------------------------------------------------
# world view
# ---------------------------------------------------------------------------

def rank_label(root: str, i: int,
               rank_names: "list[int] | None" = None) -> int:
    """Position i's rank name — the HeartbeatMonitor naming rule: the
    launcher's original id via ``rank_names``, else the rank number in
    the root's basename, else the position itself."""
    if rank_names is not None and i < len(rank_names):
        return int(rank_names[i])
    base = posixpath.basename(root.rstrip("/")) or root
    m = _RANK_RE.search(base)
    if m:
        return int(m.group(1))
    return i


def _dist(values: "dict[int, float]") -> dict:
    """Rank-skew account of one per-rank scalar: extremes WITH the rank
    that set them (the straggler naming), mean, and max/mean skew."""
    vals = list(values.values())
    mean = sum(vals) / len(vals)
    max_rank = max(values, key=lambda r: values[r])
    min_rank = min(values, key=lambda r: values[r])
    return {"min": round(min(vals), 6), "max": round(max(vals), 6),
            "mean": round(mean, 6),
            "max_rank": max_rank, "min_rank": min_rank,
            "skew": round(max(vals) / mean, 4) if mean > 0 else 1.0}


def _per_rank(by_rank: "dict[int, dict]", getter) -> "dict[int, float]":
    out = {}
    for r, fr in by_rank.items():
        v = getter(fr)
        if v is not None:
            out[r] = float(v)
    return out


def _delta(fr: dict, key: str):
    return (fr.get("stats_delta") or {}).get(key)


def _ratio_of_deltas(fr: dict, num: str, den: str):
    d = _delta(fr, den)
    if not d:
        return None
    return (_delta(fr, num) or 0.0) / d


def _pass_view(pass_id: int, by_rank: "dict[int, dict]",
               all_ranks: "list[int]") -> dict:
    view: dict = {
        "pass_id": pass_id,
        "ranks_reporting": len(by_rank),
        "missing_ranks": [r for r in all_ranks if r not in by_rank],
        "steps": sum(fr.get("steps", 0) for fr in by_rank.values()),
        "examples": sum(fr.get("examples", 0) for fr in by_rank.values()),
    }
    secs = _per_rank(by_rank, lambda fr: fr.get("seconds"))
    if secs:
        view["seconds"] = _dist(secs)
        view["straggler"] = view["seconds"]["max_rank"]
    eps = _per_rank(by_rank, lambda fr: fr.get("examples_per_sec"))
    if eps:
        view["examples_per_sec"] = _dist(eps)
    stages = sorted({s for fr in by_rank.values()
                     for s in (fr.get("stage_seconds") or {})})
    skew = {}
    for s in stages:
        vals = _per_rank(by_rank,
                         lambda fr: (fr.get("stage_seconds") or {}).get(s))
        if vals:
            skew[s] = _dist(vals)
    if skew:
        view["stage_skew"] = skew
    bnd = _per_rank(by_rank,
                    lambda fr: (fr.get("extra") or {})
                    .get("boundary_seconds"))
    if bnd:
        view["boundary_seconds"] = _dist(bnd)
    # per-component boundary skew (build / h2d / spill_fault_in): the
    # overlap-aware boundary-wall rule names the slowest-BUILDING host
    # off boundary_split.build's max_rank, not just the overall
    # straggler — per-host ownership makes build the component that
    # should divide by world size, so its skew is the diagnosis
    bsplit: dict = {}
    comps = sorted({c for fr in by_rank.values()
                    for c in ((fr.get("extra") or {})
                              .get("boundary_split") or {})})
    for comp in comps:
        vals = _per_rank(by_rank,
                         lambda fr: ((fr.get("extra") or {})
                                     .get("boundary_split") or {})
                         .get(comp))
        if vals:
            bsplit[comp] = _dist(vals)
    if bsplit:
        view["boundary_split"] = bsplit
    # exchange traffic imbalance across shards (per-pass counter deltas)
    exch: dict = {}
    for key in ("exchange.tokens", "exchange.unique_lanes",
                "exchange.pull_bytes", "exchange.push_bytes"):
        vals = _per_rank(by_rank, lambda fr: _delta(fr, key))
        if vals:
            exch[key.split(".", 1)[1]] = _dist(vals)
    dedup = _per_rank(by_rank, lambda fr: _ratio_of_deltas(
        fr, "exchange.unique_lanes", "exchange.tokens"))
    if not dedup:
        dedup = _per_rank(by_rank, lambda fr: _ratio_of_deltas(
            fr, "trainer.plan_unique_tokens", "trainer.plan_tokens"))
    if dedup:
        exch["dedup_ratio"] = _dist(dedup)
    for key in ("exchange.overflow_retries", "exchange.overflow_dropped"):
        total = sum(_per_rank(by_rank,
                              lambda fr: _delta(fr, key)).values())
        if total:
            exch[key.split(".", 1)[1]] = int(total)
    if exch:
        view["exchange"] = exch
    # spill-tier imbalance (hit rate per rank + admission/eviction flow)
    tier: dict = {}
    hits = _per_rank(by_rank, lambda fr: _delta(fr, "spill.cache_hits"))
    misses = _per_rank(by_rank,
                       lambda fr: _delta(fr, "spill.cache_misses"))
    rate = {}
    for r in set(hits) | set(misses):
        seen = hits.get(r, 0.0) + misses.get(r, 0.0)
        if seen:
            rate[r] = hits.get(r, 0.0) / seen
    if rate:
        tier["hit_rate"] = _dist(rate)
    for key in ("tiering.admitted", "tiering.evicted"):
        total = sum(_per_rank(by_rank,
                              lambda fr: _delta(fr, key)).values())
        if total:
            tier[key.split(".", 1)[1]] = int(total)
    if tier:
        view["tiering"] = tier
    return view


def merge_world_trace(roots: "list[str]",
                      rank_names: "list[int] | None" = None) -> dict:
    """Merge the same per-rank roots into ONE clock-corrected Chrome-
    trace-event JSON (rank→process, thread→thread, flow arrows for the
    exchange and publish→swap edges) — the span-level companion of
    :func:`aggregate`. Thin front for :mod:`paddlebox_tpu_torch.monitor.trace`
    (which reuses this module's stream discovery + rank naming); lazy
    import keeps the two modules acyclic."""
    from paddlebox_tpu_torch.monitor import trace as trace_lib
    return trace_lib.merge_roots(roots, rank_names=rank_names)


def aggregate(roots: "list[str]",
              rank_names: "list[int] | None" = None) -> dict:
    """Merge per-rank telemetry roots into the per-pass world view."""
    streams = [read_stream(r) for r in roots]
    labels = [rank_label(r, i, rank_names) for i, r in enumerate(roots)]
    return _world_view(streams, labels, roots)


def aggregate_with_trace(roots: "list[str]",
                         rank_names: "list[int] | None" = None
                         ) -> tuple[dict, dict]:
    """Both read-side views from ONE pass over the streams: the per-pass
    world view (:func:`aggregate`) AND the clock-corrected merged world
    trace (:func:`merge_world_trace`), as ``(world, trace)``. The doctor
    CLI needs both; calling the two entry points separately parses every
    rotated segment twice — here each line is read and decoded once."""
    trace_streams: list[dict] = [{} for _ in roots]
    streams = [read_stream(r, trace_out=t)
               for r, t in zip(roots, trace_streams)]
    labels = [rank_label(r, i, rank_names) for i, r in enumerate(roots)]
    from paddlebox_tpu_torch.monitor import trace as trace_lib
    return (_world_view(streams, labels, roots),
            trace_lib.merge_streams(trace_streams, labels))


def _world_view(streams: "list[dict]", labels: "list[int]",
                roots: "list[str]") -> dict:
    per_pass: dict[int, dict[int, dict]] = {}
    for label, st in zip(labels, streams):
        for fr in st["flight_records"]:
            p = fr.get("pass_id")
            if p is None:
                continue
            # phased programs may commit one record per phase; keep the
            # LAST record of the pass per rank (it carries the full
            # accumulated stage split)
            per_pass.setdefault(int(p), {})[label] = fr
    passes = [_pass_view(p, per_pass[p], labels)
              for p in sorted(per_pass)]
    evidence: dict[str, list[dict]] = {}
    event_counts: dict[str, int] = {}
    for st in streams:
        for name, c in st["event_counts"].items():
            event_counts[name] = event_counts.get(name, 0) + c
        for name, kept in st["evidence"].items():
            bucket = evidence.setdefault(name, [])
            bucket.extend(kept[:max(0, KEEP_PER_NAME - len(bucket))])
    # cumulative counter view: per-name sum of every pass delta across
    # ranks (counters start at 0, so the summed deltas ARE the run
    # totals; for gauges this is last-minus-first — documented, and the
    # doctor's rules read per-pass deltas anyway)
    counters: dict[str, float] = {}
    for st in streams:
        for fr in st["flight_records"]:
            for k, v in (fr.get("stats_delta") or {}).items():
                counters[k] = counters.get(k, 0.0) + float(v)
    return {
        "ranks": [{"rank": label, "root": st["root"],
                   "files": [posixpath.basename(f) for f in st["files"]],
                   "events": st["events"],
                   "flight_records": len(st["flight_records"]),
                   "errors": st["errors"][:8],
                   "error_count": len(st["errors"])}
                  for label, st in zip(labels, streams)],
        "world_size": len(roots),
        "passes": passes,
        "counters": {k: round(v, 6) for k, v in sorted(counters.items())},
        "event_counts": event_counts,
        "evidence": evidence,
        "flight_records": [fr for st in streams
                           for fr in st["flight_records"]],
        # serving plane: every rank's window records, merged
        # in time order — what the doctor's serving rules read
        "serving_records": sorted(
            (sr for st in streams
             for sr in st.get("serving_records", ())),
            key=lambda r: r.get("ts") or 0),
        # fleet plane: every host's fleet window records,
        # merged in time order — what the fleet-degraded rule reads
        "fleet_records": sorted(
            (fr for st in streams
             for fr in st.get("fleet_records", ())),
            key=lambda r: r.get("ts") or 0),
    }
