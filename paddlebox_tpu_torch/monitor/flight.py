"""Flight-record and event schema — the port's copy of
``paddlebox_tpu/monitor/flight.py``, one text for both packages.

Everything the hub emits is one JSON object per line; dashboards, the
benchmark and the tests key off these shapes, so the schema is code
(validators returning error strings), not prose. The flight record is
the per-pass unit: stage-time split, throughput, STATS deltas since the
pass started, and the metric-registry snapshot — the log_for_profile
line, made parseable. ``validate_fleet_record`` describes the
``fleet_window`` record that the serving fleet
(``serving/fleet.ReplicaFleet.commit_window``) emits each window.
"""

from __future__ import annotations

import json
import numbers

# keys every hub record carries (pass_id/step/phase may be null outside a
# pass — but the KEYS are always present, so consumers never branch)
EVENT_REQUIRED_KEYS = ("ts", "type", "name", "pass_id", "step", "phase",
                       "thread")

# flight-record fields beyond the event envelope, with required types
FLIGHT_REQUIRED_FIELDS = {
    "seconds": numbers.Real,
    "steps": numbers.Integral,
    "examples": numbers.Integral,
    "examples_per_sec": numbers.Real,
    "stage_seconds": dict,
    "stats_delta": dict,
    "metrics": dict,
}


def validate_event(rec: dict) -> list[str]:
    """Schema errors for one hub record (empty list = valid)."""
    errs = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    for k in EVENT_REQUIRED_KEYS:
        if k not in rec:
            errs.append(f"missing key {k!r}")
    if "ts" in rec and not isinstance(rec["ts"], numbers.Real):
        errs.append("ts is not a number")
    for k in ("pass_id", "step"):
        v = rec.get(k)
        if v is not None and not isinstance(v, numbers.Integral):
            errs.append(f"{k} is neither null nor an integer")
    # world-trace context (monitor/trace.py): OPTIONAL — records emitted
    # outside a traced pass carry none of it — but when present the ids
    # are flat strings (the merger and any downstream OTel bridge key
    # off them verbatim)
    for k in ("trace_id", "span_id", "parent_span_id"):
        v = rec.get(k)
        if v is not None and not isinstance(v, str):
            errs.append(f"{k} is neither null nor a string")
    if rec.get("name") == "trace.flow":
        f = rec.get("fields") or {}
        for k in ("kind", "key", "role"):
            if not isinstance(f.get(k), str):
                errs.append(f"trace.flow fields[{k!r}] is not a string")
    if rec.get("name") == "trace.clock_probe":
        f = rec.get("fields") or {}
        for k in ("peer", "observer"):
            if not isinstance(f.get(k), numbers.Integral):
                errs.append(
                    f"trace.clock_probe fields[{k!r}] is not an integer")
        for k in ("offset_s", "rtt_s"):
            if not isinstance(f.get(k), numbers.Real):
                errs.append(
                    f"trace.clock_probe fields[{k!r}] is not a number")
    return errs


def validate_flight_record(rec: dict) -> list[str]:
    """Schema errors for a flight record (includes the event envelope)."""
    errs = validate_event(rec)
    if rec.get("type") != "flight_record":
        errs.append(f"type is {rec.get('type')!r}, not 'flight_record'")
    if not isinstance(rec.get("pass_id"), numbers.Integral):
        errs.append("flight record pass_id must be an integer")
    for k, want in FLIGHT_REQUIRED_FIELDS.items():
        if k not in rec:
            errs.append(f"missing field {k!r}")
        elif not isinstance(rec[k], want):
            errs.append(f"{k} is {type(rec[k]).__name__}, want "
                        f"{want.__name__}")
    for k in ("stage_seconds", "stats_delta"):
        for name, v in (rec.get(k) or {}).items():
            if not isinstance(v, numbers.Real):
                errs.append(f"{k}[{name!r}] is not a number")
    # the trainer's engine-identity envelope (pull_engine, table_layout,
    # exchange_wire, …): optional, but when present it must be a flat
    # JSON object — dashboards key off these fields verbatim
    extra = rec.get("extra")
    if extra is not None and not isinstance(extra, dict):
        errs.append(f"extra is {type(extra).__name__}, not an object")
    # tiered-table telemetry (embedding/tiering.py): the admission/
    # eviction COUNTERS are monotone, so their per-pass deltas can never
    # be negative (a negative delta means a consumer double-counted or
    # the counter was rebuilt mid-pass), and the tier identity is a flat
    # string like the other engine-identity fields
    for k in ("tiering.admitted", "tiering.evicted",
              "tiering.conflict_misses", "tiering.replica_hits"):
        v = (rec.get("stats_delta") or {}).get(k)
        if isinstance(v, numbers.Real) and v < 0:
            errs.append(f"stats_delta[{k!r}] is negative — tiering "
                        "counters are monotone")
    if isinstance(extra, dict):
        tt = extra.get("table_tiering")
        if tt is not None and not isinstance(tt, str):
            errs.append("extra['table_tiering'] is not a string")
        # sharded-exchange identity (trainer extras): the pass's active
        # wire/topology and — under flags.exchange_adaptive — the
        # controller's verdict for the NEXT pass. Flat strings from the
        # closed vocabularies; dashboards and the doctor's exchange
        # rules key off them verbatim
        for k, vocab in (("exchange_wire", ("f32", "bf16", "int8")),
                         ("exchange_wire_next", ("f32", "bf16", "int8")),
                         ("exchange_topology", ("flat", "hier"))):
            v = extra.get(k)
            if v is not None and (not isinstance(v, str)
                                  or v not in vocab):
                errs.append(f"extra[{k!r}] is not one of {vocab}")
        # the pass-boundary account (trainer extra): the wall is a
        # non-negative number and the split is a flat object of
        # non-negative component seconds — the critical-path attributor
        # (monitor/critical_path.py) consumes both verbatim
        bs = extra.get("boundary_seconds")
        if bs is not None and (not isinstance(bs, numbers.Real) or bs < 0):
            errs.append("extra['boundary_seconds'] is not a non-negative "
                        "number")
        split = extra.get("boundary_split")
        if split is not None:
            if not isinstance(split, dict):
                errs.append("extra['boundary_split'] is not an object")
            else:
                for name, v in split.items():
                    if not isinstance(v, numbers.Real) or v < 0:
                        errs.append(f"boundary_split[{name!r}] is not a "
                                    "non-negative number")
        # the self-healing runtime's remediation record (
        # runtime/remediation.py): what the controller did to the run
        # this pass. rule/action name the doctor rule and its mapped
        # Action; status is the closed applied/reverted vocabulary the
        # --fail-on CI gate keys off; before/after are the watched
        # counters' per-pass deltas (flat numeric objects) bracketing
        # the apply — the honesty record
        rem = extra.get("remediation")
        if rem is not None:
            if not isinstance(rem, dict):
                errs.append("extra['remediation'] is not an object")
            else:
                for k in ("rule", "action"):
                    if not isinstance(rem.get(k), str):
                        errs.append(f"remediation[{k!r}] is not a string")
                if rem.get("status") not in ("applied", "reverted"):
                    errs.append("remediation['status'] is not one of "
                                "('applied', 'reverted')")
                if (rem.get("reason") is not None
                        and not isinstance(rem["reason"], str)):
                    errs.append("remediation['reason'] is not a string")
                for k in ("before", "after"):
                    win = rem.get(k)
                    if win is None:
                        continue
                    if not isinstance(win, dict):
                        errs.append(f"remediation[{k!r}] is not an object")
                        continue
                    for name, v in win.items():
                        if not isinstance(v, numbers.Real):
                            errs.append(f"remediation {k}[{name!r}] is "
                                        "not a number")
    return errs


# serving-window record fields (serving/obs.py, under rec["fields"]
# because the record rides the generic hub.event envelope), with
# required types — the serving plane's flight record
SERVING_REQUIRED_FIELDS = {
    "window_s": numbers.Real,
    "requests": numbers.Integral,
    "failures": numbers.Integral,
    "swaps": numbers.Integral,
    "version_lag": numbers.Integral,
    "slo_ms": numbers.Real,
    "p50_ms": numbers.Real,
    "p99_ms": numbers.Real,
}

# per-version attribution fields inside fields["versions"][vid]: role is
# the closed stable/candidate vocabulary; the rest are numbers when
# present (auc is absent until delayed labels arrive)
_SERVING_VERSION_NUMERIC = ("p50_ms", "p99_ms", "requests", "score_mean",
                            "auc", "score_kl")


def validate_serving_record(rec: dict) -> list[str]:
    """Schema errors for a serving window record.

    The record is a hub event (``type="serving_record"``, name
    ``serving_window``) whose payload lives under ``fields`` — the
    serving plane's per-window flight record: request/failure counts,
    windowed p50/p99, version lag, swap count, and a ``versions`` object
    with per-version latency/score/AUC attribution."""
    errs = validate_event(rec)
    if rec.get("type") != "serving_record":
        errs.append(f"type is {rec.get('type')!r}, not 'serving_record'")
    f = rec.get("fields")
    if not isinstance(f, dict):
        return errs + [f"fields is {type(f).__name__}, not an object"]
    for k, want in SERVING_REQUIRED_FIELDS.items():
        if k not in f:
            errs.append(f"missing field {k!r}")
        elif not isinstance(f[k], want) or isinstance(f[k], bool):
            errs.append(f"fields[{k!r}] is {type(f[k]).__name__}, want "
                        f"{want.__name__}")
    versions = f.get("versions")
    if versions is None:
        return errs
    if not isinstance(versions, dict):
        return errs + ["fields['versions'] is not an object"]
    for vid, v in versions.items():
        if not isinstance(v, dict):
            errs.append(f"versions[{vid!r}] is not an object")
            continue
        if v.get("role") not in ("stable", "candidate"):
            errs.append(f"versions[{vid!r}]['role'] is not one of "
                        "('stable', 'candidate')")
        for k in _SERVING_VERSION_NUMERIC:
            val = v.get(k)
            if val is not None and (not isinstance(val, numbers.Real)
                                    or isinstance(val, bool)):
                errs.append(f"versions[{vid!r}][{k!r}] is neither null "
                            "nor a number")
    return errs


# fleet-window record fields (serving/fleet.py, under rec["fields"]) —
# the replica-fleet plane's flight record: fleet health
# (healthy/quarantined replica counts), router traffic accounting
# (sheds/retries/hedges), supervision (restarts), promotion governance
# (promote holds), and the fleet-wide latency tail
FLEET_REQUIRED_FIELDS = {
    "window_s": numbers.Real,
    "replicas": numbers.Integral,
    "healthy": numbers.Integral,
    "quarantined": numbers.Integral,
    "requests": numbers.Integral,
    "sheds": numbers.Integral,
    "retries": numbers.Integral,
    "hedges": numbers.Integral,
    "hedges_won": numbers.Integral,
    "restarts": numbers.Integral,
    "promote_holds": numbers.Integral,
    "p50_ms": numbers.Real,
    "p99_ms": numbers.Real,
}


def validate_fleet_record(rec: dict) -> list[str]:
    """Schema errors for a fleet window record.

    The record is a hub event (``type="fleet_record"``, name
    ``fleet_window``) whose payload lives under ``fields`` — the
    replica-fleet counterpart of the serving window record: replica
    health counts, router shed/retry/hedge accounting, restart and
    promote-hold counts, and the fleet-wide p50/p99."""
    errs = validate_event(rec)
    if rec.get("type") != "fleet_record":
        errs.append(f"type is {rec.get('type')!r}, not 'fleet_record'")
    f = rec.get("fields")
    if not isinstance(f, dict):
        return errs + [f"fields is {type(f).__name__}, not an object"]
    for k, want in FLEET_REQUIRED_FIELDS.items():
        if k not in f:
            errs.append(f"missing field {k!r}")
        elif not isinstance(f[k], want) or isinstance(f[k], bool):
            errs.append(f"fields[{k!r}] is {type(f[k]).__name__}, want "
                        f"{want.__name__}")
    if f.get("healthy", 0) and f.get("replicas") is not None \
            and isinstance(f.get("healthy"), numbers.Integral) \
            and isinstance(f.get("replicas"), numbers.Integral) \
            and f["healthy"] > f["replicas"]:
        errs.append("fields['healthy'] exceeds fields['replicas']")
    return errs


def validate_events_file(path: str) -> dict:
    """Validate a JSONL event stream end to end.

    Returns {"events": n, "flight_records": [...], "errors": [...],
    "threads": set-as-list} — ``errors`` empty means every line parsed and
    every record (flight records included) passed its schema."""
    n = 0
    flights: list[dict] = []
    errors: list[str] = []
    threads: set = set()
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: unparseable JSON ({e})")
                continue
            n += 1
            if rec.get("type") == "meta":
                continue              # sink bookkeeping, not telemetry
            if rec.get("type") == "flight_record":
                errs = validate_flight_record(rec)
            elif rec.get("type") == "serving_record":
                errs = validate_serving_record(rec)
            elif rec.get("type") == "fleet_record":
                errs = validate_fleet_record(rec)
            else:
                errs = validate_event(rec)
            for e in errs:
                errors.append(f"line {lineno} ({rec.get('name')}): {e}")
            if rec.get("type") == "flight_record":
                flights.append(rec)
            if rec.get("thread"):
                threads.add(rec["thread"])
    return {"events": n, "flight_records": flights, "errors": errors,
            "threads": sorted(threads)}
