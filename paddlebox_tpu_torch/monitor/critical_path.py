"""Per-pass wall-time attribution — who owns the pass wall, and is it
getting worse. The port's copy of ``paddlebox_tpu/monitor/
critical_path.py``, one text for both packages' records.

The flight record carries the raw account: the pass wall (``seconds``),
the trainer's main-thread stage split (``stage_seconds``: read wait,
train dispatch, auc, post-loop drain; ``translate`` runs on the pack
thread and OVERLAPS), and the pass-boundary cost
(``extra.boundary_seconds`` — working-set build + H2D — with its
``boundary_split``: build vs H2D vs spill fault-in). This module turns
that into the statement an operator acts on: the **limiter** (the
largest attributable component), its **trend** across passes, and the
**overlap headroom** — how much of the boundary could hide under the
previous pass's train tail if the feed ran overlapped.

Pure functions over committed records: no hub, no torch — the doctor
calls in, offline or live.
"""

from __future__ import annotations

# stage_seconds keys that run on a worker thread and overlap the main
# loop (attributed separately — charging them to the wall would double-
# count the interval the train stage already covers)
OVERLAPPED_STAGES = ("translate",)

# components eligible to be the limiter, largest-first tie broken by
# this order (boundary first: it is the one with a named fix)
LIMITER_ORDER = ("boundary", "train", "read", "drain", "auc")


def attribute_pass(fr: dict) -> dict:
    """Wall-time attribution of ONE flight record (see module doc)."""
    wall = float(fr.get("seconds") or 0.0)
    extra = fr.get("extra") or {}
    stages = dict(fr.get("stage_seconds") or {})
    comp: dict[str, float] = {}
    overlapped: dict[str, float] = {}
    for name, v in stages.items():
        (overlapped if name in OVERLAPPED_STAGES else comp)[name] = \
            round(float(v), 6)
    boundary = float(extra.get("boundary_seconds") or 0.0)
    comp["boundary"] = round(boundary, 6)
    attributed = sum(comp.values())
    train = comp.get("train", 0.0)
    limiter = max(
        comp, key=lambda k: (comp[k],
                             -LIMITER_ORDER.index(k)
                             if k in LIMITER_ORDER else -len(LIMITER_ORDER)))
    out = {
        "pass_id": fr.get("pass_id"),
        "wall_seconds": round(wall, 6),
        "stages": comp,
        "overlapped": overlapped,
        "unattributed_seconds": round(max(0.0, wall - attributed), 6),
        "coverage": round(attributed / wall, 4) if wall > 0 else 0.0,
        "limiter": limiter,
        "limiter_seconds": comp[limiter],
        "limiter_share": (round(comp[limiter] / wall, 4)
                          if wall > 0 else 0.0),
        "boundary_share": round(boundary / wall, 4) if wall > 0 else 0.0,
        # the overlap story: a boundary built on the feed thread hides
        # under the PREVIOUS pass's train tail — the hideable amount is
        # bounded by both
        "overlap_headroom_seconds": round(min(boundary, train), 6),
    }
    split = extra.get("boundary_split")
    if isinstance(split, dict):
        out["boundary_split"] = {k: round(float(v), 6)
                                 for k, v in split.items()}
    return out


def _trend(values: "list[float]", rel_threshold: float = 0.1) -> str:
    """'rising' / 'falling' / 'flat' by first-vs-last relative change —
    pass-scale monitoring wants direction, not a regression fit."""
    if len(values) < 2:
        return "flat"
    first, last = values[0], values[-1]
    base = max(abs(first), 1e-9)
    if (last - first) / base > rel_threshold:
        return "rising"
    if (first - last) / base > rel_threshold:
        return "falling"
    return "flat"


def attribute_flow_edges(edges: "list[dict]",
                         wall_seconds_mean: "float | None" = None
                         ) -> dict:
    """Span-level cross-rank attribution: given the merged
    world trace's flow edges (``trace.summarize()["flow_edges"]`` —
    {kind, key, src_rank, dst_rank, latency_s}), name the LONGEST edge
    and the per-kind latency account. ``wall_seconds_mean`` (from
    :func:`attribute_records`'s passes) turns the longest latency into
    a share of the pass wall — the doctor's cross-rank-flow rule fires
    on that share. Negative latencies (a dst point observed before the
    src after clock correction) are kept and flagged: they measure the
    residual clock error, which is itself a diagnosis."""
    if not edges:
        return {"edges": 0, "longest": None, "by_kind": {}}
    by_kind: dict[str, dict] = {}
    for e in edges:
        k = str(e.get("kind"))
        b = by_kind.setdefault(k, {"count": 0, "max_latency_s": None,
                                   "mean_latency_s": 0.0})
        lat = float(e.get("latency_s") or 0.0)
        b["count"] += 1
        b["mean_latency_s"] += lat
        if b["max_latency_s"] is None or lat > b["max_latency_s"]:
            b["max_latency_s"] = round(lat, 6)
    for b in by_kind.values():
        b["mean_latency_s"] = round(b["mean_latency_s"] / b["count"], 6)
    longest = max(edges, key=lambda e: float(e.get("latency_s") or 0.0))
    out = {
        "edges": len(edges),
        "longest": {
            "kind": longest.get("kind"), "key": longest.get("key"),
            "src_rank": longest.get("src_rank"),
            "dst_rank": longest.get("dst_rank"),
            "latency_s": round(float(longest.get("latency_s") or 0.0), 6),
        },
        "by_kind": by_kind,
        "negative_edges": sum(
            1 for e in edges if float(e.get("latency_s") or 0.0) < 0),
    }
    if wall_seconds_mean:
        out["longest_share_of_wall"] = round(
            out["longest"]["latency_s"] / wall_seconds_mean, 4)
    return out


def attribute_records(flights: "list[dict]") -> dict:
    """Attribution of a run: one entry per pass plus the cross-pass
    summary the doctor's trend rules read. When several records carry
    one pass id (multiple ranks' streams merged by the aggregator) the
    SLOWEST record wins — the pass wall is the straggler's wall by
    definition, and the result must not depend on the order the rank
    roots were listed in."""
    by_pass: dict[int, dict] = {}
    for fr in flights:
        p = fr.get("pass_id")
        if p is None:
            continue
        cur = by_pass.get(int(p))
        if cur is None or float(fr.get("seconds") or 0.0) \
                > float(cur.get("seconds") or 0.0):
            by_pass[int(p)] = fr
    passes = [attribute_pass(by_pass[p]) for p in sorted(by_pass)]
    if not passes:
        return {"passes": [], "summary": {}}
    limiters = [p["limiter"] for p in passes]
    dominant = max(set(limiters), key=limiters.count)
    bshare = [p["boundary_share"] for p in passes]
    walls = [p["wall_seconds"] for p in passes]
    summary = {
        "passes": len(passes),
        "limiter": dominant,
        "limiter_per_pass": limiters,
        "limiter_share_mean": round(
            sum(p["limiter_share"] for p in passes) / len(passes), 4),
        "boundary_share_per_pass": [round(b, 4) for b in bshare],
        "boundary_share_trend": _trend(bshare),
        "wall_seconds_trend": _trend(walls),
        "overlap_headroom_seconds": round(
            sum(p["overlap_headroom_seconds"] for p in passes), 6),
    }
    return {"passes": passes, "summary": summary}
