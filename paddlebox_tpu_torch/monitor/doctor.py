"""Run doctor — named, evidence-carrying diagnoses over the telemetry
the hub emits; the port of ``paddlebox_tpu/monitor/doctor.py``. Rule
ids, statuses, severities and evidence keys are the reference's, so a
report reads the same over either package's streams.

The reference's operators kept day-scale CTR runs healthy by reading
per-pass stats and AUC logs (SURVEY.md; log_for_profile) and pattern-
matching against incidents they had seen before. This module is that
pattern-matching, written down: every rule is grounded in a prior
incident (its ``incident`` text), reads
only committed telemetry (flight records, counter deltas, retained
evidence events, sink health), and returns a **named finding** carrying
the evidence that fired it and the flag/runbook step that addresses it.
A rule that cannot see its inputs says ``no-data`` — an absent signal is
not a healthy signal.

Three entry points:

- **CLI** — ``python -m paddlebox_tpu_torch.monitor.doctor
  <telemetry_dir>… [--json] [--rank-names 4,5,7] [--fail-on SEVERITY]``:
  aggregates the per-rank streams (monitor/aggregate.py — local dirs or
  remote roots), attributes the
  critical path per pass (monitor/critical_path.py), evaluates every
  rule, prints the report (human text, or one JSON object with
  ``--json``). Exit 0 = report produced (findings included); 1 = a
  finding at or above ``--fail-on``; 2 = inputs unreadable.
- **Live** — ``flags.doctor_live``: the hub calls :func:`run_live` at
  every ``end_pass``; findings are emitted as ``doctor.finding`` events
  into the event stream (tagged with the pass that produced them) and
  returned through ``BoxPS.end_pass``; ``runtime.remediation`` reads
  them at the pass boundary (``flags.self_healing``).
- **Embedded** — :func:`diagnose` over any records, with ``detail``
  carrying extras such as ``utils.step_probe.push_floor_analysis``'s
  statement (the push-floor rule's input).

A rule whose inputs a run did not emit answers ``no-data``, as the
reference's do. The ``fleet-degraded`` rule reads the ``fleet_window``
records that ``serving/fleet.ReplicaFleet.commit_window`` emits.
"""

from __future__ import annotations

import json
import sys

from paddlebox_tpu_torch.monitor import critical_path as cp_lib
from paddlebox_tpu_torch.monitor.registry import STATS

REPORT_VERSION = 1

RULE_STATUSES = ("fired", "quiet", "no-data")


class Finding(dict):
    """A named diagnosis: plain dict subclass so reports JSON-serialize
    verbatim; constructor enforces the required fields."""

    def __init__(self, rule: str, severity: str, summary: str,
                 evidence: dict, suggestion: str):
        super().__init__(rule=rule, severity=severity, summary=summary,
                         evidence=evidence, suggestion=suggestion)


class DoctorContext:
    """Everything a rule may read. ``flights`` are schema-shaped flight
    records (sorted by pass); ``counters`` the cumulative registry view
    (live: STATS snapshot; offline: summed per-pass deltas);
    ``evidence`` retained event samples by name; ``world`` the
    aggregate's per-pass world view when multiple ranks were read;
    ``detail`` extras (step_probe's push_floor analysis, the merged
    world trace's summary);
    ``sink_health`` the hub's per-sink account."""

    def __init__(self, flights=None, counters=None, evidence=None,
                 world=None, detail=None, sink_health=None,
                 servings=None, fleets=None):
        self.flights = sorted(flights or [],
                              key=lambda fr: (fr.get("pass_id") or 0))
        self.counters = dict(counters or {})
        self.evidence = dict(evidence or {})
        self.world = world
        self.detail = dict(detail or {})
        self.sink_health = list(sink_health or [])
        # serving plane: per-window serving records, oldest
        # first, flattened to their field payloads. Explicit ``servings``
        # (the aggregate's serving_records) wins; the retained
        # serving_window evidence is the fallback so the CLI's
        # single-rank path still feeds the serving rules
        raw = servings if servings is not None \
            else (self.evidence.get("serving_window") or [])
        self.servings = []
        for r in raw:
            if not isinstance(r, dict):
                continue
            f = r.get("fields") if isinstance(r.get("fields"), dict) \
                else r
            w = dict(f)
            w["ts"] = r.get("ts") or f.get("ts") or 0
            self.servings.append(w)
        self.servings.sort(key=lambda w: w["ts"])
        # fleet plane: per-window fleet records, flattened the
        # same way — explicit ``fleets`` (the aggregate's fleet_records)
        # wins, retained fleet_window evidence is the fallback
        raw_f = fleets if fleets is not None \
            else (self.evidence.get("fleet_window") or [])
        self.fleets = []
        for r in raw_f:
            if not isinstance(r, dict):
                continue
            f = r.get("fields") if isinstance(r.get("fields"), dict) \
                else r
            w = dict(f)
            w["ts"] = r.get("ts") or f.get("ts") or 0
            self.fleets.append(w)
        self.fleets.sort(key=lambda w: w["ts"])
        self.attribution = cp_lib.attribute_records(self.flights)

    def pass_deltas(self, key: str) -> "list[tuple[int, float]]":
        """(pass_id, stats_delta[key]) per pass, SUMMED across records
        sharing a pass id — merged multi-rank streams carry one record
        per (pass, rank), and a last-wins collapse would make every
        trend rule depend on the order the rank roots were listed in
        (the world totals are what the rules reason over)."""
        acc: dict[int, float] = {}
        for fr in self.flights:
            v = (fr.get("stats_delta") or {}).get(key)
            if v is not None and fr.get("pass_id") is not None:
                p = int(fr["pass_id"])
                acc[p] = acc.get(p, 0.0) + float(v)
        return sorted(acc.items())

    def counter(self, key: str) -> float:
        return float(self.counters.get(key, 0.0))


class Rule:
    """One diagnosis. ``id`` names the finding; ``incident`` is the
    prior incident that grounds it (docs/PARITY.md table); ``evaluate``
    returns (status, finding-or-None)."""

    id: str = ""
    doc: str = ""
    incident: str = ""

    def evaluate(self, ctx: DoctorContext):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

class BoundaryWallRule(Rule):
    id = "boundary-wall"
    doc = "pass-boundary build+H2D dominates the pass wall"
    incident = ("ROADMAP 'Kill the pass-boundary wall': recorded e2e "
                "rounds show boundary_seconds 23-68s against 39-115s "
                "train per pass — up to half the wall is working-set "
                "build + H2D")
    SHARE = 0.25

    # suggestion arm per dominant residual component — the overlap-aware
    # attribution names the concrete knob, not a menu
    _COMPONENT_FIX = {
        "build": ("host-side build dominates: bind per-host shard "
                  "ownership (Trainer.set_shard_ownership / distributed."
                  "ownership.ShardOwnership) so each host fetches only "
                  "its shards' rows — build divides by world size"),
        "h2d": ("H2D dominates: resident-row reuse is the lever — keep "
                "flags.incremental_feed=True so store mutations "
                "(shrink/replay) re-ship only the touched rows instead "
                "of the full table"),
        "spill_fault_in": ("disk fault-in dominates: raise "
                           "flags.spill_cache_rows (or turn on "
                           "flags.spill_cache_autotune) and keep "
                           "flags.spill_prefetch=True so the stager "
                           "thread's madvise(WILLNEED) readahead "
                           "overlaps the build"),
    }

    def evaluate(self, ctx):
        passes = [p for p in ctx.attribution.get("passes", [])
                  if p["stages"].get("boundary", 0.0) > 0.0]
        if not passes:
            return "no-data", None
        worst = max(passes, key=lambda p: p["boundary_share"])
        if worst["boundary_share"] < self.SHARE:
            return "quiet", None
        summary = ctx.attribution["summary"]
        ev = {
            "worst_pass": worst["pass_id"],
            "boundary_seconds": worst["stages"]["boundary"],
            "train_seconds": worst["stages"].get("train", 0.0),
            "boundary_share": worst["boundary_share"],
            "boundary_share_per_pass":
                summary.get("boundary_share_per_pass"),
            "trend": summary.get("boundary_share_trend"),
            "overlap_headroom_seconds":
                summary.get("overlap_headroom_seconds"),
        }
        residual = None
        if "boundary_split" in worst:
            ev["boundary_split"] = worst["boundary_split"]
            split = worst["boundary_split"]
            if split:
                residual = max(split, key=lambda k: split[k])
                ev["residual_component"] = residual
        # reuse balance from the per-pass counter deltas: fresh rows
        # flowing with NO reused rows means every boundary re-ships the
        # working set — the concrete incremental-feed suggestion
        fresh = sum(v for _, v in ctx.pass_deltas("feed_pass.fresh_rows"))
        reused = sum(v for _, v in
                     ctx.pass_deltas("feed_pass.reused_rows"))
        reuse_off = fresh > 0 and reused == 0
        ev["fresh_rows"] = int(fresh)
        ev["reused_rows"] = int(reused)
        if ctx.world:
            for pv in ctx.world.get("passes", []):
                if pv.get("pass_id") != worst["pass_id"]:
                    continue
                if "straggler" in pv:
                    ev["straggler_rank"] = pv["straggler"]
                # the slowest-BUILDING host, per component skew — the
                # rank whose host fetch sets the world's boundary wall
                wb = (pv.get("boundary_split") or {}).get("build")
                if wb:
                    ev["slowest_build_rank"] = wb["max_rank"]
                    ev["build_skew"] = wb.get("skew")
        fix = ["overlap the next pass's build with this pass's tail: "
               "train_pass(preload_keys=next_pass_keys)"]
        if residual in self._COMPONENT_FIX:
            fix.append(self._COMPONENT_FIX[residual])
        if reuse_off:
            fix.append(
                "resident reuse is OFF (fresh rows every pass, zero "
                "reused): set flags.incremental_feed=True so mutations "
                "ship deltas instead of invalidating the working set, "
                "and check for per-pass store restores/replays that "
                "reset it")
        if "slowest_build_rank" in ev:
            fix.append(f"rank {ev['slowest_build_rank']} builds "
                       "slowest — check its shard ownership balance "
                       "and spill tier")
        return "fired", Finding(
            self.id, "warn",
            f"pass {worst['pass_id']}: boundary work is "
            f"{worst['boundary_share']:.0%} of the pass wall "
            f"({worst['stages']['boundary']:.2f}s of "
            f"{worst['wall_seconds']:.2f}s)", ev,
            "; ".join(fix))


class ExchangeOverflowRule(Rule):
    id = "exchange-overflow"
    doc = "all_to_all capacity overflow retries growing across passes"
    incident = ("exchange overflow is never silent — drops are "
                "counted, eval passes re-run at a grown factor "
                "(exchange.eval.pre_retry); sustained retry growth means "
                "the adaptive doubling is chasing a skewed key "
                "distribution every pass")

    def evaluate(self, ctx):
        retries = ctx.pass_deltas("exchange.overflow_retries")
        dropped = ctx.pass_deltas("exchange.overflow_dropped")
        if not retries and not dropped \
                and ctx.counter("exchange.overflow_retries") == 0 \
                and ctx.counter("exchange.overflow_dropped") == 0:
            # no exchange traffic at all -> the rule has nothing to read
            if not ctx.pass_deltas("exchange.tokens") \
                    and ctx.counter("exchange.tokens") == 0:
                return "no-data", None
            return "quiet", None
        total_r = sum(v for _, v in retries) \
            or ctx.counter("exchange.overflow_retries")
        total_d = sum(v for _, v in dropped) \
            or ctx.counter("exchange.overflow_dropped")
        growing = (len(retries) >= 2 and retries[-1][1] >= retries[0][1]
                   and retries[-1][1] > 0)
        if total_d <= 0 and not growing and total_r <= 0:
            return "quiet", None
        sev = "critical" if total_d > 0 else "warn"
        return "fired", Finding(
            self.id, sev,
            (f"exchange overflow: {int(total_r)} retries"
             + (f", {int(total_d)} dropped tokens" if total_d else "")
             + (" — retries are not decaying across passes"
                if growing else "")),
            {"retries_per_pass": retries, "dropped_per_pass": dropped,
             "total_retries": int(total_r), "total_dropped": int(total_d)},
            "raise flags.exchange_capacity_factor so lanes start sized "
            "for the observed skew (routed_capacity_preplan covers train "
            "passes; eval retries re-run whole passes), and check the "
            "per-pass dedup ratio — a duplication shift changes the "
            "per-destination histogram the preplan sized for; on a "
            "multi-host (node, dp) mesh set flags.exchange_topology="
            "'hier' — the host-merged inter-host leg carries each "
            "host's unique lanes once, shrinking the duplicated "
            "per-destination histogram the capacity was sized for")


class SpillThrashRule(Rule):
    id = "spill-thrash"
    doc = "RAM hot-tier hit rate collapsed / admission-eviction thrash"
    incident = ("the direct-mapped 'last wins' install thrashed "
                "hot rows out of RAM on cold scans — the show-count-"
                "weighted policy replaced it; a collapsed hit rate or "
                "admitted~evicted churn is that failure shape returning")
    COLLAPSE = 0.6      # latest rate below this fraction of the best
    ABS_LOW = 0.5       # ...or absolutely below this with churn

    def evaluate(self, ctx):
        hits = dict(ctx.pass_deltas("spill.cache_hits"))
        misses = dict(ctx.pass_deltas("spill.cache_misses"))
        rates = []
        for p in sorted(set(hits) | set(misses)):
            seen = hits.get(p, 0.0) + misses.get(p, 0.0)
            if seen:
                rates.append((p, hits.get(p, 0.0) / seen))
        if not rates:
            return "no-data", None
        adm = dict(ctx.pass_deltas("tiering.admitted"))
        evc = dict(ctx.pass_deltas("tiering.evicted"))
        cnf = dict(ctx.pass_deltas("tiering.conflict_misses"))
        rep = dict(ctx.pass_deltas("tiering.replica_hits"))
        last_p, last_rate = rates[-1]
        best = max(r for _, r in rates)
        churn = (adm.get(last_p, 0.0) > 0
                 and evc.get(last_p, 0.0) >= 0.9 * adm.get(last_p, 0.0))
        collapsed = len(rates) >= 2 and last_rate < self.COLLAPSE * best
        thrash = last_rate < self.ABS_LOW and churn
        if not collapsed and not thrash:
            return "quiet", None
        # which knob: a miss stream dominated by conflict misses is a
        # GEOMETRY problem (the whole set was live — more rows won't
        # help, more ways will); a hot stream with no replica traffic is
        # leaving the HBM tier on the table
        last_miss = misses.get(last_p, 0.0)
        conflict_bound = (last_miss > 0
                          and cnf.get(last_p, 0.0) >= 0.5 * last_miss)
        replica_idle = (hits.get(last_p, 0.0) > last_miss
                        and rep.get(last_p, 0.0) <= 0)
        suggest = ("raise flags.spill_cache_rows toward the pass working "
                   "set's hot fraction (rows x row_width x 4B per shard "
                   "is the RAM bill)")
        if conflict_bound:
            suggest = ("conflict misses dominate the miss stream — the "
                       "geometry, not the budget, is capping the hit "
                       "rate: raise flags.spill_cache_assoc (more ways "
                       "per set) before spending RAM on "
                       "flags.spill_cache_rows")
        if replica_idle:
            suggest += ("; hit traffic dominates with zero replica hits "
                        "— flags.use_replica_cache would serve the "
                        "hottest rows from the HBM replica tier and "
                        "skip the RAM probe entirely")
        return "fired", Finding(
            self.id, "warn",
            (f"pass {last_p}: spill hot-tier hit rate "
             f"{last_rate:.0%}" +
             (f" (was {best:.0%})" if collapsed else "") +
             (" with admission/eviction churn" if churn else "")),
            {"hit_rate_per_pass": [(p, round(r, 4)) for p, r in rates],
             "admitted_last_pass": adm.get(last_p),
             "evicted_last_pass": evc.get(last_p),
             "conflict_misses_last_pass": cnf.get(last_p),
             "replica_hits_last_pass": rep.get(last_p)},
            suggest)


class DedupDriftRule(Rule):
    id = "dedup-drift"
    doc = "per-pass dedup ratio drifted — duplication profile shifted"
    incident = ("push engine selection and exchange lane "
                "sizing were tuned against a measured duplication "
                "profile (multihot4 ~2.6x); a drifted ratio silently "
                "invalidates push_dedup_premerge A/Bs and capacity "
                "preplans")
    REL = 0.25

    def _ratios(self, ctx, num, den):
        n, d = dict(ctx.pass_deltas(num)), dict(ctx.pass_deltas(den))
        return [(p, n.get(p, 0.0) / d[p]) for p in sorted(d) if d.get(p)]

    def evaluate(self, ctx):
        ratios = self._ratios(ctx, "exchange.unique_lanes",
                              "exchange.tokens")
        if not ratios:
            ratios = self._ratios(ctx, "trainer.plan_unique_tokens",
                                  "trainer.plan_tokens")
        if len(ratios) < 2:
            return "no-data", None
        first, last = ratios[0][1], ratios[-1][1]
        drift = abs(last - first) / max(first, 1e-9)
        if drift <= self.REL:
            return "quiet", None
        return "fired", Finding(
            self.id, "warn",
            f"dedup ratio drifted {drift:.0%} across passes "
            f"({first:.3f} -> {last:.3f})",
            {"dedup_ratio_per_pass": [(p, round(r, 4))
                                      for p, r in ratios]},
            "the duplication profile the engines were tuned on has "
            "moved: re-check upstream merge (dataset merge_by_ins_id / "
            "feed dedup) and re-A/B flags.push_dedup_premerge and the "
            "exchange capacity preplan against the new ratio — or turn "
            "on flags.exchange_adaptive, whose per-pass wire controller "
            "re-costs the exchange wire from exactly this drifting "
            "tokens/unique ratio instead of pinning one wire to a "
            "stale profile")


class PushFloorRule(Rule):
    id = "push-floor"
    doc = "sparse push measured off its analytic floor"
    incident = ("an 11ms push can pass an MFU audit while sitting 10x "
                "above its own physics — step_probe.push_floor_analysis "
                "closes each measured push against the floor of the "
                "port's CUDA kernels, and a non-closed floor is the "
                "alarm line")

    def evaluate(self, ctx):
        floor = ctx.detail.get("push_floor")
        if not isinstance(floor, dict) or "closed" not in floor:
            return "no-data", None
        closed = floor["closed"]
        if closed is True:
            return "quiet", None
        if isinstance(closed, str) and not closed.startswith("measured"):
            return "no-data", None      # abstained (no peaks/measurement)
        # name the concrete engine to force: the per-candidate-engine
        # closure statements (push_floor_analysis `engines`) carry each
        # engine's bound at this geometry, and the per-point record
        # (detail push_engine — the resolver's verdict) names what ran
        engine = ctx.detail.get("push_engine") or floor.get("engine")
        engines = floor.get("engines") if isinstance(
            floor.get("engines"), dict) else {}
        best = floor.get("best_engine")
        if best and best != engine:
            note = (engines.get(best) or {}).get("note")
            suggestion = (
                f"force flags.push_engine={best!r} (candidate floor "
                f"{(engines.get(best) or {}).get('floor_seconds')}s vs "
                f"the recorded {engine} run"
                + (f"; {note}" if note else "") + ") and re-record the "
                "point; flags.binned_push (the binned engine's enable "
                "knob) and flags.push_dedup_premerge (premerged lanes) "
                "are the companion A/B knobs")
        else:
            suggestion = (
                f"the resolver already picked the lowest-floor engine "
                f"({engine}) — A/B flags.push_dedup_premerge and the "
                "host plan staging at this geometry before trusting the "
                "step; the floor statement names which sub-stage (kernel "
                "bytes / table update) carries the gap")
        return "fired", Finding(
            self.id, "warn",
            f"push engine {engine} is off its recorded floor: {closed}",
            {"engine": engine,
             "floor_seconds": floor.get("floor_seconds"),
             "measured_push_seconds": floor.get("measured_push_seconds"),
             "engine_floors": {n: e.get("floor_seconds")
                               for n, e in engines.items()}},
            suggestion)


class NanGuardRule(Rule):
    id = "nan-guard"
    doc = "the nan/inf guard tripped"
    incident = ("nan-guard wiring: flags.check_nan_inf aborts the "
                "pass on non-finite leaves and dumps the step scope — a "
                "trip is never noise; a 'pass-2 loss worse' "
                "investigation began as exactly this signature")

    def evaluate(self, ctx):
        trips = sum(v for _, v in ctx.pass_deltas("trainer.nan_trips")) \
            or ctx.counter("trainer.nan_trips")
        events = ctx.evidence.get("nan_guard") or []
        if trips <= 0 and not events:
            return "quiet", None
        ev: dict = {"trips": int(trips) or len(events)}
        if events:
            f0 = events[0].get("fields") or {}
            ev["first_trip"] = {"pass_id": events[0].get("pass_id"),
                                "step": events[0].get("step"),
                                "paths": f0.get("paths"),
                                "n_bad": f0.get("n_bad")}
        return "fired", Finding(
            self.id, "critical",
            f"nan/inf guard tripped {ev['trips']} time(s)", ev,
            "inspect the nan_step scope dump next to the error "
            "(TrainerConfig.nan_dump_dir) — the dumped paths name the "
            "first non-finite plane; keep flags.check_nan_inf on until "
            "the source batch/plane is identified")


class ServingStalenessRule(Rule):
    id = "serving-staleness"
    doc = "serving is falling behind training (stale model / failed "\
          "publishes)"
    incident = ("a publish failure degrades instead of killing "
                "the pass loop — serving stays on its last good version "
                "and the STALENESS gauges are the alarm; silent-stale "
                "serving is the failure the donefile protocol exists to "
                "prevent")
    PASS_LAG = 2
    STALE_S = 600.0

    def evaluate(self, ctx):
        # per-pass deltas first, cumulative counter as the FALLBACK —
        # never both (the CLI's counters ARE the summed deltas, so
        # counter + deltas would double-count every failure)
        def total(key):
            return sum(v for _, v in ctx.pass_deltas(key)) \
                or ctx.counter(key)

        def peak(key):
            # GAUGE reconstruction: stats_delta carries change-per-pass
            # (last minus first), so a staleness that grows a little
            # every pass shows tiny deltas — the absolute value is the
            # running SUM of the deltas (gauges start at 0 in a fresh
            # process); take its max across passes, falling back to the
            # live snapshot when no deltas were recorded
            deltas = ctx.pass_deltas(key)
            if not deltas:
                return ctx.counter(key)
            run = mx = 0.0
            for _, v in deltas:
                run += v
                mx = max(mx, run)
            return mx

        failures = total("serving.publish_failures") \
            or len(ctx.evidence.get("serving_publish_failed") or [])
        lag = peak("serving.pass_lag")
        stale = peak("serving.staleness_seconds")
        publishes = total("serving.publishes")
        if failures == 0 and lag == 0 and stale == 0 and publishes == 0 \
                and not ctx.evidence.get("serving_publish_failed"):
            return "no-data", None
        if failures <= 0 and lag < self.PASS_LAG and stale < self.STALE_S:
            return "quiet", None
        sev = "critical" if failures > 0 else "warn"
        return "fired", Finding(
            self.id, sev,
            (f"serving staleness: {int(failures)} failed publish(es), "
             f"pass lag {lag:g}, staleness {stale:g}s"),
            {"publish_failures": int(failures), "pass_lag": lag,
             "staleness_seconds": stale,
             "failed_events": [
                 (e.get("fields") or {}).get("error")
                 for e in (ctx.evidence.get("serving_publish_failed")
                           or [])][:4]},
            "serving keeps its last good version by design — check the "
            "publisher's error (serving.publish_failures counter / "
            "serving_publish_failed events), the donefile root, and the "
            "server's serving.poll_failures; shed-on-stale belongs at "
            "the frontend if staleness persists")


class HeartbeatGapRule(Rule):
    id = "heartbeat-gap"
    doc = "a peer's heartbeat stopped or its progress stalled"
    incident = ("the watchdog names lost/stalled peers by "
                "ORIGINAL launcher rank; a heartbeat gap precedes every "
                "elastic shrink — seeing it in telemetry before the "
                "barrier timeout is the operator's head start")

    def evaluate(self, ctx):
        lost = int(ctx.counter("resilience.peer_lost")
                   or sum(v for _, v in
                          ctx.pass_deltas("resilience.peer_lost")))
        stalled = int(ctx.counter("resilience.peer_stalled")
                      or sum(v for _, v in
                             ctx.pass_deltas("resilience.peer_stalled")))
        events = (ctx.evidence.get("peer_lost") or []) \
            + (ctx.evidence.get("peer_stalled") or [])
        if lost + stalled <= 0 and not events:
            # quiet only when the resilience plane provably exists in
            # this telemetry (any resilience.* series, or an election
            # event) — a single-host run without heartbeats is no-data,
            # never "heartbeats checked, all healthy"
            plane = (any(k.startswith("resilience.")
                         for k in ctx.counters)
                     or ctx.evidence.get("resume_election"))
            return ("quiet" if plane else "no-data"), None
        ranks = sorted({(e.get("fields") or {}).get("rank")
                        for e in events
                        if (e.get("fields") or {}).get("rank")
                        is not None})
        # grow-side evidence: the RemediationController keys
        # its grow trigger off these — world_size/degraded are gauges set
        # identically on every surviving rank at world formation, so a
        # controller gating on them decides rank-consistently, and
        # world_grows/admit_requests show whether healing already ran
        world_size = int(ctx.counter("resilience.world_size"))
        degraded = bool(ctx.counter("resilience.degraded"))
        return "fired", Finding(
            self.id, "critical",
            (f"heartbeat gaps: {lost} lost, {stalled} stalled"
             + (f" (ranks {ranks})" if ranks else "")),
            {"peer_lost": lost, "peer_stalled": stalled,
             "ranks": ranks,
             "world_size": world_size,
             "degraded": degraded,
             "world_reforms": int(ctx.counter("resilience.world_reforms")),
             "world_grows": int(ctx.counter("resilience.world_grows")),
             "admit_requests": int(
                 ctx.counter("resilience.admit_requests")),
             "events": [{"name": e.get("name"),
                         "rank": (e.get("fields") or {}).get("rank"),
                         "after_s": (e.get("fields") or {}).get("after_s")}
                        for e in events[:8]]},
            "inspect the named rank's host (OOM/preemption for lost, "
            "hung collective or dead remote FS for stalled); "
            "flags.elastic_min_world governs whether the world shrinks "
            "past it or checkpoints and exits, and a degraded world "
            "GROWS back: launch a replacement via ElasticWorld.admit() "
            "— with flags.self_healing the RemediationController admits "
            "it at the next pass boundary (world_grow event) and the "
            "newcomer rebuilds exactly its owned shards")


class SinkHealthRule(Rule):
    id = "sink-health"
    doc = "a telemetry sink dropped events, latched an error, or was "\
          "detached"
    incident = ("a silently-detached JSONL sink "
                "used to manifest as a mysteriously short stream — the "
                "hub's 3-strike detach and the queue-full drop counter "
                "must be VISIBLE, because every other rule reads the "
                "stream this one audits")

    def evaluate(self, ctx):
        bad = [s for s in ctx.sink_health
               if s.get("dropped") or s.get("error")
               or s.get("state") == "detached"]
        meta_drops = sum((e.get("fields") or {}).get("dropped", 0)
                         for e in (ctx.evidence.get("sink_dropped") or []))
        if not ctx.sink_health and not ctx.evidence.get("sink_dropped"):
            return "no-data", None
        # fire only on SESSION-scoped evidence (unhealthy sink entries,
        # in-stream drop records) — the process-cumulative
        # monitor.sink_errors counter survives hub sessions and a single
        # recovered blip would latch the rule fired forever; it rides
        # along as evidence only
        if not bad and meta_drops == 0:
            return "quiet", None
        return "fired", Finding(
            self.id, "warn",
            (f"telemetry sink trouble: {len(bad)} unhealthy sink(s), "
             f"{int(meta_drops)} dropped events recorded in-stream"),
            {"sinks": bad[:4], "stream_dropped": int(meta_drops),
             "sinks_detached": int(ctx.counter("monitor.sinks_detached")),
             "sink_errors": int(ctx.counter("monitor.sink_errors"))},
            "the streams every other diagnosis reads are incomplete: "
            "raise flags.telemetry_queue_size (queue-full drops), turn "
            "on flags.telemetry_rotate_mb (unbounded single file on "
            "day-scale runs), and check the latched sink error "
            "(full disk / dead path)")


class CrossRankFlowRule(Rule):
    id = "cross-rank-flow"
    doc = "a cross-rank flow edge (exchange / publish->swap) dominates "\
          "the pass wall"
    incident = ("stage totals hid WHERE a slow pass crossed "
                "ranks — the world trace's flow edges (exchange "
                "all_to_all, end_pass publish -> serving swap) carry "
                "clock-corrected latencies, and the longest edge is the "
                "cross-rank statement no per-rank attribution could "
                "make")
    SHARE = 0.25       # longest edge vs mean pass wall
    ABS_S = 5.0        # fallback when no pass walls are in view

    _KIND_FIX = {
        "exchange": (
            "the exchange edge is the wall: check the dst rank's shard "
            "balance (aggregate stage_skew / exchange imbalance), raise "
            "flags.exchange_capacity_factor if overflow retries ride "
            "along, and instead of hand-A/Bing a fixed "
            "flags.exchange_wire turn on flags.exchange_adaptive — the "
            "per-pass controller selects the wire from these counters "
            "and THIS flow attribution (feed it via "
            "Trainer.note_flow_attribution); on a multi-host mesh set "
            "flags.exchange_topology='hier' so the inter-host leg "
            "carries each host's merged unique lanes once — the edge "
            "fields carry the wire format and bytes that crossed"),
        "publish": (
            "the publish->swap edge is the staleness: check the "
            "publisher's upload/verify seconds (serving.publish_seconds "
            "counter), the server's poll cadence (ServingServer "
            "poll_s), and the donefile root's fs latency"),
    }

    def evaluate(self, ctx):
        wt = ctx.detail.get("world_trace")
        if not isinstance(wt, dict):
            return "no-data", None
        edges = wt.get("flow_edges") or []
        if not edges:
            return "no-data", None
        walls = [p["wall_seconds"]
                 for p in ctx.attribution.get("passes", [])
                 if p.get("wall_seconds")]
        wall_mean = (sum(walls) / len(walls)) if walls else None
        fa = cp_lib.attribute_flow_edges(edges, wall_mean)
        longest = fa["longest"]
        share = fa.get("longest_share_of_wall")
        hot = (share is not None and share >= self.SHARE) or (
            share is None and longest["latency_s"] >= self.ABS_S)
        if not hot:
            return "quiet", None
        ev = {
            "longest_edge": longest,
            "longest_share_of_wall": share,
            "by_kind": fa["by_kind"],
            "edges": fa["edges"],
            "negative_edges": fa["negative_edges"],
            "clock_offsets_s": wt.get("clock_offsets_s"),
        }
        fix = [self._KIND_FIX.get(
            str(longest["kind"]),
            "inspect the edge's src/dst rank timelines in the merged "
            "Perfetto trace (python -m paddlebox_tpu_torch.monitor.trace)")]
        if fa["negative_edges"]:
            fix.append(f"{fa['negative_edges']} edge(s) measured "
                       "negative — residual clock error; check the "
                       "heartbeat plane's trace.clock_probe coverage "
                       "before trusting sub-rtt latencies")
        return "fired", Finding(
            self.id, "warn",
            (f"cross-rank flow edge {longest['kind']}:{longest['key']} "
             f"rank{longest['src_rank']} -> rank{longest['dst_rank']} "
             f"takes {longest['latency_s']:.3f}s"
             + (f" ({share:.0%} of the mean pass wall)"
                if share is not None else "")),
            ev, "; ".join(fix))


def _roles(window: dict) -> "dict[str, tuple[str, dict]]":
    """{role: (version_id, entry)} off one serving window's ``versions``
    object — last entry per role wins (there is at most one stable and
    one candidate per window by construction)."""
    out: dict[str, tuple[str, dict]] = {}
    for vid, v in (window.get("versions") or {}).items():
        if isinstance(v, dict) and v.get("role") in ("stable",
                                                     "candidate"):
            out[v["role"]] = (str(vid), v)
    return out


class VersionRegressionRule(Rule):
    id = "version-regression"
    doc = "candidate version scores below stable (AUC gap / score-KL "\
          "drift)"
    incident = ("the paper's AUC-runner A/B, serving half — a "
                "candidate version served blind (no per-version "
                "attribution) regressed CTR for a full window before "
                "the offline AUC caught it; the serving window record "
                "carries per-version AUC and candidate-vs-stable "
                "score-KL exactly so this fires DURING the split")
    AUC_MARGIN = 0.005
    KL_MAX = 0.5

    def evaluate(self, ctx):
        target = None
        for w in reversed(ctx.servings):
            if {"stable", "candidate"} <= set(_roles(w)):
                target = w
                break
        if target is None:
            return "no-data", None
        roles = _roles(target)
        vid_s, stable = roles["stable"]
        vid_c, cand = roles["candidate"]
        auc_s, auc_c = stable.get("auc"), cand.get("auc")
        kl = cand.get("score_kl")
        auc_gap = (float(auc_s) - float(auc_c)
                   if auc_s is not None and auc_c is not None else None)
        fired_auc = auc_gap is not None and auc_gap > self.AUC_MARGIN
        fired_kl = isinstance(kl, (int, float)) and kl > self.KL_MAX
        if not fired_auc and not fired_kl:
            if auc_gap is None and kl is None:
                return "no-data", None      # both versions, no signal yet
            return "quiet", None
        sev = "critical" if fired_auc else "warn"
        return "fired", Finding(
            self.id, sev,
            (f"candidate v{vid_c} regresses vs stable v{vid_s}: "
             + (f"AUC {auc_c:.4f} vs {auc_s:.4f}"
                if fired_auc else f"score-KL {kl:.3f}")),
            {"stable_version": vid_s, "candidate_version": vid_c,
             "stable_auc": auc_s, "candidate_auc": auc_c,
             "auc_gap": auc_gap, "score_kl": kl,
             "stable_score_mean": stable.get("score_mean"),
             "candidate_score_mean": cand.get("score_mean"),
             "candidate_requests": cand.get("requests")},
            "do not promote: keep flags.serving_shadow on (or "
            "flags.serving_split_fraction small) and hold stable; check "
            "the candidate's training pass for the regression source "
            "(nan-guard, dedup-drift, a bad dataset day) — the publish "
            "flow edge in the merged trace names the producing pass")


class P99BurnRule(Rule):
    id = "p99-burn"
    doc = "serving p99 is burning through its latency SLO across "\
          "windows"
    incident = ("the frontend's since-start latency reservoir "
                "hid a post-swap p99 step inside a lifetime blend — the "
                "windowed records exist so sustained SLO burn is "
                "visible window by window, not after the day's average "
                "moves")
    RECENT = 6          # windows considered
    BURN = 0.5          # fraction of recent windows breaching

    def evaluate(self, ctx):
        wins = [w for w in ctx.servings if w.get("requests")]
        if not wins:
            return "no-data", None
        recent = wins[-self.RECENT:]
        latest = recent[-1]
        slo = latest.get("slo_ms")
        if not isinstance(slo, (int, float)) or slo <= 0:
            return "no-data", None
        breaches = [w for w in recent
                    if isinstance(w.get("p99_ms"), (int, float))
                    and float(w["p99_ms"]) > float(slo)]
        rate = len(breaches) / len(recent)
        if latest not in breaches or rate < self.BURN:
            return "quiet", None
        return "fired", Finding(
            self.id, "warn",
            (f"serving p99 {latest.get('p99_ms'):.1f}ms over the "
             f"{slo:g}ms SLO in {len(breaches)}/{len(recent)} recent "
             f"window(s)"),
            {"slo_ms": slo, "burn_rate": round(rate, 3),
             "p99_per_window": [(round(w['ts'], 1), w.get("p99_ms"))
                                for w in recent],
             "latest_requests": latest.get("requests"),
             "latest_p50_ms": latest.get("p50_ms")},
            "check what changed at the first breaching window: a swap "
            "(swap-regression names the step), shadow scoring overhead "
            "(flags.serving_shadow doubles predictor work per request), "
            "or batch-coalesce pressure (frontend max_wait_s / "
            "max_batch); raise flags.serving_slo_ms only if the SLO "
            "itself was wrong")


class SwapRegressionRule(Rule):
    id = "swap-regression"
    doc = "post-swap serving p99 stepped up vs the pre-swap window"
    incident = ("the swap discipline: the swap is one "
                "atomic rebind, but the VERSION behind it can be slow — "
                "a bigger table, a cold predictor cache, a dense config "
                "that recompiles; comparing the swap window's p99 "
                "against the window before it is the regression "
                "statement the cumulative reservoir could never make")
    STEP = 1.5          # post/pre p99 ratio
    FLOOR_MS = 1.0      # absolute step floor (timer noise guard)

    def evaluate(self, ctx):
        wins = ctx.servings
        if not wins:
            return "no-data", None
        for i in range(len(wins) - 1, 0, -1):
            w = wins[i]
            if not w.get("swaps"):
                continue
            pre = wins[i - 1]
            post_p99, pre_p99 = w.get("p99_ms"), pre.get("p99_ms")
            if not (isinstance(post_p99, (int, float))
                    and isinstance(pre_p99, (int, float))
                    and w.get("requests") and pre.get("requests")):
                continue            # no traffic on one side: no verdict
            if post_p99 > self.STEP * pre_p99 \
                    and post_p99 > pre_p99 + self.FLOOR_MS:
                return "fired", Finding(
                    self.id, "warn",
                    (f"p99 stepped {pre_p99:.1f}ms -> {post_p99:.1f}ms "
                     f"across the swap to "
                     f"v{w.get('active_version')}"),
                    {"pre_p99_ms": pre_p99, "post_p99_ms": post_p99,
                     "step_ratio": round(post_p99 / max(pre_p99, 1e-9),
                                         2),
                     "swap_window_ts": w.get("ts"),
                     "active_version": w.get("active_version"),
                     "swaps_in_window": w.get("swaps"),
                     "version_lag": w.get("version_lag")},
                    "compare the swapped version against its parent: "
                    "table_keys (a grown table lengthens the probe), "
                    "model config (a changed architecture recompiles "
                    "the forward on first request — with_model reuse "
                    "only holds same-config swaps), replica hot-tier "
                    "coverage (replica_hot_keys in the window record); "
                    "roll back by republishing the parent if the step "
                    "holds")
            return "quiet", None    # latest assessable swap looks clean
        return "quiet", None        # windows exist, no assessable swap


class FleetDegradedRule(Rule):
    id = "fleet-degraded"
    doc = "the serving fleet is running degraded (dead or quarantined "\
          "replicas, shed traffic, promotion held)"
    incident = ("one replica crash-looping on a torn version "
                "took a whole host out of rotation because nothing "
                "distinguished 'one replica down, router covering' from "
                "'fleet down' — the fleet window record carries healthy/"
                "quarantined counts and the router's shed/retry/hedge "
                "accounting so the doctor states WHICH it is")
    SHED_RATE = 0.01    # shed fraction of offered traffic that fires

    def evaluate(self, ctx):
        wins = ctx.fleets
        if not wins:
            return "no-data", None
        latest = wins[-1]
        replicas = latest.get("replicas")
        healthy = latest.get("healthy")
        if not isinstance(replicas, int) or not isinstance(healthy, int):
            return "no-data", None
        quarantined = int(latest.get("quarantined") or 0)
        sheds = int(latest.get("sheds") or 0)
        requests = int(latest.get("requests") or 0)
        offered = requests + sheds
        shed_rate = sheds / offered if offered else 0.0
        holds = int(latest.get("promote_holds") or 0)
        down = healthy < replicas
        if not down and not quarantined and shed_rate <= self.SHED_RATE \
                and not holds:
            return "quiet", None
        sev = "critical" if healthy == 0 else "warn"
        what = []
        if down:
            what.append(f"{replicas - healthy}/{replicas} replica(s) "
                        f"out of rotation")
        if quarantined:
            what.append(f"{quarantined} quarantined")
        if shed_rate > self.SHED_RATE:
            what.append(f"shedding {shed_rate:.1%} of traffic")
        if holds:
            what.append(f"{holds} promotion hold(s)")
        return "fired", Finding(
            self.id, sev,
            "serving fleet degraded: " + ", ".join(what),
            {"replicas": replicas, "healthy": healthy,
             "quarantined": quarantined, "sheds": sheds,
             "requests": requests, "shed_rate": round(shed_rate, 4),
             "restarts": latest.get("restarts"),
             "retries": latest.get("retries"),
             "hedges_won": latest.get("hedges_won"),
             "promote_holds": holds, "window_ts": latest.get("ts")},
            "triage the quarantined replica's last_error (fleet CLI "
            "status names it) — a crash-loop on ONE version means a bad "
            "artifact: quarantine the version and republish; healthy < "
            "replicas with restarts climbing means the backoff is "
            "cycling (check replica stderr); promotion holds mean the "
            "version-regression verdict fired — inspect that finding "
            "before touching flags.serving_auto_promote")


ALL_RULES: "tuple[type[Rule], ...]" = (
    BoundaryWallRule,
    ExchangeOverflowRule,
    SpillThrashRule,
    DedupDriftRule,
    PushFloorRule,
    NanGuardRule,
    ServingStalenessRule,
    HeartbeatGapRule,
    SinkHealthRule,
    CrossRankFlowRule,
    VersionRegressionRule,
    P99BurnRule,
    SwapRegressionRule,
    FleetDegradedRule,
)

_SEV_ORDER = {"critical": 0, "warn": 1, "info": 2}


# ---------------------------------------------------------------------------
# diagnosis + report schema
# ---------------------------------------------------------------------------

def diagnose(flights=None, counters=None, evidence=None, world=None,
             detail=None, sink_health=None, servings=None, fleets=None,
             inputs=None, quarantined_rules=None) -> dict:
    """Evaluate every rule over the given telemetry; returns the report
    (validate with :func:`validate_report`).

    ``quarantined_rules``: rule ids the remediation
    parity guard quarantined this run — a quarantined rule's applied
    action changed model bits, which is evidence its suggestion is wrong
    for this workload. Its findings still appear (the symptom is real)
    but downgraded to ``info`` with the suggestion suppressed, and the
    report surfaces ``quarantined_rules`` so the operator sees WHY."""
    ctx = DoctorContext(flights=flights, counters=counters,
                        evidence=evidence, world=world, detail=detail,
                        sink_health=sink_health, servings=servings,
                        fleets=fleets)
    rules = []
    findings = []
    for rule_cls in ALL_RULES:
        rule = rule_cls()
        try:
            status, finding = rule.evaluate(ctx)
        except Exception as e:   # a broken rule must not mask the others
            status, finding = "no-data", None
            rules.append({"rule": rule.id, "status": status,
                          "error": repr(e)[:200]})
            continue
        rules.append({"rule": rule.id, "status": status})
        if finding is not None:
            findings.append(finding)
    quarantined = sorted({str(r) for r in (quarantined_rules or ())})
    for f in findings:
        if f["rule"] in quarantined:
            # remediation-history feedback: the parity guard reverted
            # this rule's action — keep the symptom visible, drop the
            # (discredited) advice out of the actionable severities
            f["severity"] = "info"
            f["suggestion"] = ("suggestion suppressed: this rule's "
                               "applied remediation was reverted by the "
                               "parity guard this run — its advice is "
                               "wrong for this workload (original: "
                               + f["suggestion"] + ")")
    findings.sort(key=lambda f: _SEV_ORDER.get(f["severity"], 9))
    report = {
        "type": "doctor_report",
        "version": REPORT_VERSION,
        "inputs": list(inputs or []),
        "passes": [fr.get("pass_id") for fr in ctx.flights],
        "critical_path": ctx.attribution,
        "rules": rules,
        "findings": findings,
        "verdict": ("healthy" if not findings
                    else f"findings:{len(findings)}"),
    }
    if quarantined:
        report["quarantined_rules"] = quarantined
    if world is not None:
        report["world"] = {
            "world_size": world.get("world_size"),
            "ranks": [r.get("rank") for r in world.get("ranks", [])],
            "passes": world.get("passes"),
            "stream_errors": sum(r.get("error_count", 0)
                                 for r in world.get("ranks", []))}
    return report


def validate_report(report: dict) -> "list[str]":
    """Schema errors for a doctor report (empty = valid) — the report is
    a machine contract like the flight record."""
    errs: list[str] = []
    if not isinstance(report, dict):
        return ["report is not an object"]
    if report.get("type") != "doctor_report":
        errs.append(f"type is {report.get('type')!r}")
    if report.get("version") != REPORT_VERSION:
        errs.append(f"version is {report.get('version')!r}")
    if not isinstance(report.get("verdict"), str):
        errs.append("verdict missing")
    cp = report.get("critical_path")
    if not isinstance(cp, dict) or "passes" not in cp:
        errs.append("critical_path.passes missing")
    else:
        for p in cp["passes"]:
            for k in ("pass_id", "stages", "limiter", "wall_seconds"):
                if k not in p:
                    errs.append(f"critical_path pass missing {k!r}")
    rules = report.get("rules")
    if not isinstance(rules, list) or not rules:
        errs.append("rules missing")
    else:
        seen = {r.get("rule") for r in rules}
        for rule_cls in ALL_RULES:
            if rule_cls.id not in seen:
                errs.append(f"rule {rule_cls.id!r} was not evaluated")
        for r in rules:
            if r.get("status") not in RULE_STATUSES:
                errs.append(f"rule {r.get('rule')!r} has status "
                            f"{r.get('status')!r}")
    for f in report.get("findings", []):
        for k in ("rule", "severity", "summary", "evidence", "suggestion"):
            if k not in f:
                errs.append(f"finding missing {k!r}")
    q = report.get("quarantined_rules")
    if q is not None and (not isinstance(q, list)
                          or not all(isinstance(r, str) for r in q)):
        errs.append("quarantined_rules is not a list of rule ids")
    return errs


# ---------------------------------------------------------------------------
# live mode (flags.doctor_live — called by TelemetryHub.end_pass)
# ---------------------------------------------------------------------------

def diagnose_hub(hub, detail=None, quarantined_rules=None) -> dict:
    """Diagnose a live hub's in-memory state (flight-record ring, the
    cumulative counter registry, this session's sink health) — the ONE
    assembly run_live and the remediation controller share."""
    return diagnose(flights=hub.flight_records(),
                    counters=STATS.snapshot(),
                    sink_health=hub.sink_health(),
                    detail=detail,
                    quarantined_rules=quarantined_rules)


def run_live(hub) -> "list[dict]":
    """Evaluate the rules against the hub's in-memory state; emit one
    ``doctor.finding`` event per finding (pass-tagged — end_pass calls
    this before the scope closes) and return the findings."""
    findings = diagnose_hub(hub)["findings"]
    for f in findings:
        hub.event("doctor.finding", type="doctor", rule=f["rule"],
                  severity=f["severity"], summary=f["summary"],
                  suggestion=f["suggestion"])
    if findings:
        STATS.add("doctor.findings", len(findings))
    return findings


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def render_text(report: dict) -> str:
    lines = [f"run doctor — verdict: {report['verdict']}"]
    world = report.get("world")
    if world:
        lines.append(f"world: {world.get('world_size')} rank(s) "
                     f"{world.get('ranks')}, "
                     f"{world.get('stream_errors', 0)} stream error(s)")
    for p in report["critical_path"].get("passes", []):
        stages = " ".join(f"{k}={v:.3f}s"
                          for k, v in sorted(p["stages"].items()))
        lines.append(
            f"pass {p['pass_id']}: wall={p['wall_seconds']:.3f}s "
            f"limiter={p['limiter']} ({p['limiter_share']:.0%}) {stages}")
    summary = report["critical_path"].get("summary") or {}
    if summary:
        lines.append(
            f"limiter: {summary.get('limiter')} "
            f"(boundary share trend: "
            f"{summary.get('boundary_share_trend')}, overlap headroom "
            f"{summary.get('overlap_headroom_seconds', 0):.1f}s)")
    lines.append("rules: " + " ".join(
        f"{r['rule']}={r['status']}" for r in report["rules"]))
    if report.get("quarantined_rules"):
        lines.append("quarantined (parity guard — suggestions "
                     "suppressed): "
                     + " ".join(report["quarantined_rules"]))
    for f in report["findings"]:
        lines.append(f"[{f['severity'].upper()}] {f['rule']}: "
                     f"{f['summary']}")
        ev = json.dumps(f["evidence"], default=str)[:400]
        lines.append(f"  evidence: {ev}")
        lines.append(f"  suggestion: {f['suggestion']}")
    if not report["findings"]:
        lines.append("no findings — every fired rule stayed quiet")
    return "\n".join(lines)


def main(argv: "list[str] | None" = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in argv
    argv = [a for a in argv if a != "--json"]
    # CI gating: --fail-on SEVERITY exits 1 when
    # any finding at or above that severity fired — pair with --json so
    # a pipeline both consumes the findings and gates on them
    fail_on = None
    if "--fail-on" in argv:
        i = argv.index("--fail-on")
        try:
            fail_on = argv[i + 1]
        except IndexError:
            fail_on = ""
        if fail_on not in _SEV_ORDER:
            print(f"--fail-on wants one of {sorted(_SEV_ORDER)}, got "
                  f"{fail_on!r}", file=sys.stderr)
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
        print("usage: python -m paddlebox_tpu_torch.monitor.doctor "
              "<telemetry_dir>... [--json] [--rank-names 4,5,7] "
              "[--fail-on critical|warn|info]",
              file=sys.stderr)
        return 2
    from paddlebox_tpu_torch.monitor import aggregate as agg_lib
    try:
        # one shared pass over every rotated segment feeds BOTH the
        # per-pass world view and the merged world trace — the doctor
        # used to parse the whole stream set twice
        world, merged = agg_lib.aggregate_with_trace(
            roots, rank_names=rank_names)
    except (OSError, ValueError) as e:
        print(f"doctor: cannot read telemetry roots: {e}",
              file=sys.stderr)
        return 2
    if not any(r["events"] for r in world["ranks"]):
        print(f"doctor: no events found under {roots}", file=sys.stderr)
        return 2
    # span-level cross-rank evidence: when the streams carry world-trace
    # records, the merged flow edges feed the cross-rank-flow rule (a
    # stream without them is that rule's no-data, never an error)
    detail = None
    from paddlebox_tpu_torch.monitor import trace as trace_lib
    summary = trace_lib.summarize(merged)
    # flight records alone render as pass slices but carry no trace
    # plane — only real span/flow records mean tracing was on
    if summary.get("span_records") or summary.get("flow_points"):
        detail = {"world_trace": summary}
    report = diagnose(flights=world["flight_records"],
                      counters=world["counters"],
                      evidence=world["evidence"],
                      world=world if len(roots) > 1 else None,
                      detail=detail,
                      servings=world.get("serving_records"),
                      fleets=world.get("fleet_records"),
                      inputs=roots)
    if detail:
        report["world_trace"] = detail["world_trace"]
    errs = validate_report(report)
    if errs:                      # the contract guards itself
        print(f"doctor: internal schema errors: {errs}", file=sys.stderr)
        return 2
    print(json.dumps(report, default=str) if as_json
          else render_text(report), flush=True)
    if fail_on is not None and any(
            _SEV_ORDER.get(f["severity"], 9) <= _SEV_ORDER[fail_on]
            for f in report["findings"]):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
