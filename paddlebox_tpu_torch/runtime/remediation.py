"""Self-healing runtime: doctor findings become applied actions; the
port of ``paddlebox_tpu/runtime/remediation.py``.

Every doctor rule (monitor/doctor.py) ends its finding with a concrete
suggested flag, which an operator would read and flip. At production
scale (days of passes across many hosts, SURVEY.md §5) that loop must
close itself, the way Parallax (arXiv:1808.02621) reconfigures from
observed workload properties. The :class:`RemediationController` is that
closure:

- at every pass boundary (``flags.self_healing``; hooked by
  ``Trainer.remediation_boundary`` from both the trainer-owned
  ``train_pass`` tail and ``BoxPS.end_pass``, BEFORE the flight-record
  commit) it consumes the live doctor findings and applies at most ONE
  machine-applicable :class:`Action` per pass — a rule must fire
  ``flags.self_healing_sustain`` consecutive boundaries first, so one
  noisy pass never reconfigures the run;
- a **parity guard** brackets every action whose rule promises
  bit-identity (resident-row reuse, cache placement): the dense params'
  bytes (+ optional probe rows) are fingerprinted before and after the
  apply, and a changed bit REVERTS the action and quarantines the rule
  for the rest of the run — a healing loop that silently changes the
  model is worse than the symptom it treats;
- the before/after counter deltas ride the flight record
  (``extra["remediation"]``, schema-enforced in monitor/flight.py) and
  every apply/revert emits a registered ``remediation_applied`` /
  ``remediation_reverted`` event — so doctor ``--fail-on`` CI gating
  and the aggregation see exactly what the runtime did to itself;
- the elastic GROW trigger (:meth:`poll_grow`, called by the training
  loop BETWEEN passes): under sustained heartbeat-gap evidence on a
  degraded world, the members all-gather their locally observed admit
  registrations (``ElasticWorld.pending_admissions``) and re-form WITH
  the union —
  the replacement rank a joiner registered via ``ElasticWorld.admit()``
  enters at the next pass boundary, ownership rebinds so the newcomer
  rebuilds exactly its shards' working set, and the coordinated resume
  election puts the grown world on one snapshot.

The controller also feeds the WireController's flow-attribution veto
from the doctor's cross-rank-flow finding
(``Trainer.note_flow_attribution`` at every boundary) instead of a
manual operator call.

The fixers act on the port's knobs: ``flags.incremental_feed``, the spill
stores' RAM cache rows, ``TrainerConfig.capacity_factor`` and
``flags.exchange_adaptive`` with an ``exchange.WireController``. The
port's step is eager, so a capacity change takes effect at the next step
(there is no compiled step to rebuild).
"""

from __future__ import annotations

import hashlib

import numpy as np

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags as config_flags, set_flags
from paddlebox_tpu_torch.monitor.hub import STATS


class Action:
    """One machine-applicable remediation: what a rule's suggestion means
    in code. ``bit_identity`` is the rule's promise — True puts the apply
    under the parity guard; ``watch`` names the counters whose per-pass
    deltas become the flight record's before/after account; ``revert``
    must restore the pre-apply configuration exactly (the guard calls it
    on a parity failure)."""

    def __init__(self, rule: str, name: str, bit_identity: bool,
                 apply, revert, watch: tuple = (), detail: dict | None = None):
        self.rule = rule
        self.name = name
        self.bit_identity = bool(bit_identity)
        self._apply = apply
        self._revert = revert
        self.watch = tuple(watch)
        self.detail = dict(detail or {})

    def apply(self) -> None:
        self._apply()

    def revert(self) -> None:
        self._revert()


# ---------------------------------------------------------------------------
# the action catalog: rule id -> fixer(trainer, finding) -> Action | None
# ---------------------------------------------------------------------------
#
# A fixer returns None when the suggestion is not machine-applicable in
# THIS run (flag already on, no spill tier, unsharded table…) — the rule
# then stays advisory, exactly as before. Rules without a fixer
# (nan-guard, push-floor, serving-staleness, sink-health) are advisory by
# design: their fixes name code/data changes no flag flip can make.

def _fix_boundary_wall(trainer, finding):
    # the rule's reuse_off arm: "set flags.incremental_feed=True" — the
    # delta feed's contract IS bit-identity (same rows, cheaper build),
    # so the guard holds it to that
    if config_flags.incremental_feed:
        return None
    ev = finding.get("evidence") or {}
    if ev.get("reused_rows"):          # reuse already works; not our arm
        return None
    return Action(
        "boundary-wall", "enable-incremental-feed", bit_identity=True,
        apply=lambda: set_flags(incremental_feed=True),
        revert=lambda: set_flags(incremental_feed=False),
        watch=("feed_pass.fresh_rows", "feed_pass.reused_rows"),
        detail={"flag": "incremental_feed"})


def _fix_spill_thrash(trainer, finding):
    # "raise flags.spill_cache_rows (or turn on spill_cache_autotune)":
    # double every spill sub-store's RAM cache, bounded — placement-only
    # (the cache is never authoritative), so bit-identical by contract
    if trainer is None or config_flags.spill_cache_autotune:
        return None                    # autotune already owns the budget
    from paddlebox_tpu_torch.embedding import tiering
    subs = tiering._spill_subs(getattr(trainer, "store", None))
    if not subs:
        return None
    slots0 = [int(s._cache_slots) for s in subs]
    if all(n >= tiering.CACHE_MAX_ROWS for n in slots0):
        return None

    def _apply():
        for s, n in zip(subs, slots0):
            s.resize_cache(min(n * 2, tiering.CACHE_MAX_ROWS))

    def _revert():
        for s, n in zip(subs, slots0):
            s.resize_cache(n)

    return Action(
        "spill-thrash", "grow-spill-cache", bit_identity=True,
        apply=_apply, revert=_revert,
        watch=("spill.cache_hits", "spill.cache_misses",
               "tiering.evicted"),
        detail={"cache_rows_before": int(sum(slots0))})


def _fix_exchange_overflow(trainer, finding):
    # "raise flags.exchange_capacity_factor": the adaptive-doubling
    # contract (_check_dropped) applied proactively. NOT bit-identical —
    # tokens that overflowed were dropped; at the grown capacity they
    # train, which is the point. The eager step reads the factor at each
    # call, so the next step runs at it
    if trainer is None or getattr(trainer, "table_layout", None) != "sharded":
        return None
    capf = float(trainer.cfg.capacity_factor)
    grown = min(float(trainer.n_shards), capf * 2.0)
    if grown <= capf:
        return None

    eval0 = float(trainer._eval_capacity)

    def _apply():
        trainer.cfg.capacity_factor = grown
        trainer._eval_capacity = max(eval0, grown)

    def _revert():
        trainer.cfg.capacity_factor = capf
        trainer._eval_capacity = eval0

    return Action(
        "exchange-overflow", "grow-exchange-capacity", bit_identity=False,
        apply=_apply, revert=_revert,
        watch=("exchange.overflow_retries", "exchange.overflow_dropped"),
        detail={"capacity_factor": grown, "capacity_factor_before": capf})


def _fix_dedup_drift(trainer, finding):
    # "turn on flags.exchange_adaptive": flag flip + late-construct the
    # per-pass WireController. NOT bit-identical — the controller may
    # switch the wire (bf16/int8) on a later pass.
    if trainer is None or getattr(trainer, "table_layout", None) != "sharded":
        return None
    if config_flags.exchange_adaptive or trainer._wire_controller is not None:
        return None
    from paddlebox_tpu_torch.embedding import exchange

    def _apply():
        set_flags(exchange_adaptive=True)
        trainer._wire_controller = exchange.WireController(
            trainer.store.cfg, trainer.exchange_wire)

    def _revert():
        set_flags(exchange_adaptive=False)
        trainer._wire_controller = None

    return Action(
        "dedup-drift", "enable-adaptive-exchange", bit_identity=False,
        apply=_apply, revert=_revert,
        watch=("exchange.tokens", "exchange.unique_lanes",
               "exchange.wire_switches"),
        detail={"flag": "exchange_adaptive"})


DEFAULT_ACTIONS = {
    "boundary-wall": _fix_boundary_wall,
    "spill-thrash": _fix_spill_thrash,
    "exchange-overflow": _fix_exchange_overflow,
    "dedup-drift": _fix_dedup_drift,
}


class RemediationController:
    """The per-pass self-healing loop; see module doc. One per trainer
    (``Trainer.enable_self_healing``); every method is a no-op unless
    ``flags.self_healing`` is on, so the controller can stay bound across
    A/B phases."""

    def __init__(self, trainer=None, actions: dict | None = None,
                 probe_keys=None):
        self.trainer = trainer
        self.actions = dict(DEFAULT_ACTIONS if actions is None else actions)
        # optional sparse probe: row keys whose store bytes join the
        # parity fingerprint (the dense params alone can't see a cache
        # resize corrupting spill rows)
        self.probe_keys = probe_keys
        self.quarantined: set[str] = set()
        self._streak: dict[str, int] = {}
        self._prev_snap: dict | None = None
        # (action, snapshot-at-apply, record) awaiting its after-window —
        # no new action applies while one is settling
        self._settling: tuple | None = None
        # remediation records queued by poll_grow for the next boundary
        self._notes: list[dict] = []
        # findings pushed from the world-view aggregation (feed_report)
        self._external_findings: list | None = None
        self._grow_polls = 0

    # -- evidence ---------------------------------------------------------

    def _findings(self) -> list:
        if self._external_findings is not None:
            f, self._external_findings = self._external_findings, None
            return f
        from paddlebox_tpu_torch.monitor import doctor
        # remediation-history feedback: rules this
        # controller quarantined ride into the report, which downgrades
        # their findings to info and suppresses the discredited advice
        return doctor.diagnose_hub(
            monitor.hub(),
            quarantined_rules=self.quarantined)["findings"]

    def feed_report(self, report: dict) -> None:
        """Feed a doctor report produced from the live world-view
        aggregation (``doctor.diagnose`` over merged rank streams) — its
        findings carry the cross-rank evidence an in-process diagnosis
        cannot form (flow edges, world skew). They are consumed at the
        next :meth:`boundary`, and the flow-attribution veto is fed
        immediately."""
        findings = list((report or {}).get("findings") or [])
        self._external_findings = findings
        self._feed_flow(findings)

    def _feed_flow(self, findings: list) -> None:
        """Route the cross-rank-flow finding's clock-corrected attribution
        into the WireController's veto (``Trainer.note_flow_attribution``)
        — the manual operator call stops being the only carrier. A
        boundary where the rule did not fire clears the veto (stale flow
        evidence must not hold a wire forever)."""
        t = self.trainer
        note = getattr(t, "note_flow_attribution", None)
        if note is None:
            return
        f = next((f for f in findings if f.get("rule") == "cross-rank-flow"),
                 None)
        if f is None:
            note(None)
            return
        ev = f.get("evidence") or {}
        longest = ev.get("longest_edge")
        if not isinstance(longest, dict):
            return
        fa = {"longest": longest,
              "longest_share_of_wall": ev.get("longest_share_of_wall"),
              "by_kind": ev.get("by_kind") or {},
              "edges": ev.get("edges"),
              "negative_edges": ev.get("negative_edges", 0)}
        share = ev.get("longest_share_of_wall")
        wall = (float(longest.get("latency_s", 0.0)) / float(share)
                if share else None)
        note(fa, wall)
        monitor.counter_add("remediation.flow_feeds")

    # -- parity guard -----------------------------------------------------

    def _fingerprint(self) -> str | None:
        """sha256 over the dense params' bytes, in the reference's flatten
        order (+ the probe rows' store bytes, when set) — the
        bit-identity witness the guard compares across an apply. None
        when the trainer exposes no params (the guard then cannot hold
        the promise and the action is skipped, not trusted)."""
        t = self.trainer
        eval_params = getattr(t, "eval_params", None)
        if eval_params is None:
            return None
        from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
        h = hashlib.sha256()
        for _, leaf in flatten_tree(eval_params()):
            h.update(np.asarray(leaf).tobytes())
        if self.probe_keys is not None:
            get_rows = getattr(getattr(t, "store", None), "get_rows", None)
            if get_rows is not None:
                rows = get_rows(np.asarray(self.probe_keys,
                                           dtype=np.uint64))
                h.update(np.asarray(rows).tobytes())
        return h.hexdigest()

    # -- the per-pass loop ------------------------------------------------

    @staticmethod
    def _delta(snap0: dict, snap1: dict, watch: tuple) -> dict:
        return {k: round(float(snap1.get(k, 0.0)) - float(snap0.get(k, 0.0)),
                         6) for k in watch}

    def boundary(self, findings: list | None = None) -> dict | None:
        """One pass-boundary evaluation — called pre-commit (BEFORE
        ``hub.end_pass``) so the remediation record lands in the ending
        pass's flight record. Returns the record written, or None."""
        if not config_flags.self_healing:
            return None
        snap = STATS.snapshot()
        prev, self._prev_snap = self._prev_snap, snap
        if findings is None:
            findings = self._findings()
        self._feed_flow(findings)
        fired = {f.get("rule") for f in findings}
        for rule in list(self._streak):
            if rule not in fired:
                self._streak[rule] = 0
        for rule in fired:
            self._streak[rule] = self._streak.get(rule, 0) + 1
        rec: dict | None = None
        if self._settling is not None:
            # the pass that just ran is the applied action's after-window
            act, base, entry = self._settling
            self._settling = None
            rec = dict(entry)
            rec["after"] = self._delta(base, snap, act.watch)
        elif self._notes:
            rec = self._notes.pop(0)
        else:
            rec = self._maybe_apply(findings, prev or {}, snap)
        if rec is not None:
            monitor.hub().record_train(remediation=rec)
        return rec

    def _maybe_apply(self, findings: list, prev: dict,
                     snap: dict) -> dict | None:
        sustain = max(1, int(config_flags.self_healing_sustain))
        for f in findings:             # already severity-sorted
            rule = f.get("rule")
            fixer = self.actions.get(rule)
            if (fixer is None or rule in self.quarantined
                    or self._streak.get(rule, 0) < sustain):
                continue
            act = fixer(self.trainer, f)
            if act is None:
                continue
            return self._apply_guarded(act, prev, snap)
        return None

    def _apply_guarded(self, act: Action, prev: dict,
                       snap: dict) -> dict | None:
        before = self._delta(prev, snap, act.watch)
        fp0 = self._fingerprint() if act.bit_identity else None
        if act.bit_identity and fp0 is None:
            return None                # cannot witness the promise
        try:
            act.apply()
            fp1 = self._fingerprint() if act.bit_identity else None
        except Exception as e:
            # a half-applied action is worse than none: restore and
            # quarantine (the revert raising too is the one case we let
            # escape — the trainer hook's catch-all records it)
            act.revert()
            self.quarantined.add(act.rule)
            monitor.counter_add("remediation.errors")
            monitor.event("remediation_reverted", rule=act.rule,
                          action=act.name, reason=f"apply-error: {e!r}"[:200])
            return {"rule": act.rule, "action": act.name,
                    "status": "reverted", "reason": "apply-error",
                    "before": before}
        if fp0 is not None and fp1 != fp0:
            act.revert()
            self.quarantined.add(act.rule)
            monitor.counter_add("remediation.reverted")
            monitor.event("remediation_reverted", rule=act.rule,
                          action=act.name, reason="parity-guard")
            return {"rule": act.rule, "action": act.name,
                    "status": "reverted", "reason": "parity-guard",
                    "before": before}
        monitor.counter_add("remediation.applied")
        monitor.event("remediation_applied", rule=act.rule, action=act.name,
                      bit_identity=act.bit_identity, **act.detail)
        entry = {"rule": act.rule, "action": act.name, "status": "applied",
                 "before": before}
        if act.detail:
            entry["detail"] = dict(act.detail)
        self._settling = (act, snap, entry)
        return dict(entry)

    # -- elastic grow -----------------------------------------------------

    def grow_evidence(self, findings: list | None = None) -> dict | None:
        """The heartbeat-gap finding's grow-side evidence, or None when
        the world is healthy / not degraded. Every field the gate reads
        (``degraded``, ``world_size`` — gauges set identically on all
        survivors at world formation) is rank-consistent, so members
        gating on it decide the SAME way at the same boundary."""
        if findings is None:
            findings = self._findings()
        f = next((f for f in findings if f.get("rule") == "heartbeat-gap"),
                 None)
        if f is None:
            return None
        ev = f.get("evidence") or {}
        return ev if ev.get("degraded") else None

    def poll_grow(self, world, box=None, checkpointer=None, metrics=None,
                  findings: list | None = None):
        """Between-pass grow poll (called by the training loop where
        ``recover_world`` would be — NEVER inside an open pass): under
        sustained heartbeat-gap evidence on a degraded world, all-gather
        every member's locally scanned admit registrations, re-form WITH
        the union, rebind ownership/collectives, and rerun the
        coordinated resume election so the grown world stands on one
        snapshot.

        Returns ``(world, cursor)`` — the same world and None when no
        grow happened; the new world and the elected cursor (possibly
        None = fresh start) after a grow. The two local scans racing a
        registration is why the union is gathered: a joiner seen by only
        one member still joins, and a joiner seen by none waits one more
        pass."""
        if (world is None or not config_flags.self_healing
                or "world-grow" in self.quarantined):
            return world, None
        ev = self.grow_evidence(findings)
        if ev is None:
            return world, None
        pending = world.pending_admissions()
        # rank-consistent call site + monotone poll id = every member
        # runs the SAME collective; the union makes the decision shared
        self._grow_polls += 1
        name = f"admit_scan_g{world.gen}_{self._grow_polls}"
        gathered = world.collectives.all_gather(sorted(pending), name=name)
        admits = sorted(set(r for lst in gathered for r in lst))
        if not admits:
            return world, None
        t0_members = list(world.members)
        new_world = world.reform([], admit_orig_ranks=admits)
        t = self.trainer
        cursor = None
        if t is not None:
            t.peer_check = new_world.check
            own = getattr(getattr(t, "feed_mgr", None), "ownership", None)
            if own is not None:
                new_own = own.with_world(new_world.world, new_world.rank)
                rebind = new_own.diff(own)
                t.set_shard_ownership(new_own)
                monitor.event("remediation_applied", rule="heartbeat-gap",
                              action="world-grow",
                              gained_shards=rebind["gained"],
                              lost_shards=rebind["lost"])
            if box is not None:
                box.attach_collectives(new_world.collectives,
                                       heartbeat=new_world.heartbeat)
            if checkpointer is not None:
                from paddlebox_tpu_torch.distributed import resilience
                cursor = resilience.coordinated_resume(
                    checkpointer, t, new_world.collectives, box=box,
                    metrics=metrics)
        monitor.counter_add("remediation.applied")
        self._notes.append({
            "rule": "heartbeat-gap", "action": "world-grow",
            "status": "applied",
            "detail": {"joined": ",".join(str(r) for r in admits),
                       "from_world": len(t0_members),
                       "to_world": new_world.world,
                       "gen": new_world.gen}})
        return new_world, cursor
