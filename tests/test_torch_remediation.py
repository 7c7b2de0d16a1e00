"""The port's self-healing loop (``paddlebox_tpu_torch.runtime.
remediation``) against the JAX package's: the counterparts of
tests/test_remediation.py's cases — the off switch, the sustain streak
and its reset, the parity guard (revert + quarantine on changed bits, on
an apply error, and no blind apply without params), the applied record
on the flight record with its after-window and one action a pass, the
registered events, the flow-attribution feed of the wire veto,
``feed_report``, the catalog's four fixers on the port's knobs, the grow
evidence gate and ``poll_grow`` admitting a joiner over a threaded
``ElasticWorld`` — plus the trainer and BoxPS hooks. The same scenario
run through both packages' controllers writes the same flight-record
extra.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu import monitor as jmon
from paddlebox_tpu.config import set_flags as jset_flags
from paddlebox_tpu.runtime import remediation as jrem

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags, set_flags
from paddlebox_tpu_torch.distributed.resilience import ElasticWorld
from paddlebox_tpu_torch.distributed.store import FileStore
from paddlebox_tpu_torch.monitor import flight
from paddlebox_tpu_torch.monitor.names import EVENT_NAMES
from paddlebox_tpu_torch.monitor.registry import STATS
from paddlebox_tpu_torch.runtime.remediation import (DEFAULT_ACTIONS,
                                                      Action,
                                                      RemediationController)
from paddlebox_tpu_torch.utils import faultpoint

from tests.test_torch_resume import _dataset, _make

torch.set_num_threads(1)

FLAGS = ("self_healing", "self_healing_sustain", "incremental_feed",
         "exchange_adaptive", "spill_cache_autotune", "doctor_live")


@pytest.fixture(autouse=True)
def _clean():
    saved = {k: getattr(flags, k) for k in FLAGS}
    for h in (monitor.hub(), jmon.hub()):
        h.disable()
        h.abort_pass(reason="test setup")
    faultpoint.disarm()
    yield
    for h in (monitor.hub(), jmon.hub()):
        h.abort_pass(reason="test teardown")
        h.disable()
    faultpoint.disarm()
    for k, v in saved.items():
        flags.set(k, v)
    jset_flags(self_healing=False, self_healing_sustain=2,
               incremental_feed=True)


@pytest.fixture
def healing():
    set_flags(self_healing=True, self_healing_sustain=1)
    yield


def _finding(rule, severity="warn", evidence=None):
    return {"rule": rule, "severity": severity, "summary": rule,
            "evidence": dict(evidence or {}), "suggestion": "fix it"}


class _StubTrainer:
    """The surface the controller touches: fingerprintable dense params
    and the flow-attribution note."""

    def __init__(self):
        self.params = np.arange(8, dtype=np.float32)
        self.flow_notes = []

    def eval_params(self):
        return {"w": self.params}

    def note_flow_attribution(self, fa, wall=None):
        self.flow_notes.append((fa, wall))


def _noop_action(rule="test-rule", bit_identity=True, watch=(),
                 mutate=None, fail=False, cls=Action):
    log = []

    def _apply():
        log.append("apply")
        if fail:
            raise RuntimeError("boom")
        if mutate is not None:
            mutate()

    return cls(rule, "test-action", bit_identity=bit_identity,
               apply=_apply, revert=lambda: log.append("revert"),
               watch=watch, detail={"flag": "none"}), log


def _ctl(act, tr=None, cls=RemediationController):
    return cls(trainer=tr if tr is not None else _StubTrainer(),
               actions={act.rule: lambda t, f: act})


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------

def test_self_healing_off_is_a_noop():
    act, log = _noop_action()
    assert _ctl(act).boundary([_finding("test-rule")]) is None
    assert log == []


def test_sustain_threshold_blocks_the_first_firing(healing):
    set_flags(self_healing_sustain=2)
    act, log = _noop_action()
    ctl = _ctl(act)
    monitor.hub().begin_pass(1)
    assert ctl.boundary([_finding("test-rule")]) is None
    rec = ctl.boundary([_finding("test-rule")])
    assert rec["status"] == "applied" and log == ["apply"]


def test_streak_resets_on_a_quiet_boundary(healing):
    set_flags(self_healing_sustain=2)
    act, log = _noop_action()
    ctl = _ctl(act)
    monitor.hub().begin_pass(1)
    assert ctl.boundary([_finding("test-rule")]) is None
    assert ctl.boundary([]) is None
    assert ctl.boundary([_finding("test-rule")]) is None
    assert log == []


# ---------------------------------------------------------------------------
# parity guard
# ---------------------------------------------------------------------------

def test_parity_guard_reverts_and_quarantines(healing):
    tr = _StubTrainer()
    act, log = _noop_action(mutate=lambda: tr.params.__setitem__(0, 99.0))
    ctl = _ctl(act, tr)
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    before = STATS.get("remediation.reverted")
    h.begin_pass(1)
    rec = ctl.boundary([_finding("test-rule")])
    assert (rec["status"], rec["reason"]) == ("reverted", "parity-guard")
    assert log == ["apply", "revert"] and "test-rule" in ctl.quarantined
    assert STATS.get("remediation.reverted") == before + 1
    assert ctl.boundary([_finding("test-rule")]) is None
    ev = ms.find("remediation_reverted")
    assert ev and ev[0]["fields"]["reason"] == "parity-guard"


def test_parity_guard_reads_a_real_trainers_params(healing):
    """The fingerprint is the port trainer's dense params' bytes: a
    one-ulp change to one weight reverts."""
    _, tr, _ = _make("port", carry=False)

    def nudge():
        with torch.no_grad():
            p = tr.params[0].view(-1)
            p[0] = torch.nextafter(p[0], p[0] + 1)

    act, log = _noop_action(mutate=nudge)
    ctl = _ctl(act, tr)
    fp = ctl._fingerprint()
    assert fp == ctl._fingerprint()
    monitor.hub().begin_pass(1)
    rec = ctl.boundary([_finding("test-rule")])
    assert rec["reason"] == "parity-guard" and ctl._fingerprint() != fp


def test_apply_error_reverts_and_quarantines(healing):
    act, log = _noop_action(fail=True)
    ctl = _ctl(act)
    monitor.hub().begin_pass(1)
    rec = ctl.boundary([_finding("test-rule")])
    assert (rec["status"], rec["reason"]) == ("reverted", "apply-error")
    assert log == ["apply", "revert"] and "test-rule" in ctl.quarantined


def test_bit_identity_without_params_is_skipped_not_trusted(healing):
    act, log = _noop_action()
    ctl = RemediationController(trainer=None,
                                actions={"test-rule": lambda t, f: act})
    monitor.hub().begin_pass(1)
    assert ctl.boundary([_finding("test-rule")]) is None
    assert log == []


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def _scenario(mon, set_fl, act_cls, ctl_cls):
    """Two boundaries through one package: an applied action, then its
    settling window blocking a second rule. Returns both flight records'
    remediation extras and the applied events' fields."""
    set_fl(self_healing=True, self_healing_sustain=1)
    act, _ = _noop_action(watch=("healing.test_counter",), cls=act_cls)
    ctl = _ctl(act, cls=ctl_cls)
    h = mon.hub()
    ms = mon.MemorySink()
    h.enable(ms)
    try:
        h.begin_pass(1)
        mon.counter_add("healing.test_counter", 3)
        ctl.boundary([_finding("test-rule")])
        r1 = h.end_pass()
        h.begin_pass(2)
        mon.counter_add("healing.test_counter", 5)
        act2, log2 = _noop_action(rule="other-rule", cls=act_cls)
        ctl.actions["other-rule"] = lambda t, f: act2
        ctl.boundary([_finding("other-rule")])
        r2 = h.end_pass()
        assert log2 == []
    finally:
        h.disable()
        set_fl(self_healing=False)
    for r in (r1, r2):
        assert flight.validate_flight_record(r) == []
    return ([r["extra"]["remediation"] for r in (r1, r2)],
            [e["fields"] for e in ms.find("remediation_applied")])


def test_applied_record_rides_the_flight_record_with_after(healing):
    extras, events = _scenario(monitor, set_flags, Action,
                               RemediationController)
    jextras, jevents = _scenario(jmon, jset_flags, jrem.Action,
                                 jrem.RemediationController)
    assert extras == jextras
    assert events == jevents
    assert extras[0]["status"] == "applied" and "after" not in extras[0]
    assert extras[1]["after"] == {"healing.test_counter": 5.0}
    assert extras[1]["before"] == {"healing.test_counter": 3.0}


def test_self_healing_events_are_registered():
    assert {"remediation_applied", "remediation_reverted",
            "world_grow"} <= set(EVENT_NAMES)


# ---------------------------------------------------------------------------
# the flow feed and fed reports
# ---------------------------------------------------------------------------

def test_cross_rank_flow_finding_feeds_the_wire_veto(healing):
    tr = _StubTrainer()
    ctl = RemediationController(trainer=tr, actions={})
    monitor.hub().begin_pass(1)
    ev = {"longest_edge": {"kind": "exchange", "latency_s": 0.4},
          "longest_share_of_wall": 0.5, "by_kind": {"exchange": 0.4},
          "edges": 3, "negative_edges": 0}
    ctl.boundary([_finding("cross-rank-flow", evidence=ev)])
    fa, wall = tr.flow_notes[-1]
    assert fa["longest"]["kind"] == "exchange"
    assert wall == pytest.approx(0.8)
    ctl.boundary([])
    assert tr.flow_notes[-1][0] is None


def test_note_flow_attribution_reaches_the_wire_controller():
    """Trainer.note_flow_attribution holds the attribution the adaptive
    wire controller's veto reads at the next boundary."""
    _, tr, _ = _make("port", carry=False)
    fa = {"longest": {"kind": "publish"}, "by_kind": {}, "edges": 1}
    tr.note_flow_attribution(fa, 2.0)
    assert tr._flow_attribution == (fa, 2.0)
    tr.note_flow_attribution(None)
    assert tr._flow_attribution is None


def test_feed_report_findings_consumed_at_next_boundary(healing):
    act, log = _noop_action()
    ctl = _ctl(act)
    ctl.feed_report({"findings": [_finding("test-rule")]})
    monitor.hub().begin_pass(1)
    rec = ctl.boundary()
    assert rec["status"] == "applied" and log == ["apply"]


# ---------------------------------------------------------------------------
# the catalog on the port's knobs
# ---------------------------------------------------------------------------

def test_boundary_wall_fixer_flips_incremental_feed(healing):
    set_flags(incremental_feed=False)
    ctl = RemediationController(trainer=_StubTrainer())
    monitor.hub().begin_pass(1)
    rec = ctl.boundary([_finding("boundary-wall",
                                 evidence={"share": 0.8, "reused_rows": 0})])
    assert (rec["status"], rec["action"]) == ("applied",
                                              "enable-incremental-feed")
    assert flags.incremental_feed
    assert RemediationController(trainer=_StubTrainer()).boundary(
        [_finding("boundary-wall", evidence={"share": 0.8})]) is None
    assert DEFAULT_ACTIONS["boundary-wall"](
        None, _finding("boundary-wall", evidence={"reused_rows": 5})) \
        is None


class _ShardedStub(_StubTrainer):
    """The sharded layout's knobs: the capacity factor, the eval
    capacity and the wire controller."""

    def __init__(self):
        super().__init__()
        from paddlebox_tpu_torch.embedding import EmbeddingConfig
        from paddlebox_tpu_torch.train import TrainerConfig
        self.table_layout = "sharded"
        self.n_shards = 4
        self.cfg = TrainerConfig(global_batch_size=8, capacity_factor=1.5)
        self._eval_capacity = 2.0
        self._wire_controller = None
        self.exchange_wire = "bf16"

        class _S:
            cfg = EmbeddingConfig(dim=8)
        self.store = _S()


def test_exchange_overflow_fixer_grows_the_capacity(healing):
    tr = _ShardedStub()
    act = DEFAULT_ACTIONS["exchange-overflow"](tr, _finding(
        "exchange-overflow"))
    assert not act.bit_identity
    act.apply()
    assert tr.cfg.capacity_factor == 3.0 and tr._eval_capacity == 3.0
    act.revert()
    assert tr.cfg.capacity_factor == 1.5 and tr._eval_capacity == 2.0
    single = _StubTrainer()
    single.table_layout = "single"
    assert DEFAULT_ACTIONS["exchange-overflow"](single, {}) is None


def test_dedup_drift_fixer_turns_on_the_wire_controller(healing):
    from paddlebox_tpu_torch.embedding import exchange
    set_flags(exchange_adaptive=False)
    tr = _ShardedStub()
    act = DEFAULT_ACTIONS["dedup-drift"](tr, _finding("dedup-drift"))
    act.apply()
    assert flags.exchange_adaptive
    assert isinstance(tr._wire_controller, exchange.WireController)
    act.revert()
    assert not flags.exchange_adaptive and tr._wire_controller is None


def test_spill_thrash_fixer_grows_the_cache(tmp_path, healing):
    from paddlebox_tpu_torch.embedding import EmbeddingConfig, tiering
    from paddlebox_tpu_torch.embedding.spill_store import SpillEmbeddingStore
    set_flags(spill_cache_autotune=False)
    store = SpillEmbeddingStore(EmbeddingConfig(dim=8),
                                spill_dir=str(tmp_path / "rows"),
                                cache_rows=256)
    tr = _StubTrainer()
    tr.store = store
    subs = tiering._spill_subs(store)
    before = [int(s._cache_slots) for s in subs]
    act = DEFAULT_ACTIONS["spill-thrash"](tr, _finding("spill-thrash"))
    assert act.bit_identity
    act.apply()
    assert [int(s._cache_slots) for s in subs] == [2 * b for b in before]
    act.revert()
    assert [int(s._cache_slots) for s in subs] == before


# ---------------------------------------------------------------------------
# the trainer and BoxPS hooks
# ---------------------------------------------------------------------------

def test_trainer_owned_pass_runs_the_boundary(healing):
    """A bare train_pass (its own hub scope) runs remediation_boundary
    before the commit: the action's record lands on its flight record."""
    _, tr, _ = _make("port", carry=False)
    act, log = _noop_action()
    ctl = tr.enable_self_healing(_ctl(act, tr))
    assert tr._remediation is ctl
    ctl.feed_report({"findings": [_finding("test-rule")]})
    tr.train_pass(_dataset("port", tr, 1))
    rec = monitor.hub().flight_records()[-1]
    assert rec["extra"]["remediation"]["status"] == "applied"
    assert log == ["apply"]


def test_boxps_end_pass_heals_and_returns_the_record(healing):
    """BoxPS.end_pass runs the live doctor's findings through the
    controller: a boundary-heavy run with incremental_feed off gets it
    turned back on, recorded under end_pass()["remediation"] and the
    flight record's extra, the parity guard holding (the flag flip
    leaves the dense params' bytes alone)."""
    set_flags(incremental_feed=False, doctor_live=True)
    _, tr, box = _make("port", carry=False)
    ctl = tr.enable_self_healing()
    h = monitor.hub()
    # the live doctor reads the hub's ring of flight records: this run's
    # only (earlier tests' passes reused rows)
    h._flight_records.clear()
    h.begin_pass(90)              # a boundary-heavy pass with no reuse
    monitor.counter_add("feed_pass.fresh_rows", 100)
    h.record_train(steps=1, examples=8, seconds=0.01, boundary_seconds=5.0)
    h.end_pass()
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    out = box.end_pass(trainer=tr)
    assert out["remediation"]["action"] == "enable-incremental-feed"
    assert out["remediation"]["status"] == "applied"
    assert out["flight_record"]["extra"]["remediation"] == \
        out["remediation"]
    assert flags.incremental_feed and not ctl.quarantined
    assert any(f["rule"] == "boundary-wall" for f in out["doctor"])


def test_broken_controller_is_counted_never_raised(healing):
    _, tr, _ = _make("port", carry=False)

    class Broken:
        def boundary(self, findings=None):
            raise RuntimeError("controller broke")

    tr.enable_self_healing(Broken())
    before = STATS.get("remediation.errors")
    assert tr.remediation_boundary() is None
    assert STATS.get("remediation.errors") == before + 1
    set_flags(self_healing=False)
    assert tr.remediation_boundary() is None


# ---------------------------------------------------------------------------
# elastic grow
# ---------------------------------------------------------------------------

def test_grow_evidence_gates_on_degraded():
    ctl = RemediationController()
    assert ctl.grow_evidence(
        [_finding("heartbeat-gap", evidence={"degraded": False})]) is None
    ev = ctl.grow_evidence([_finding(
        "heartbeat-gap", evidence={"degraded": True, "world_size": 2})])
    assert ev["world_size"] == 2
    assert ctl.grow_evidence([]) is None


def test_poll_grow_requires_evidence_and_flag(healing):
    ctl = RemediationController()
    assert ctl.poll_grow(None) == (None, None)

    class _W:
        gen = 0
        members = [0]

    w = _W()
    gap = [_finding("heartbeat-gap", evidence={"degraded": True})]
    set_flags(self_healing=False)
    assert ctl.poll_grow(w, findings=gap) == (w, None)
    set_flags(self_healing=True)
    assert ctl.poll_grow(w, findings=[]) == (w, None)
    ctl.quarantined.add("world-grow")
    assert ctl.poll_grow(w, findings=gap) == (w, None)


def test_poll_grow_admits_joiner_over_threaded_world(tmp_path, healing):
    """A degraded 2-member world (launched at 3) polls grow under
    heartbeat-gap evidence while a joiner thread runs ElasticWorld.admit:
    the union all-gather sees the registration, reform admits it, the
    world-grow record is queued for the next boundary and the consumed
    registration never re-triggers."""
    hbgap = _finding("heartbeat-gap",
                     evidence={"degraded": True, "world_size": 2})
    results, errs = {}, []
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)

    def incumbent(r):
        try:
            w = ElasticWorld(FileStore(str(tmp_path), namespace="r",
                                       poll_s=0.01),
                             r, [0, 1], heartbeat_interval_s=0.05,
                             lost_after_s=30.0, stall_after_s=60.0,
                             reform_timeout_s=2.0, initial_world=3)
            ctl = RemediationController()
            nw = w
            for _ in range(60):
                nw, _ = ctl.poll_grow(w, findings=[hbgap])
                if nw is not w:
                    break
            results[r] = (nw.gen, nw.members, ctl._notes)
            nw.collectives.barrier("post_grow")
            nw.close()
        except BaseException as e:   # reported below
            errs.append((r, e))

    def joiner():
        try:
            w = ElasticWorld.admit(
                FileStore(str(tmp_path), namespace="r", poll_s=0.01), 2,
                timeout_s=30.0, heartbeat_interval_s=0.05,
                lost_after_s=30.0, stall_after_s=60.0, reform_timeout_s=2.0,
                initial_world=3)
            results["j"] = (w.gen, w.members)
            w.collectives.barrier("post_grow")
            w.close()
        except BaseException as e:   # reported below
            errs.append(("j", e))

    ts = ([threading.Thread(target=incumbent, args=(r,)) for r in (0, 1)]
          + [threading.Thread(target=joiner)])
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=90)
    h.disable()
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)
    assert results[0][:2] == results[1][:2] == results["j"] == (1, [0, 1, 2])
    notes = results[0][2]
    assert notes and notes[0]["action"] == "world-grow"
    assert notes[0]["detail"] == {"joined": "2", "from_world": 2,
                                  "to_world": 3, "gen": 1}
    grow = ms.find("world_grow")
    assert grow and any(e["fields"]["joined"] == [2] for e in grow)
    assert FileStore(str(tmp_path), namespace="r",
                     poll_s=0.01).keys("elastic.admit.") == []
