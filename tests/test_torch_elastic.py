"""Elastic rank-loss recovery in the port
(``paddlebox_tpu_torch.distributed.resilience.ElasticWorld``), the
counterparts of tests/test_elastic.py:

- the generation-sealed re-formation, threads as ranks on one store:
  convergence on one generation, an exclusive seal that fences a
  straggler, escalation past a rank that arrived but never acked, the
  min-world floor, the departed ranks' keys swept, generation scopes
  isolated, admit (grow) into the next generation, pending admissions
  scoped to the generation and its non-members, the re-registration
  when a generation seals without the joiner, the admit deadline, and
  the watchdog naming original ranks; a port rank and a JAX rank
  re-form one world together;
- the elastic fault points are the JAX package's sets, and the
  ownership rebind's window is on ``Trainer.set_shard_ownership``'s
  path; ``recover_world`` re-deals a ShardOwnership to the new world;
- a 2 -> 1 kill (tests/torch_resilience_worker.py through the port's
  launcher, ``fail_stop=False``): rank 1 dies at ``trainer.step.pre``
  inside pass 2; rank 0 names it (PeerLostError), drain-snapshots
  mid-pass, re-forms generation 1 alone, resumes, re-routes rank 1's
  unconsumed tail and finishes 3 passes bit-equal to the simulated
  shrink (a one-rank run of the same record schedule, no kill).
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu.distributed import resilience as jres
from paddlebox_tpu.distributed.store import FileStore as JaxFileStore
from paddlebox_tpu.utils import faultpoint as jfaultpoint

from paddlebox_tpu_torch.distributed.resilience import (ElasticWorld,
                                                        HeartbeatMonitor,
                                                        PeerLostError,
                                                        WorldFencedError,
                                                        WorldTooSmallError)
from paddlebox_tpu_torch.distributed.store import FileStore
from paddlebox_tpu_torch.utils import faultpoint

from tests import torch_resilience_worker as worker


def _world(tmp_path, rank, members, **kw):
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("lost_after_s", 30.0)
    kw.setdefault("stall_after_s", 60.0)
    kw.setdefault("reform_timeout_s", 2.0)
    return ElasticWorld(FileStore(str(tmp_path), namespace="r",
                                  poll_s=0.01),
                        rank, members, **kw)


def _threads(fns, timeout=60):
    errs = []

    def guard(name, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append((name, e))
        return run

    ts = [threading.Thread(target=guard(n, f)) for n, f in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not errs, errs


# ---------------------------------------------------------------------------
# the re-formation protocol (threads as ranks)
# ---------------------------------------------------------------------------

def test_reform_converges_on_one_generation(tmp_path):
    results = [None] * 3

    def rank(r):
        w = _world(tmp_path, r, [0, 1, 2])
        if r == 1:
            w.close()
            return
        nw = w.reform([1])
        results[r] = (nw.gen, nw.members, nw.rank, nw.world)
        nw.collectives.barrier("post_reform")
        nw.close()

    _threads([(r, lambda r=r: rank(r)) for r in range(3)])
    assert results[0] == (1, [0, 2], 0, 2)
    assert results[2] == (1, [0, 2], 1, 2)


def test_reform_with_a_jax_rank_converges(tmp_path):
    """A port survivor and a JAX survivor on one store seal, ack and
    barrier as one generation: the protocol's records are the same."""
    results = {}

    def port():
        w = _world(tmp_path, 0, [0, 1, 2])
        nw = w.reform([1])
        results["port"] = (nw.gen, nw.members, nw.rank)
        nw.collectives.barrier("mixed")
        nw.close()

    def jax_rank():
        w = jres.ElasticWorld(
            JaxFileStore(str(tmp_path), namespace="r", poll_s=0.01), 2,
            [0, 1, 2], heartbeat_interval_s=0.05, lost_after_s=30.0,
            stall_after_s=60.0, reform_timeout_s=2.0)
        nw = w.reform([1])
        results["jax"] = (nw.gen, nw.members, nw.rank)
        nw.collectives.barrier("mixed")
        nw.close()

    _threads([("port", port), ("jax", jax_rank)])
    assert results == {"port": (1, [0, 2], 0), "jax": (1, [0, 2], 1)}


def test_reform_seal_is_exclusive_and_fences_stragglers(tmp_path):
    w0 = _world(tmp_path, 0, [0, 1, 2], reform_timeout_s=0.5)
    nw = w0.reform([1])
    assert (nw.gen, nw.members) == (1, [0])
    nw.close()
    w2 = _world(tmp_path, 2, [0, 1, 2], reform_timeout_s=0.5)
    with pytest.raises(WorldFencedError):
        w2.reform([1])


def test_reform_escalates_past_arrived_but_unacked_rank(tmp_path):
    store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
    store.set("elastic.reform.g1.arrive.2",
              json.dumps({"rank": 2}).encode())
    w0 = _world(tmp_path, 0, [0, 1, 2], reform_timeout_s=0.6)
    nw = w0.reform([1])
    assert (nw.gen, nw.members) == (2, [0])
    g1 = json.loads(store.get("elastic.world.g1"))
    g2 = json.loads(store.get("elastic.world.g2"))
    assert g1["members"] == [0, 2] and g2["members"] == [0]
    nw.close()


def test_reform_respects_min_world_floor(tmp_path):
    from paddlebox_tpu_torch.config import flags
    old = flags.elastic_min_world
    flags.elastic_min_world = 2
    try:
        w0 = _world(tmp_path, 0, [0, 1], reform_timeout_s=0.3)
        with pytest.raises(WorldTooSmallError):
            w0.reform([1])
    finally:
        flags.elastic_min_world = old


def test_reform_sweeps_departed_rank_keys(tmp_path):
    store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
    store.set("hb.1", b"ghost")
    store.add("end_pass.7", 1)
    store.add("end_pass.7", 0)
    store.set("gather.3.v1", b"npyghost")
    store.scoped("g1").set("resume_candidates.1.v1", b"live")
    w0 = _world(tmp_path, 0, [0, 1], reform_timeout_s=0.3)
    nw = w0.reform([1])
    assert store.get("hb.1") is None
    assert store.get("gather.3.v1") is None
    assert store.missing_ranks("end_pass.7", 2) == [1]
    assert store.get("end_pass.7.0") is not None
    assert store.get("elastic.world.g1") is not None
    assert store.scoped("g1").get("resume_candidates.1.v1") == b"live"
    nw.close()


def test_gen_collectives_isolated_from_old_generation(tmp_path):
    base = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
    base.scoped("g0_fake").set("barrier.1.0", b"1")
    g1 = base.scoped("g1")
    assert g1.get("barrier.1.0") is None
    g1.set("x", b"1")
    assert base.get("x") is None


def test_admit_joins_next_generation(tmp_path):
    results = {}

    def incumbent():
        w0 = _world(tmp_path, 0, [0, 1], reform_timeout_s=0.5,
                    initial_world=2)
        g1 = w0.reform([1])
        deadline = time.monotonic() + 20.0
        while not g1.pending_admissions():
            assert time.monotonic() < deadline, "joiner never registered"
            time.sleep(0.02)
        assert g1.pending_admissions() == [1]
        g2 = g1.reform([], admit_orig_ranks=g1.pending_admissions())
        results["inc"] = (g2.gen, g2.members, g2.rank)
        g2.collectives.barrier("post_grow")
        g2.close()

    def joiner():
        store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
        w = ElasticWorld.admit(store, 1, timeout_s=20.0,
                               heartbeat_interval_s=0.05,
                               lost_after_s=30.0, stall_after_s=60.0,
                               reform_timeout_s=2.0, initial_world=2)
        results["join"] = (w.gen, w.members, w.rank)
        w.collectives.barrier("post_grow")
        w.close()

    _threads([("inc", incumbent), ("join", joiner)])
    assert results["inc"] == (2, [0, 1], 0)
    assert results["join"] == (2, [0, 1], 1)
    store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
    assert store.keys("elastic.admit.") == []


def test_pending_admissions_scoped_to_generation_and_members(tmp_path):
    store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
    w0 = _world(tmp_path, 0, [0, 1])
    store.set("elastic.admit.g0.1", b"{}")       # member: already in
    store.set("elastic.admit.g7.5", b"{}")       # another generation
    store.set("elastic.admit.g0.5", b"{}")       # a live non-member
    assert w0.pending_admissions() == [5]
    w0.close()


def test_admit_reregisters_when_sealed_without_it(tmp_path):
    results = {}

    def survivor(r):
        w = _world(tmp_path, r, [0, 1, 2], reform_timeout_s=0.5,
                   initial_world=3)
        g1 = w.reform([1])
        deadline = time.monotonic() + 20.0
        while not g1.pending_admissions():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        g2 = g1.reform([], admit_orig_ranks=g1.pending_admissions())
        results[f"inc{r}"] = (g2.gen, sorted(g2.members))
        g2.collectives.barrier("post_grow")
        g2.close()

    def joiner():
        store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
        w = ElasticWorld.admit(store, 3, timeout_s=30.0,
                               heartbeat_interval_s=0.05,
                               lost_after_s=30.0, stall_after_s=60.0,
                               reform_timeout_s=2.0, initial_world=3)
        results["join"] = (w.gen, sorted(w.members))
        w.collectives.barrier("post_grow")
        w.close()

    errs = []
    tj = threading.Thread(target=lambda: _guarded(joiner, errs))
    tj.start()
    time.sleep(0.3)                  # the g0 registration lands first
    _threads([("inc0", lambda: survivor(0)),
              ("inc2", lambda: survivor(2))])
    tj.join(timeout=60)
    assert not errs, errs
    assert results == {"inc0": (2, [0, 2, 3]), "inc2": (2, [0, 2, 3]),
                       "join": (2, [0, 2, 3])}


def _guarded(fn, errs):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 — asserted by the caller
        errs.append(e)


def test_admit_times_out_when_nobody_grows(tmp_path):
    store = FileStore(str(tmp_path), namespace="r", poll_s=0.01)
    with pytest.raises(TimeoutError, match="admit of rank 7"):
        ElasticWorld.admit(store, 7, timeout_s=0.4, reform_timeout_s=0.2,
                           heartbeat_interval_s=0.05)


def test_heartbeat_names_original_ranks(tmp_path):
    store = FileStore(str(tmp_path), poll_s=0.01)
    h0 = HeartbeatMonitor(store, 0, 2, rank_names=[0, 5],
                          interval_s=0.05, lost_after_s=0.3,
                          stall_after_s=30, watch=False)
    try:
        deadline = time.monotonic() + 5.0
        with pytest.raises(PeerLostError, match=r"\[5\]") as ei:
            while time.monotonic() < deadline:
                h0.check()
                time.sleep(0.05)
        assert ei.value.ranks == [5]
    finally:
        h0.close()


# ---------------------------------------------------------------------------
# fault points and the ownership rebind
# ---------------------------------------------------------------------------

def test_elastic_points_are_the_reference_sets():
    assert faultpoint.ELASTIC_POINTS == jfaultpoint.ELASTIC_POINTS
    assert faultpoint.ADMIT_POINTS == jfaultpoint.ADMIT_POINTS
    for p in (faultpoint.ELASTIC_POINTS + faultpoint.ADMIT_POINTS
              + ("trainer.step.pre", "trainer.pack.pre")):
        assert p in faultpoint.POINTS and p in jfaultpoint.POINTS


def _tiny_trainer():
    from tests.test_torch_resume import _make
    return _make("port", carry=False)


def test_ownership_rebind_window_and_recover_world_redeal(tmp_path):
    """``set_shard_ownership`` passes the rebind window (an armed
    ioerror there raises before the feed manager changes), and
    ``recover_world`` re-deals the feed manager's ShardOwnership to the
    re-formed world, as the JAX package does."""
    from paddlebox_tpu_torch.distributed import ShardOwnership
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    store, tr, box = _tiny_trainer()
    own = ShardOwnership(8, 2, 0)
    faultpoint.arm("elastic.ownership.rebind.pre", action="ioerror")
    try:
        with pytest.raises(faultpoint.FaultInjected):
            tr.set_shard_ownership(own)
    finally:
        faultpoint.disarm()
    assert tr.feed_mgr.ownership is None
    tr.set_shard_ownership(own)
    assert faultpoint.hit_count("elastic.ownership.rebind.pre") >= 1
    w0 = _world(tmp_path / "s", 0, [0, 1], reform_timeout_s=0.3)
    new_world, cursor = tr.recover_world(
        w0, PeerLostError("rank [1] lost", [1]),
        PassCheckpointer(str(tmp_path / "ck")), box)
    try:
        assert (new_world.gen, new_world.members) == (1, [0])
        assert cursor is None                    # nothing saved: fresh
        assert tr.feed_mgr.ownership == own.with_world(1, 0)
        assert tr.peer_check == new_world.check
    finally:
        new_world.close()


# ---------------------------------------------------------------------------
# the 2 -> 1 kill, against the simulated shrink
# ---------------------------------------------------------------------------

STEPS = worker.ELASTIC_STEPS
SPEC = worker.ELASTIC_SPEC
_run = worker.run_world
_info = worker.read_info


def test_kill_one_of_two_shrinks_bit_equal_to_simulated_shrink(tmp_path):
    live = tmp_path / "live"
    # rank 1 dies at its (STEPS + 2)-th dispatch: step 2 of pass 2
    codes, errs = _run(live, SPEC, 2, {
        "PBTPU_FAULTPOINT": "trainer.step.pre",
        "PBTPU_FAULTPOINT_AFTER": str(STEPS + 1),
        "PBTPU_FAULTPOINT_ONLY_RANK": "1"})
    assert codes == [0, 137], (codes, errs)
    info = _info(live, 0)
    assert not info["jax_loaded"]
    assert info["peer_error"]["type"] == "PeerLostError"
    assert info["peer_error"]["ranks"] == [1]
    assert info["peer_error"]["pass"] == 2
    # detection landed mid-pass: the drain committed that step's cursor
    assert info["drain_snapshot"] is not None
    m = info["drain_snapshot"]["mid_steps"]
    assert 0 < m < STEPS
    assert (info["gen"], info["members"]) == (1, [0])
    assert info["elected"] == [1, m] and info["mid_steps"] == m
    assert [e["departed"] for e in info["world_resize"]] == [[1]]
    assert info["world_resize"][0]["to_world"] == 1
    assert info["jitter"]["beats"] > 10
    sim = tmp_path / "sim"
    codes, errs = _run(sim, dict(SPEC, sim={"orig_members": [0, 1],
                                            "dead": [1],
                                            "elected": [1, m]}), 1, {})
    assert codes == [0], (codes, errs)
    with np.load(live / "out_0.npz") as a, np.load(sim / "out_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
