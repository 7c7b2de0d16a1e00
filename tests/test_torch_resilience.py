"""Whole-world crash resilience in the port
(``paddlebox_tpu_torch.distributed.resilience``) against the JAX
package's, the counterparts of tests/test_resilience.py:

- the heartbeat watchdog names a lost peer and a stalled one, and a
  barrier against a dead peer raises its named rank well inside the
  store's timeout;
- the pure election agrees with the JAX package's
  ``elect_resume_cursor`` on hand cases and on random ones;
- ``coordinated_resume`` (threads as ranks, one snapshot root each)
  rolls the world back to the newest cursor every rank holds intact and
  discards the abandoned timeline, and starts the world fresh when any
  rank holds nothing; ``Trainer.resume(collectives=)`` elects over
  snapshots the JAX package wrote and restores them bit-equal to the
  JAX run's live state;
- the mid-pass dense-sync mode rules, on both packages from the same
  inputs: a kstep cadence off ``param_sync_step`` is refused, a kstep
  drain between syncs is skipped with ``drain_snapshot_skipped``, the
  async mode saves the flushed table's params beside its state, and a
  drain snapshot at the abort step resumes there.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu import monitor as jmon
from paddlebox_tpu.distributed import resilience as jres
from paddlebox_tpu.utils.pass_ckpt import PassCheckpointer as JaxCkpt

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.distributed import FileStore, HostCollectives
from paddlebox_tpu_torch.distributed.resilience import (HeartbeatMonitor,
                                                        PeerLostError,
                                                        PeerStalledError,
                                                        coordinated_resume,
                                                        elect_resume_cursor)
from paddlebox_tpu_torch.monitor import context as mon_ctx

from tests.test_torch_resume import (BATCH, STEPS, _ckpt, _dataset, _make,
                                     _state, _train)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_hubs():
    for h in (monitor.hub(), jmon.hub()):
        h.disable()
        h.abort_pass(reason="test boundary")
    yield
    for h in (monitor.hub(), jmon.hub()):
        h.disable()
        h.abort_pass(reason="test boundary")


# ---------------------------------------------------------------------------
# the heartbeat watchdog
# ---------------------------------------------------------------------------

def _monitor(st, rank, world, **kw):
    kw.setdefault("interval_s", 0.05)
    kw.setdefault("watch", False)        # deterministic: scan via check()
    return HeartbeatMonitor(st, rank, world, run_id="r", **kw)


def test_watchdog_detects_lost_peer_with_named_rank(tmp_path):
    st = FileStore(str(tmp_path))
    h0 = _monitor(st, 0, 2, lost_after_s=0.4, stall_after_s=30)
    h1 = _monitor(st, 1, 2, lost_after_s=0.4, stall_after_s=30)
    try:
        time.sleep(0.15)
        h0.check()                       # both alive
        h1.close()                       # rank 1 "dies" (publisher stops)
        deadline = time.monotonic() + 5.0
        with pytest.raises(PeerLostError, match=r"\[1\]") as ei:
            while time.monotonic() < deadline:
                h0.check()
                time.sleep(0.1)
        assert ei.value.ranks == [1]
        with pytest.raises(PeerLostError):   # latched
            h0.check()
        # the publisher measured its own beats
        j = h0.jitter()
        assert j["beats"] > 3 and j["max_gap_s"] >= j["mean_gap_s"] > 0
    finally:
        h0.close()
        h1.close()


def test_watchdog_detects_stalled_peer(tmp_path):
    """A peer whose heartbeat beats but whose pass/step progress froze
    is peer_stalled: the hung-rank signature a liveness check misses."""
    st = FileStore(str(tmp_path))
    sink = monitor.MemorySink()
    monitor.hub().enable(sink)
    handle = mon_ctx.enter_pass(3)
    mon_ctx.set_step(7)
    h0 = _monitor(st, 0, 2, lost_after_s=30, stall_after_s=0.4)
    h1 = _monitor(st, 1, 2, lost_after_s=30, stall_after_s=0.4)
    try:
        time.sleep(0.15)
        h0.check()
        deadline = time.monotonic() + 5.0
        with pytest.raises(PeerStalledError, match=r"\[1\]"):
            while time.monotonic() < deadline:
                h0.check()
                time.sleep(0.1)
        ev = sink.find("peer_stalled")
        assert ev and ev[0]["fields"]["rank"] == 1
    finally:
        h0.close()
        h1.close()
        mon_ctx.exit_pass(handle)


def test_collectives_barrier_raises_named_rank_not_timeout(tmp_path):
    st = FileStore(str(tmp_path), timeout_s=60)
    h0 = _monitor(st, 0, 2, lost_after_s=0.3, stall_after_s=30)
    col = HostCollectives(st, 0, 2, run_id="r", watchdog=h0)
    try:
        time.sleep(0.1)
        t0 = time.monotonic()
        with pytest.raises(PeerLostError, match=r"ranks? \[1\]"):
            col.barrier("never_arrives")
        assert time.monotonic() - t0 < 10.0
    finally:
        h0.close()


def test_heartbeat_reads_the_jax_packages_beats(tmp_path):
    """One store, one run id: a port monitor and a JAX monitor watch
    each other's beats (the payload is the same JSON), and the echoes
    close round trips into ``trace.clock_probe`` events."""
    st = FileStore(str(tmp_path))
    sink = monitor.MemorySink()
    monitor.hub().enable(sink)
    h0 = _monitor(st, 0, 2, lost_after_s=1.5, stall_after_s=30)
    h1 = jres.HeartbeatMonitor(st, 1, 2, run_id="r", interval_s=0.05,
                               lost_after_s=1.5, stall_after_s=30,
                               watch=False)
    try:
        for _ in range(10):
            h0.check()
            h1.check()
            time.sleep(0.1)
        probes = sink.find("trace.clock_probe")
        assert probes and probes[0]["fields"]["peer"] == 1
        assert abs(probes[0]["fields"]["offset_s"]) < 1.0
        h1.close()
        deadline = time.monotonic() + 5.0
        with pytest.raises(PeerLostError, match=r"\[1\]"):
            while time.monotonic() < deadline:
                h0.check()
                time.sleep(0.1)
    finally:
        h0.close()
        h1.close()


# ---------------------------------------------------------------------------
# the election
# ---------------------------------------------------------------------------

def test_elect_resume_cursor_pure_cases():
    cases = [
        [[[1, 0], [2, 0]], [[1, 0], [2, 0]]],
        [[[1, 0], [2, 0]], [[1, 0]]],
        [[[1, 0], [1, 2], [2, 0]], [[1, 0], [1, 2]]],
        [[[1, 0]], []],
        [[], []],
    ]
    want = [(2, 0), (1, 0), (1, 2), None, None]
    rng = np.random.default_rng(0)
    for _ in range(40):                  # random worlds of 1..4 ranks
        cases.append([sorted({(int(p), int(m)) for p, m in
                              rng.integers(0, 4, (rng.integers(0, 6), 2))})
                      for _ in range(rng.integers(1, 5))])
        want.append(jres.elect_resume_cursor([], cases[-1]))
    for c, w in zip(cases, want):
        assert elect_resume_cursor([], c) == w
        assert jres.elect_resume_cursor([], c) == w


def _resume_world(jobs, store_dir, run_id, pkg_resume):
    """Run ``pkg_resume(job, collectives)`` on one thread per rank."""
    st = FileStore(str(store_dir), timeout_s=60)
    results, errs = [None] * len(jobs), []

    def rank(r):
        try:
            col = HostCollectives(st, r, len(jobs), run_id=run_id)
            results[r] = pkg_resume(jobs[r], col)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append((r, e))

    ts = [threading.Thread(target=rank, args=(r,))
          for r in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    return results


def _tear_dense(ckpt, pass_id):
    path = os.path.join(ckpt.snap_dir(pass_id), "dense.npz")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-32])


def test_coordinated_resume_rolls_world_back_to_common_cursor(tmp_path):
    """Two ranks, one root each; rank 1's pass-2 snapshot is torn. The
    election lands both on pass 1, and rank 0's abandoned pass-2
    snapshot is discarded."""
    roots = [str(tmp_path / f"rank{r}") for r in range(2)]
    for r in range(2):
        store, tr, box = _make("port")
        ck = _ckpt("port", roots[r])
        for p in (1, 2):
            _train("port", store, tr, box, ck, p + 2 * r)
    _tear_dense(_ckpt("port", roots[1]), 2)
    assert _ckpt("port", roots[0]).intact_cursors() == [(1, 0), (2, 0)]
    assert _ckpt("port", roots[1]).intact_cursors() == [(1, 0)]
    fresh = [(_make("port", seed=50 + r), _ckpt("port", roots[r]))
             for r in range(2)]
    res = _resume_world(
        fresh, tmp_path / "store", "x",
        lambda job, col: coordinated_resume(job[1], job[0][1], col,
                                            box=job[0][2]))
    for r in range(2):
        assert res[r]["pass_id"] == 1 and res[r]["elected"] == [1, 0]
        assert fresh[r][0][2].pass_id == 1
    assert fresh[0][1].intact_cursors() == [(1, 0)]
    assert not os.path.exists(fresh[0][1].snap_dir(2))


def test_coordinated_resume_fresh_start_when_any_rank_empty(tmp_path):
    store, tr, box = _make("port")
    _train("port", store, tr, box, _ckpt("port", str(tmp_path / "e0")), 1)
    jobs = [(_make("port"), _ckpt("port", str(tmp_path / f"e{r}")))
            for r in range(2)]
    res = _resume_world(
        jobs, tmp_path / "store2", "y",
        lambda job, col: job[0][1].resume(job[1], box=job[0][2],
                                          collectives=col))
    assert res == [None, None]
    assert jobs[0][1].intact_cursors() == []


def test_resume_with_collectives_elects_jax_written_snapshots(tmp_path):
    """The JAX package writes two ranks' snapshots (rank 1's newest
    torn); port trainers elect over them through
    ``Trainer.resume(collectives=)``, land where the JAX package's own
    coordinated resume lands, and restore the JAX run's live pass-1
    state bit-equal."""
    live = []
    roots = [str(tmp_path / f"j{r}") for r in range(2)]
    for r in range(2):
        store, tr, box = _make("jax")
        ck = _ckpt("jax", roots[r])
        _train("jax", store, tr, box, ck, 1 + 2 * r)
        live.append(_state("jax", store, tr, box))
        _train("jax", store, tr, box, ck, 2 + 2 * r)
    _tear_dense(JaxCkpt(roots[1], keep_last_n=3, base_every=2), 2)
    # the JAX package's own election, on a copy of the roots
    import shutil
    jroots = [shutil.copytree(rt, rt + "_jax") for rt in roots]
    jjobs = [(_make("jax"), _ckpt("jax", jroots[r])) for r in range(2)]
    jres_out = _resume_world(
        jjobs, tmp_path / "jstore", "j",
        lambda job, col: job[0][1].resume(job[1], box=job[0][2],
                                          collectives=col))
    jobs = [(_make("port", seed=7 + r), _ckpt("port", roots[r]))
            for r in range(2)]
    res = _resume_world(
        jobs, tmp_path / "pstore", "p",
        lambda job, col: job[0][1].resume(job[1], box=job[0][2],
                                          collectives=col))
    for r in range(2):
        assert res[r]["elected"] == jres_out[r]["elected"] == [1, 0]
        got = _state("port", *jobs[r][0])
        np.testing.assert_array_equal(got["store"][1][
            np.argsort(got["store"][0])],
            live[r]["store"][1][np.argsort(live[r]["store"][0])])
        for k, v in live[r]["dense"].items():
            np.testing.assert_array_equal(got["dense"][k], v, err_msg=k)
        assert got["global_step"] == live[r]["global_step"]


# ---------------------------------------------------------------------------
# the mid-pass dense-sync mode rules, both packages
# ---------------------------------------------------------------------------

def _job(pkg, mode, root, **cfg):
    """``_make``'s job in dense-sync ``mode`` (TrainerConfig fields
    ``cfg``), its params the JAX trainer's initial ones, and a
    checkpointer on ``root``."""
    from tests import test_torch_resume as tr_mod
    if pkg == "jax":
        from paddlebox_tpu.data import DataFeedSchema as JaxSchema
        from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
        from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
        from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
        from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
        from paddlebox_tpu.parallel import make_mesh
        from paddlebox_tpu.train import Trainer as JaxTrainer
        from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig
        store = JaxStore(JaxCfg(dim=tr_mod.EMB_DIM, optimizer="adagrad",
                                learning_rate=0.05))
        schema = JaxSchema.ctr(num_sparse=tr_mod.NUM_SLOTS,
                               num_float=tr_mod.DENSE_DIM,
                               batch_size=BATCH, max_len=4)
        tr = JaxTrainer(JaxDeepFM(num_slots=tr_mod.NUM_SLOTS,
                                  emb_dim=tr_mod.EMB_DIM,
                                  dense_dim=tr_mod.DENSE_DIM,
                                  hidden=tr_mod.HIDDEN),
                        store, schema, make_mesh(1),
                        JaxTrainerConfig(global_batch_size=BATCH,
                                         auc_buckets=tr_mod.AUC_BUCKETS,
                                         dense_sync_mode=mode, **cfg))
        box = JaxBoxPS(store)
    else:
        from paddlebox_tpu_torch import weights
        from paddlebox_tpu_torch.data import DataFeedSchema
        from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                                   HostEmbeddingStore)
        from paddlebox_tpu_torch.fleet import BoxPS
        from paddlebox_tpu_torch.models import DeepFMModel
        from paddlebox_tpu_torch.train import Trainer, TrainerConfig
        store = HostEmbeddingStore(EmbeddingConfig(
            dim=tr_mod.EMB_DIM, optimizer="adagrad", learning_rate=0.05))
        schema = DataFeedSchema.ctr(num_sparse=tr_mod.NUM_SLOTS,
                                    num_float=tr_mod.DENSE_DIM,
                                    batch_size=BATCH, max_len=4)
        tr = Trainer(DeepFMModel(tr_mod.NUM_SLOTS, tr_mod.EMB_DIM,
                                 tr_mod.DENSE_DIM, hidden=tr_mod.HIDDEN),
                     store, schema,
                     TrainerConfig(global_batch_size=BATCH,
                                   auc_buckets=tr_mod.AUC_BUCKETS,
                                   dense_sync_mode=mode, **cfg),
                     device="cpu")
        weights.load_deepfm_params(tr.model, tr_mod._init_params(4))
        box = BoxPS(store)
    box.init_metric("auc", n_buckets=tr_mod.AUC_BUCKETS)
    return store, tr, box, _ckpt(pkg, root)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_midpass_kstep_needs_sync_boundary_cadence(tmp_path, pkg):
    store, tr, box, ck = _job(pkg, "kstep", str(tmp_path / "k"),
                              param_sync_step=2)
    with pytest.raises(NotImplementedError, match="sync boundary"):
        tr.enable_midpass_snapshots(ck, 3, box)
    tr.enable_midpass_snapshots(ck, 4, box)
    assert tr._midpass is not None


def _abort_at(tr, call):
    calls = [0]

    def check():
        calls[0] += 1
        if calls[0] == call:
            raise jres.PeerLostError("rank [1] lost", [1])
    tr.peer_check = check


def _kstep_abort(pkg, root, abort_call):
    store, tr, box, ck = _job(pkg, "kstep", root, param_sync_step=2)
    _abort_at(tr, abort_call)
    box.begin_pass()
    with pytest.raises(jres.PeerLostError):
        tr.train_pass(_dataset(pkg, tr, 1), metrics=box.metrics)
    assert tr.last_pass_steps == abort_call - 1
    snap = tr.drain_and_snapshot(ck, box)
    box.abort_pass(reason="peer lost")
    return snap, ck, (store, tr, box)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_kstep_drain_between_syncs_is_skipped(tmp_path, pkg):
    """A kstep pass aborted after 3 steps (param_sync_step 2) has no
    consistent cursor: the drain commits nothing and says why."""
    mon = monitor if pkg == "port" else jmon
    sink = mon.MemorySink()
    mon.hub().enable(sink)
    snap, ck, _ = _kstep_abort(pkg, str(tmp_path / pkg), 4)
    assert snap is None and ck.intact_cursors() == []
    ev = sink.find("drain_snapshot_skipped")
    assert ev and ev[-1]["fields"] == {
        "reason": "kstep_off_sync_boundary", "steps": 3}


def test_kstep_drain_on_a_sync_boundary_resumes_bit_equal(tmp_path):
    """Aborted after 2 steps, the kstep drain commits the (0, 2) cursor,
    and a fresh job resumes it to the live loop state. (The JAX
    package's drain here raises "Array has been deleted": its dense
    crumb shares the buffers its end-of-pass sync donates; ROADMAP
    queue 3.)"""
    root = str(tmp_path / "k")
    snap, ck, (store, tr, box) = _kstep_abort("port", root, 3)
    assert snap is not None and ck.intact_cursors() == [(0, 2)]
    live = _state("port", store, tr, box)
    store2, tr2, box2, _ = _job("port", "kstep", str(tmp_path / "k2"),
                                param_sync_step=2)
    cursor = tr2.resume(_ckpt("port", root), box=box2)
    assert cursor["mid_steps"] == 2 and tr2.global_step == 2
    got = _state("port", store2, tr2, box2)
    for k, v in live["dense"].items():
        np.testing.assert_array_equal(got["dense"][k], v, err_msg=k)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_midpass_async_saves_the_flushed_tables_params(tmp_path, pkg):
    """Async dense sync: each mid-pass save flushes the host table and
    stores the params the table holds beside its state (the saved
    params flatten to the state's own ``params``); a fresh job resumes
    the cursor and trains the tail."""
    root = str(tmp_path / "am")
    store, tr, box, ck = _job(pkg, "async", root)
    try:
        tr.enable_midpass_snapshots(ck, 2, box)
        box.begin_pass()
        tr.train_pass(_dataset(pkg, tr, 1), metrics=box.metrics)
        box.end_pass(checkpointer=ck, trainer=tr)
        assert [c for c in ck.intact_cursors() if c[1]] == [
            (0, 2), (0, 4), (0, 6)]
        for mid in (2, 4, 6):
            params, state = _saved_async_dense(ck.snap_dir(0, mid))
            assert int(state["steps"].reshape(-1)[0]) > 0
            # the npz orders leaves by tree path, the table by the
            # model's ravel order: the same values, another order
            np.testing.assert_array_equal(np.sort(params),
                                          np.sort(state["params"]))
    finally:
        tr.dense_table.stop()
    store2, tr2, box2, _ = _job(pkg, "async", str(tmp_path / "am2"))
    try:
        cursor = _ckpt(pkg, root).resume(tr2, box=box2, at=(0, 4))
        assert cursor["mid_steps"] == 4
        box2.begin_pass()
        out = tr2.train_pass(_dataset(pkg, tr2, 1), metrics=box2.metrics,
                             skip_steps=4)
        box2.end_pass(trainer=tr2)
        assert out["steps"] == STEPS - 4
    finally:
        tr2.dense_table.stop()


def _saved_async_dense(snap):
    """A snapshot's async dense plane: the saved params flattened in the
    file's key order, and the table state's arrays."""
    with np.load(os.path.join(snap, "dense.npz")) as z:
        files = {k: z[k] for k in z.files}
    state = {k.rsplit("/", 1)[-1].strip("[]'"): v
             for k, v in files.items() if "opt_state" in k}
    params = [v for k, v in files.items() if "opt_state" not in k]
    return np.concatenate([p.reshape(-1) for p in params]), state


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_drain_snapshot_commits_abort_cursor(tmp_path, pkg):
    """A peer failure before step 2 aborts the loop with one step
    trained; the drain commits (0, 1) and a fresh job resumes there."""
    root = str(tmp_path / "drain")
    store, tr, box = _make(pkg)
    ck = _ckpt(pkg, root)
    _abort_at(tr, 2)
    tr.midpass_cursor_extra = {"shuffle_state": {"x": 1}}
    box.begin_pass()
    with pytest.raises(jres.PeerLostError):
        tr.train_pass(_dataset(pkg, tr, 1), metrics=box.metrics)
    assert box.in_pass and tr.last_pass_steps == 1
    live = _state(pkg, store, tr, box)
    assert tr.drain_and_snapshot(ck, box) is not None
    assert ck.intact_cursors() == [(0, 1)]
    box.abort_pass(reason="peer lost")
    assert not box.in_pass
    store2, tr2, box2 = _make(pkg, seed=99)
    cursor = tr2.resume(_ckpt(pkg, root), box=box2)
    assert cursor["mid_steps"] == 1
    assert cursor["shuffle_state"] == {"x": 1}
    assert tr2.global_step == tr.global_step == 1
    got = _state(pkg, store2, tr2, box2)
    for k, v in live["dense"].items():
        np.testing.assert_array_equal(got["dense"][k], v, err_msg=k)


def test_spawned_world_resumes_on_the_common_cursor(tmp_path):
    """Two spawned ranks (tests/torch_resilience_worker.py, no JAX) write
    three checkpointed passes; with rank 1's newest dense plane torn,
    fresh processes resume through ``Trainer.resume(collectives=)``,
    both elect pass 2 and restore their live pass-2 state bit for bit
    (the chip's phase 16 (b) at a narrow width)."""
    from tests import torch_resilience_worker as worker
    spec = {"device": "cpu", "slots": 4, "dense": 3, "hidden": [16],
            "dim": 8, "batch": 32, "max_len": 2, "n_keys": 400,
            "steps": 3}
    writers, restorers = worker.resume_drill(tmp_path, spec)
    assert restorers[0]["intact"] == [[1, 0], [2, 0]]
    assert all(not i["jax_loaded"] for i in writers + restorers)
