"""The port's deferred sparse push (``flags.push_overlap``) against its
inline push and against the JAX package's deferred push, on the CPU.

A step with overlap on returns its push operands to the trainer's
``PushOperandStager`` instead of pushing; the apply launches just
before the next step and at every boundary that reads the table. The
contract, as tests/test_push_overlap.py holds the JAX package to it:

- overlap on equals overlap off bitwise: store rows, dense params and
  optimizer state, metric state and the loss trajectory, under every
  push engine the CPU can force (no plan, the dedup plan, the binned
  block plan, the dedup plan with lane windows) and on a quantized
  table;
- the port with overlap on matches the JAX package with overlap on at
  ``make_mesh(1)`` (tests/golden_deepfm.py's tolerances);
- a pending apply lands before ``eval_pass``, a checkpoint save,
  ``get_rows``, a mid-pass snapshot and ``drain_and_snapshot``;
- at most one apply is ever pending (``live() <= 2``), ``flush_push``
  refuses while a pass is open, and the "auto" rules are the
  reference's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.utils import faultpoint as jfaultpoint

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding.working_set import PushOperandStager
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils import faultpoint

from tests.test_torch_resume import (LOSS_TOL, MLP_TOL, STEPS, TABLE_TOL,
                                     _ckpt, _dataset, _make, _state,
                                     _train)

torch.set_num_threads(1)

# (push_engine, push_dedup_premerge): the plan each forced engine packs
ENGINES = {"no_plan": ("auto", "auto"),
           "dedup_plan": ("scatter_accumulate", "auto"),
           "block_plan": ("binned_kernel", "off"),
           "dedup_windows": ("binned_kernel", "on")}


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    monkeypatch.setattr(jflags, "push_overlap", jflags.push_overlap)
    for name in ("push_overlap", "push_engine", "push_dedup_premerge"):
        monkeypatch.setattr(flags, name, getattr(flags, name))
    yield
    faultpoint.disarm()
    jfaultpoint.disarm()


def _job(overlap, engine="no_plan", max_len=4, storage=None, **cfg):
    flags.push_overlap = overlap
    flags.push_engine, flags.push_dedup_premerge = ENGINES[engine]
    store, tr, box = _make("port", max_len)
    if storage is not None or cfg:
        kw = {"storage": storage} if storage else {}
        if kw:
            from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                                       HostEmbeddingStore)
            from paddlebox_tpu_torch.fleet import BoxPS
            store = HostEmbeddingStore(EmbeddingConfig(
                dim=store.cfg.dim, optimizer="adagrad", learning_rate=0.05,
                **kw))
            box = BoxPS(store)
            box.init_metric("auc", n_buckets=tr.cfg.auc_buckets)
        tr = Trainer(tr.model, store, tr.schema,
                     TrainerConfig(**{**tr.cfg.__dict__, **cfg}),
                     device="cpu")
    return store, tr, box


def _two_passes(overlap, engine="no_plan", max_len=4, storage=None,
                root=None):
    store, tr, box = _job(overlap, engine, max_len, storage)
    ckpt = _ckpt("port", root) if root else None
    stats = []
    for p in (1, 2):
        ds = _dataset("port", tr, p, max_len)
        box.begin_pass()
        stats.append(tr.train_pass(ds, metrics=box.metrics))
        box.end_pass(checkpointer=ckpt, trainer=tr if ckpt else None,
                     dataset=ds if ckpt else None)
    return store, tr, box, stats


def _assert_bitwise(got, want):
    gk, wk = np.argsort(got["store"][0]), np.argsort(want["store"][0])
    assert got["store"][0][gk].tobytes() == want["store"][0][wk].tobytes()
    assert got["store"][1][gk].tobytes() == want["store"][1][wk].tobytes()
    assert sorted(got["dense"]) == sorted(want["dense"])
    for k, v in want["dense"].items():
        assert got["dense"][k].tobytes() == v.tobytes(), k
    for k, v in want["metrics"].items():
        assert got["metrics"][k].tobytes() == v.tobytes(), k
    assert got["global_step"] == want["global_step"]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_overlap_on_equals_off_bitwise(engine):
    """The apply replays the inline push on the same tensors: rows, dense
    state, metrics and every loss are bit-equal, with one apply a step,
    none pending after the pass."""
    on = _two_passes("on", engine)
    off = _two_passes("off", engine)
    assert on[1].push_overlap and not off[1].push_overlap
    for a, b in zip(on[3], off[3]):
        for k in ("loss_first", "loss_last", "loss_mean", "auc", "steps"):
            assert a[k] == b[k], k
    _assert_bitwise(_state("port", *on[:3]), _state("port", *off[:3]))
    assert on[1].push_applies == 2 * STEPS and off[1].push_applies == 0
    assert on[1]._push_stager.pending() == 0
    assert on[1]._push_stager.live() == 0
    # the forced engine's plan really rode along
    tr = on[1]
    ws = tr.last_ws
    pb = next(iter(_dataset("port", tr, 2).batches(
        tr.cfg.global_batch_size)))
    plan = tr.host_plan(ws, ws.translate(pb.ids, pb.mask))
    want = {"no_plan": type(None), "dedup_plan": "DedupPlan",
            "block_plan": "BlockPlan", "dedup_windows": "DedupPlan"}[engine]
    assert (plan is None if want is type(None)
            else type(plan).__name__ == want)
    if engine == "dedup_windows":
        assert plan.rstart is not None


@pytest.mark.parametrize("storage", ["int8", "int16"])
def test_overlap_on_equals_off_quantized(storage):
    """A quantized table's deferred apply runs the same accumulator and
    requant pass."""
    on = _two_passes("on", "block_plan", max_len=1, storage=storage)
    off = _two_passes("off", "block_plan", max_len=1, storage=storage)
    for a, b in zip(on[3], off[3]):
        assert a["loss_mean"] == b["loss_mean"]
    _assert_bitwise(_state("port", *on[:3]), _state("port", *off[:3]))


@pytest.mark.parametrize("max_len", [1, 4])
def test_port_matches_jax_with_overlap_on(max_len):
    """Both packages with their deferred push on, the JAX one at
    make_mesh(1): losses, rows and dense params within the golden
    tolerances, and one apply a step in each."""
    jflags.push_overlap = "on"
    flags.push_overlap = "on"
    got = {}
    for pkg in ("jax", "port"):
        store, tr, box = _make(pkg, max_len)
        assert tr.push_overlap
        stats = []
        for p in (1, 2):
            box.begin_pass()
            stats.append(tr.train_pass(_dataset(pkg, tr, p, max_len),
                                       metrics=box.metrics))
            box.end_pass()
        assert tr.push_applies == 2 * STEPS
        got[pkg] = (_state(pkg, store, tr, box), stats)
    (js, jstats), (ps, pstats) = got["jax"], got["port"]
    for a, b in zip(pstats, jstats):
        np.testing.assert_allclose(a["loss_mean"], b["loss_mean"],
                                   **LOSS_TOL)
        np.testing.assert_allclose(a["loss_last"], b["loss_last"],
                                   **LOSS_TOL)
    pk, jk = np.argsort(ps["store"][0]), np.argsort(js["store"][0])
    np.testing.assert_array_equal(ps["store"][0][pk], js["store"][0][jk])
    np.testing.assert_allclose(ps["store"][1][pk], js["store"][1][jk],
                               **TABLE_TOL)
    for path, v in js["dense"].items():
        if path.startswith("params"):
            np.testing.assert_allclose(ps["dense"][path], v, **MLP_TOL,
                                       err_msg=path)


def test_flush_on_eval_get_rows_and_save(tmp_path):
    """eval_pass, get_rows and a checkpoint save all see the applied
    table: the same answers and the same snapshot as overlap off."""
    res = {}
    for overlap in ("on", "off"):
        root = str(tmp_path / overlap)
        store, tr, box, _ = _two_passes(overlap, root=root)
        ev = tr.eval_pass(_dataset("port", tr, 3))
        keys = np.sort(tr.last_ws.sorted_keys)
        rows = store.get_rows(keys)
        _, tr2, box2 = _make("port", seed=9)
        fresh = _make("port", seed=9)[0]
        tr2 = Trainer(tr2.model, fresh, tr2.schema, tr2.cfg, device="cpu")
        cursor = tr2.resume(_ckpt("port", root), box=box2)
        res[overlap] = (ev, rows, _state("port", fresh, tr2, box2), cursor)
    assert res["on"][0]["auc"] == res["off"][0]["auc"]
    assert res["on"][1].tobytes() == res["off"][1].tobytes()
    _assert_bitwise(res["on"][2], res["off"][2])
    assert res["on"][3]["pass_id"] == 2


def test_eval_lands_a_pending_apply():
    """A pending apply (a stager holding a step's operands outside a
    pass) lands at eval_pass's entry and is counted once."""
    store, tr, box, _ = _two_passes("on")
    ds = _dataset("port", tr, 1)
    ws = tr.feed_mgr.begin_pass(ds.unique_keys())
    tr._overlap_ws = ws
    pb = next(iter(ds.batches(tr.cfg.global_batch_size)))
    staged = tr.stage(tr._pack_host(ws, pb))
    tr.train_step(ws.table, *staged, defer=True)
    tr.feed_mgr.end_pass(ws, ws.table)
    assert tr._push_stager.pending() == 1
    n = tr.push_applies
    tr.eval_pass(ds)
    assert tr._push_stager.pending() == 0 and tr.push_applies == n + 1
    assert tr.flush_push() == 0


def _mid_snapshot_states(overlap, root, tmp_path):
    """One pass with mid-pass snapshots every 2 steps; each snapshot
    restored into a fresh job."""
    store, tr, box = _job(overlap)
    ckpt = _ckpt("port", root)
    tr.enable_midpass_snapshots(ckpt, 2, box, metrics=box.metrics)
    _train("port", store, tr, box, ckpt, 1)
    out = {}
    for cur in ckpt.intact_cursors():
        if not cur[1]:
            continue
        copy = str(tmp_path / f"{overlap}-{cur[1]}")
        shutil.copytree(root, copy)
        s2, t2, b2 = _make("port", seed=4)
        _ckpt("port", copy).resume(t2, box=b2, at=cur)
        out[cur] = _state("port", s2, t2, b2)
    return out


def test_flush_before_midpass_snapshot(tmp_path):
    on = _mid_snapshot_states("on", str(tmp_path / "on"), tmp_path)
    off = _mid_snapshot_states("off", str(tmp_path / "off"), tmp_path)
    assert sorted(on) == sorted(off) == [(0, 2), (0, 4), (0, 6)]
    for cur in on:
        _assert_bitwise(on[cur], off[cur])


class _StopAfter:
    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def unique_keys(self):
        return self.ds.unique_keys()

    def batches(self, batch_size=None, drop_last=True):
        for i, pb in enumerate(self.ds.batches(batch_size, drop_last)):
            if i == self.n:
                raise RuntimeError(f"input stream broke at batch {i}")
            yield pb


def test_flush_before_drain_and_snapshot(tmp_path):
    """A pass that raised lands its last step's apply in the loop's
    finally; the drain snapshot then equals overlap off's."""
    res = {}
    for overlap in ("on", "off"):
        store, tr, box = _job(overlap)
        ckpt = _ckpt("port", str(tmp_path / overlap))
        box.begin_pass()
        with pytest.raises(RuntimeError, match="input stream broke"):
            tr.train_pass(_StopAfter(_dataset("port", tr, 1), 3),
                          metrics=box.metrics)
        assert tr._push_stager.pending() == 0
        snap = tr.drain_and_snapshot(ckpt, box)
        box.abort_pass("test")
        assert os.path.basename(snap) == "pass-00000.mid00003"
        s2, t2, b2 = _make("port", seed=4)
        cursor = _ckpt("port", str(tmp_path / overlap)).resume(t2, box=b2)
        assert cursor["mid_steps"] == 3
        res[overlap] = (_state("port", s2, t2, b2), tr.push_applies)
    _assert_bitwise(res["on"][0], res["off"][0])
    assert res["on"][1] == 3 and res["off"][1] == 0


def test_staleness_bound_and_live_slots():
    st = PushOperandStager()
    st.put("step0")
    with pytest.raises(RuntimeError, match="staleness"):
        st.put("step1")
    assert st.take() == "step0"
    assert st.live() == 1
    st.put("step1")
    assert st.live() == 2
    st.take()
    st.clear()
    assert st.live() == 0 and st.take() is None


def test_live_slots_at_most_two_during_a_pass():
    store, tr, box = _job("on")
    seen = []
    inner = tr._dispatch_pending_apply

    def spy(table):
        seen.append((tr._push_stager.live(), tr._push_stager.pending()))
        inner(table)

    tr._dispatch_pending_apply = spy
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    box.end_pass()
    # the first step finds nothing pending; each later call one
    assert seen[0] == (0, 0)
    assert all(live <= 2 and pending == 1 for live, pending in seen[1:])
    assert len(seen) == STEPS + 1          # before each step + pass end


def test_flush_push_refuses_inside_a_pass():
    store, tr, box = _job("on")
    ds = _dataset("port", tr, 1)
    ws = tr.feed_mgr.begin_pass(ds.unique_keys())
    tr._overlap_ws = ws
    tr._push_stager.put("operands")
    tr.feed_mgr.pass_opened()
    try:
        with pytest.raises(RuntimeError, match="pass is open"):
            tr.flush_push()
    finally:
        tr.feed_mgr.pass_closed()
        tr._push_stager.clear()


def test_push_apply_fault_point_and_counter():
    store, tr, box = _job("on")
    before = monitor.STATS.get("trainer.push_applies")
    # hit counts are per process and cumulative: an earlier test in this
    # worker may have trained while another point was armed
    hits = faultpoint.hit_count("trainer.push_apply.pre")
    faultpoint.arm("trainer.push_apply.pre", action="ioerror", after=2)
    box.begin_pass()
    with pytest.raises(faultpoint.FaultInjected):
        tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    box.abort_pass("test")
    assert faultpoint.hit_count("trainer.push_apply.pre") == hits + 3
    assert tr.push_applies == 2
    assert monitor.STATS.get("trainer.push_applies") == before + 2


def test_auto_selection_rules():
    """auto = on at steps_per_dispatch 1 and off for a superstep; "on"
    with a superstep raises; "off" is off; anything else is refused."""
    for overlap, k, want in (("auto", 1, True), ("auto", 4, False),
                             ("on", 1, True), ("off", 1, False),
                             ("off", 4, False)):
        _, tr, _ = _job(overlap, steps_per_dispatch=k)
        assert tr.push_overlap is want, (overlap, k)
    with pytest.raises(ValueError, match="push_overlap"):
        _job("on", steps_per_dispatch=4)
    with pytest.raises(ValueError, match="push_overlap"):
        _job("sometimes")
