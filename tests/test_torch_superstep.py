"""The port's k-step superstep (``TrainerConfig.steps_per_dispatch``)
against its single steps and against the JAX package's superstep, on the
CPU (tests/test_superstep.py holds the JAX package to the same):

- k=4 equals k=1 bitwise (rows, dense params and optimizer state, metric
  state, every loss, in step order), under each plan the CPU can force;
  a pass of 6 batches is one stacked group and a tail of two single
  steps;
- the group's fixed-shape arrays are stacked into one (k, ...) buffer
  each (one H2D copy a tensor), the ragged push plans stay per batch;
- a resume's ``skip_steps`` or a mid-pass cadence off the dispatch
  boundary is refused with NotImplementedError, and a mid-pass snapshot
  on the boundary resumes bit-exact;
- the port at k=4 against the JAX package at k=4 on ``make_mesh(1)``.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

from tests.test_torch_push_overlap import ENGINES, _assert_bitwise
from tests.test_torch_resume import (AUC_BUCKETS, BATCH, DENSE_DIM, EMB_DIM,
                                     HIDDEN, LOSS_TOL, MLP_TOL, NUM_SLOTS,
                                     STEPS, TABLE_TOL, _ckpt, _dataset,
                                     _init_params, _make, _state, _train)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    for name in ("push_overlap", "push_engine", "push_dedup_premerge",
                 "prefetch_batches"):
        monkeypatch.setattr(flags, name, getattr(flags, name))
    monkeypatch.setattr(jflags, "push_overlap", jflags.push_overlap)


def _job(k, engine="no_plan", max_len=4, overlap="auto", seed=0):
    flags.push_overlap = overlap
    flags.push_engine, flags.push_dedup_premerge = ENGINES[engine]
    store, tr, box = _make("port", max_len, seed=seed)
    tr = Trainer(tr.model, store, tr.schema,
                 TrainerConfig(global_batch_size=BATCH,
                               auc_buckets=AUC_BUCKETS,
                               steps_per_dispatch=k), device="cpu")
    # the JAX trainer's initial params, as _make loads them
    weights.load_deepfm_params(tr.model, _init_params(max_len))
    return store, tr, box


def _two_passes(k, engine="no_plan", max_len=4, overlap="auto"):
    store, tr, box = _job(k, engine, max_len, overlap)
    stats = []
    for p in (1, 2):
        box.begin_pass()
        stats.append(tr.train_pass(_dataset("port", tr, p, max_len),
                                   metrics=box.metrics))
        box.end_pass()
    return store, tr, box, stats


@pytest.mark.parametrize("engine", ["no_plan", "dedup_plan", "block_plan"])
@pytest.mark.parametrize("overlap", ["on", "off"])
def test_k4_equals_k1_bitwise(engine, overlap):
    """A 6-step pass at k=4 (a group of 4, a tail of 2 singles) against
    k=1 with push overlap on or off: every plane and loss bit-equal."""
    k4 = _two_passes(4, engine)
    k1 = _two_passes(1, engine, overlap=overlap)
    assert not k4[1].push_overlap
    for a, b in zip(k4[3], k1[3]):
        for key in ("loss_first", "loss_last", "loss_mean", "auc",
                    "steps"):
            assert a[key] == b[key], key
    _assert_bitwise(_state("port", *k4[:3]), _state("port", *k1[:3]))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_groups_and_tail(prefetch):
    """The pack iterator yields one stacked group of 4 and the tail of 2
    as single batches, in dataset order, with or without the pack
    thread."""
    flags.prefetch_batches = prefetch
    store, tr, box = _job(4)
    ds = _dataset("port", tr, 1)
    ws = tr.feed_mgr.begin_pass(ds.unique_keys())
    items = list(tr._pack_iter(ds, ws, BATCH, group=4))
    assert [(len(pbs), stacked) for pbs, _, stacked in items] == [
        (4, True), (1, False), (1, False)]
    idx, mask, dense, labels, plans, extras = items[0][1]
    assert idx.shape == (4, BATCH, tr.layout.total_len)
    assert mask.shape == idx.shape and labels.shape == (4, BATCH)
    assert dense.shape == (4, BATCH, DENSE_DIM)
    assert isinstance(plans, list) and len(plans) == 4
    # each slice is the batch a single step would have packed
    want = [tr.stage(tr._pack_host(ws, pb))
            for pb in ds.batches(BATCH)]
    for i in range(4):
        got = tr._step_args(items[0][1], True, i)
        for a, b in zip(got[:4], want[i][:4]):
            assert torch.equal(a, b)
    for j, (_, staged, _) in enumerate(items[1:]):
        for a, b in zip(staged[:4], want[4 + j][:4]):
            assert torch.equal(a, b)


def test_stack_host_per_batch_plans_and_extras():
    """Stacked extras must be batch-leading; the plans stay a list of the
    k batches' own (ragged) plans."""
    store, tr, box = _job(2, engine="dedup_plan")
    ds = _dataset("port", tr, 1)
    ws = tr.feed_mgr.begin_pass(ds.unique_keys())
    pbs = list(ds.batches(BATCH))[:2]
    hosts = [tr._pack_host(ws, pb, pin=False) for pb in pbs]
    out = tr._stack_host(hosts)
    assert [len(p.uniq) for p in out[4]] == [len(h[4].uniq) for h in hosts]
    ok = [(*h[:5], (torch.arange(BATCH),)) for h in hosts]
    assert tr._stack_host(ok)[5][0].shape == (2, BATCH)
    bad = [(*h[:5], (torch.tensor(1.0),)) for h in hosts]
    with pytest.raises(ValueError, match="batch-leading"):
        tr._stack_host(bad)


def test_refusals_off_the_dispatch_boundary(tmp_path):
    store, tr, box = _job(2)
    ck = _ckpt("port", str(tmp_path / "r"))
    with pytest.raises(NotImplementedError, match="dispatch boundary"):
        tr.enable_midpass_snapshots(ck, 3, box)
    tr.enable_midpass_snapshots(ck, 4, box)
    assert tr._midpass is not None
    tr.enable_midpass_snapshots(ck, 0, box)
    assert tr._midpass is None
    with pytest.raises(NotImplementedError, match="dispatch boundary"):
        tr.train_pass(_dataset("port", tr, 1), skip_steps=3)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        _job(0)


def test_midpass_resume_at_a_dispatch_boundary_bit_exact(tmp_path):
    """k=2 with snapshots every 2 steps: a fresh job restored at
    (pass 1, mid 2) finishes pass 2 bit-equal to the uninterrupted
    run."""
    root = str(tmp_path / "ss")
    store, tr, box = _job(2)
    ck = _ckpt("port", root)
    tr.enable_midpass_snapshots(ck, 2, box, metrics=box.metrics)
    for p in (1, 2):
        _train("port", store, tr, box, ck, p)
    want = _state("port", store, tr, box)
    assert [s["mid_steps"] for s in tr.midpass_saves] == [2, 4, 6]
    assert (1, 2) in ck.intact_cursors()
    store2, tr2, box2 = _job(2, seed=3)
    ck2 = _ckpt("port", root)
    cursor = ck2.resume(tr2, box=box2, at=(1, 2))
    assert (cursor["pass_id"], cursor["mid_steps"]) == (1, 2)
    _train("port", store2, tr2, box2, ck2, 2,
           skip_steps=cursor["mid_steps"])
    _assert_bitwise(_state("port", store2, tr2, box2), want)


def _jax_job(k, max_len):
    store = JaxStore(JaxCfg(dim=EMB_DIM, optimizer="adagrad",
                            learning_rate=0.05))
    schema = JaxSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                           batch_size=BATCH, max_len=max_len)
    _, ref, _ = _make("jax", max_len)        # the same initial params
    tr = JaxTrainer(JaxDeepFM(num_slots=NUM_SLOTS, emb_dim=EMB_DIM,
                              dense_dim=DENSE_DIM, hidden=HIDDEN),
                    store, schema, make_mesh(1),
                    JaxTrainerConfig(global_batch_size=BATCH,
                                     auc_buckets=AUC_BUCKETS,
                                     steps_per_dispatch=k))
    tr.params, tr.opt_state = ref.params, ref.opt_state
    box = JaxBoxPS(store)
    box.init_metric("auc", n_buckets=AUC_BUCKETS)
    return store, tr, box


@pytest.mark.parametrize("max_len", [1, 4])
def test_port_matches_jax_at_k4(max_len):
    got = {}
    for pkg in ("jax", "port"):
        store, tr, box = (_jax_job(4, max_len) if pkg == "jax"
                          else _job(4, max_len=max_len))
        stats = []
        for p in (1, 2):
            box.begin_pass()
            stats.append(tr.train_pass(_dataset(pkg, tr, p, max_len),
                                       metrics=box.metrics))
            box.end_pass()
        assert [s["steps"] for s in stats] == [STEPS, STEPS]
        got[pkg] = (_state(pkg, store, tr, box), stats)
    (js, jstats), (ps, pstats) = got["jax"], got["port"]
    for a, b in zip(pstats, jstats):
        for key in ("loss_first", "loss_last", "loss_mean"):
            np.testing.assert_allclose(a[key], b[key], **LOSS_TOL)
    pk, jk = np.argsort(ps["store"][0]), np.argsort(js["store"][0])
    np.testing.assert_array_equal(ps["store"][0][pk], js["store"][0][jk])
    np.testing.assert_allclose(ps["store"][1][pk], js["store"][1][jk],
                               **TABLE_TOL)
    for path, v in js["dense"].items():
        if path.startswith("params"):
            np.testing.assert_allclose(ps["dense"][path], v, **MLP_TOL,
                                       err_msg=path)
