"""The port's join/update PhasedTrainer and AucRunner against the JAX
package's:

- ``PhasedTrainer``: three passes (join, update, join) driven by
  ``BoxPS.flip_phase`` on the one-hot and the multi-hot layout, from the
  same dense params and table; each pass's loss (first, last, mean)
  within tests/golden_deepfm.py's tolerance (rtol 2e-4 / atol 2e-5), its
  AUC within 1e-3 (tests/test_torch_zoo.py's eval tolerance), the table
  within rtol 1e-3 / atol 2e-5 and each phase's dense params within
  rtol 2e-3 / atol 2e-5 after the last pass; the phase-gated registry;
- a phase flip reuses the resident working set (0 fresh rows, every key
  reused), both trainers share one FeedPassManager;
- the ``use_cvm`` validation, and ``trainer_for`` / ``eval_pass`` /
  ``flush_sparse``;
- ``AucRunner``: with the same seed both packages draw the same
  candidate pools and ablated columns, and each slot's ablation AUC (and
  ``auc_drop``) agrees within 1e-3.

The JAX side runs on ``make_mesh(1)``; the port on device="cpu". Small
sizes (4 slots, dim 4, hidden 16, batch 32).
"""

import numpy as np
import pytest
import torch

import jax

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.fleet import BoxPS as JaxBoxPS
from paddlebox_tpu.metrics.auc_runner import AucRunner as JaxAucRunner
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import PhasedTrainer as JaxPhasedTrainer
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

from paddlebox_tpu_torch import models
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.fleet.boxps import JOIN_PHASE, UPDATE_PHASE
from paddlebox_tpu_torch.metrics import AucRunner
from paddlebox_tpu_torch.train import PhasedTrainer, Trainer, TrainerConfig
from paddlebox_tpu_torch.utils.checkpoint import flatten_tree

torch.set_num_threads(1)

S, DIM, DENSE, BATCH, STEPS = 4, 4, 1, 32, 4
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/golden_deepfm.py
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
MLP_TOL = dict(rtol=2e-3, atol=2e-5)
AUC_TOL = 1e-3                            # tests/test_torch_zoo.py eval
LAYOUTS = {"onehot": 1, "multihot": 3}


def _records(pkg, schema, n, seed, max_len):
    """``n`` examples over a 200-key pool whose labels follow the keys."""
    cls = SlotRecordBatch if pkg == "port" else JaxRecords
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, 200, replace=False).astype(np.int64)
    w = np.random.default_rng(13).normal(size=200) * 1.5
    lens = [rng.integers(1, max_len + 1, n) for _ in range(S)]
    pick = [rng.integers(0, 200, int(l.sum())) for l in lens]
    vals = [keys[p] for p in pick]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    logit = np.zeros(n)
    for p, o in zip(pick, offs):
        logit += np.add.reduceat(w[p], o[:-1]) if len(p) else 0.0
    label = (rng.random(n) < 1 / (1 + np.exp(-0.6 * logit)))
    floats = [label.astype(np.float32),
              rng.normal(size=n).astype(np.float32)]
    z32 = np.zeros(n, np.int32)
    return cls(schema, n, vals, offs, floats, np.arange(n, dtype=np.uint64),
               np.zeros(n, np.uint64), z32, z32)


def _models(pkg):
    reg = (models if pkg == "port" else jmodels).MODEL_REGISTRY
    return (reg["dnn_ctr"](S, DIM, DENSE, hidden=(16,), use_cvm=True),
            reg["dnn_ctr"](S, DIM, DENSE, hidden=(16,), use_cvm=False))


def _cfgs(pkg):
    cls = TrainerConfig if pkg == "port" else JaxTrainerConfig
    kw = dict(global_batch_size=BATCH, dense_lr=5e-3, auc_buckets=1 << 10)
    return cls(**kw), cls(**kw)


def _phased(max_len):
    """(JAX phased trainer + store + box + dataset, the port's), the
    port's dense params copied from the JAX trainers'."""
    ecfg = dict(dim=DIM, learning_rate=0.15)
    jschema = JaxSchema.ctr(num_sparse=S, num_float=DENSE,
                            batch_size=BATCH, max_len=max_len)
    jstore = JaxStore(JaxCfg(**ecfg))
    jpt = JaxPhasedTrainer(*_models("jax"), jstore, jschema, make_mesh(1),
                           *_cfgs("jax"))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=max_len)
    store = HostEmbeddingStore(EmbeddingConfig(**ecfg))
    pt = PhasedTrainer(*_models("port"), store, schema, *_cfgs("port"),
                       device="cpu")
    pt.join.restore_dense(jax.tree.map(np.asarray, jpt.join.params))
    pt.update.restore_dense(jax.tree.map(np.asarray, jpt.update.params))
    jds, ds = JaxDataset(jschema), SlotDataset(schema)
    n = STEPS * BATCH
    jds.records = _records("jax", jschema, n, 7, max_len)
    ds.records = _records("port", schema, n, 7, max_len)
    return (jpt, jstore, JaxBoxPS(jstore), jds), (pt, store, BoxPS(store),
                                                  ds)


def _leaves(tree):
    return {p: np.asarray(v) for p, v in flatten_tree(tree)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_phased_passes_match_reference(layout):
    (jpt, jstore, jbox, jds), (pt, store, box, ds) = _phased(
        LAYOUTS[layout])
    for b in (jbox, box):
        b.init_metric("auc", method="plain", phase=JOIN_PHASE)
    outs = []
    for _ in range(3):                 # join, update, join
        pair = []
        for b, t, d in ((jbox, jpt, jds), (box, pt, ds)):
            b.begin_pass()
            pair.append(t.train_pass(d, box=b))
            b.end_pass()
            b.flip_phase()
        outs.append(pair)
    assert [o[1]["phase"] for o in outs] == [JOIN_PHASE, UPDATE_PHASE,
                                             JOIN_PHASE]
    for jout, out in outs:
        assert out["steps"] == jout["steps"] == STEPS
        for k in ("loss_first", "loss_last", "loss_mean"):
            np.testing.assert_allclose(out[k], jout[k], err_msg=k,
                                       **LOSS_TOL)
        assert abs(out["auc"] - jout["auc"]) < AUC_TOL
    # both phases trained the ONE table, which agrees with the reference's
    keys = np.unique(np.concatenate(ds.records.sparse_values)).astype(
        np.uint64)
    np.testing.assert_allclose(store.get_rows(keys), jstore.get_rows(keys),
                               **TABLE_TOL)
    for t, jt in ((pt.join, jpt.join), (pt.update, jpt.update)):
        got, want = _leaves(t.eval_params()), _leaves(
            jax.tree.map(np.asarray, jt.params))
        assert sorted(got) == sorted(want)
        for p in want:
            np.testing.assert_allclose(got[p], want[p], err_msg=p,
                                       **MLP_TOL)
    # the join-gated metric saw only the two join passes, as the JAX one
    msg, jmsg = box.get_metric_msg("auc"), jbox.get_metric_msg("auc")
    assert msg["size"] == jmsg["size"] == 2 * STEPS * BATCH
    assert abs(msg["auc"] - jmsg["auc"]) < AUC_TOL
    # eval through either phase's program
    for ph in (JOIN_PHASE, UPDATE_PHASE):
        ev, jev = pt.eval_pass(ds, phase=ph), jpt.eval_pass(jds, phase=ph)
        assert abs(ev["auc"] - jev["auc"]) < AUC_TOL


def test_phase_flip_reuses_resident_working_set():
    _, (pt, store, box, ds) = _phased(1)
    assert pt.update.feed_mgr is pt.join.feed_mgr
    assert pt.trainer_for(JOIN_PHASE) is pt.join
    assert pt.trainer_for(UPDATE_PHASE) is pt.update
    pt.train_pass(ds, phase=JOIN_PHASE)
    pt.train_pass(ds, phase=UPDATE_PHASE)
    m = pt.join.feed_mgr
    assert m.last_fresh_rows == 0            # all rows were resident
    assert m.last_reused_rows == len(ds.unique_keys())
    # the lazily retained rows reach the store on a flush
    before = store.peek_rows(ds.unique_keys())
    assert pt.flush_sparse() > 0
    after = store.peek_rows(ds.unique_keys())
    assert not np.array_equal(before, after)
    with pytest.raises(ValueError, match="need box or explicit phase"):
        pt.train_pass(ds)


def test_phase_models_validated():
    join, upd = _models("port")
    store = HostEmbeddingStore(EmbeddingConfig(dim=DIM))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE)
    with pytest.raises(ValueError, match="use_cvm=True"):
        PhasedTrainer(upd, upd, store, schema, device="cpu")
    with pytest.raises(ValueError, match="use_cvm=False"):
        PhasedTrainer(join, join, store, schema, device="cpu")
    # the join model's CVM columns make it the wider network
    assert join.in_dim == upd.in_dim + 2 * S


# ---------------------------------------------------------------------------
# AucRunner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_auc_runner_matches_reference(layout):
    """Same trained state, same seed: identical pools and ablated
    columns, per-slot AUCs within the eval tolerance."""
    max_len = LAYOUTS[layout]
    ecfg = dict(dim=8, learning_rate=0.15)
    tcfg = dict(global_batch_size=BATCH, dense_lr=5e-3, auc_buckets=1 << 10)
    jschema = JaxSchema.ctr(num_sparse=S, num_float=DENSE,
                            batch_size=BATCH, max_len=max_len)
    jstore = JaxStore(JaxCfg(**ecfg))
    jtr = JaxTrainer(jmodels.DeepFMModel(S, 8, DENSE, hidden=(16,)),
                     jstore, jschema, make_mesh(1), JaxTrainerConfig(**tcfg))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=max_len)
    store = HostEmbeddingStore(EmbeddingConfig(**ecfg))
    tr = Trainer(models.DeepFMModel(S, 8, DENSE, hidden=(16,)), store,
                 schema, TrainerConfig(**tcfg), device="cpu")
    tr.restore_dense(jax.tree.map(np.asarray, jtr.params))
    jds, ds = JaxDataset(jschema), SlotDataset(schema)
    jds.records = _records("jax", jschema, 6 * BATCH, 3, max_len)
    ds.records = _records("port", schema, 6 * BATCH, 3, max_len)
    jtr.train_pass(jds)
    tr.train_pass(ds)
    # the eval set: fresh examples (a padded tail batch included)
    jev, ev = JaxDataset(jschema), SlotDataset(schema)
    jev.records = _records("jax", jschema, 3 * BATCH + 5, 4, max_len)
    ev.records = _records("port", schema, 3 * BATCH + 5, 4, max_len)
    jrun, run = (JaxAucRunner(jtr, pool_size=64, seed=11),
                 AucRunner(tr, pool_size=64, seed=11))
    # pools collected over two passes: the merged re-draw path too
    for r, d in ((jrun, jds), (run, ds)):
        r.collect_candidates(d)
    names = [s.name for s in schema.sparse_slots]
    for n in names:
        np.testing.assert_array_equal(run._pools[n], jrun._pools[n])
    jout, out = jrun.run(jev), run.run(ev)
    # the rng streams stayed in step: the next ablation draws match
    a = run._ablated_dataset(ev, names[0]).records.sparse_values[0]
    b = jrun._ablated_dataset(jev, names[0]).records.sparse_values[0]
    np.testing.assert_array_equal(a, b)
    # an ablated copy leaves the source dataset's columns alone
    np.testing.assert_array_equal(ev.records.sparse_values[0],
                                  jev.records.sparse_values[0])
    assert sorted(out) == sorted(jout) == sorted(names + ["__baseline__"])
    assert out["__baseline__"]["examples"] == 3 * BATCH + 5
    assert abs(out["__baseline__"]["auc"]
               - jout["__baseline__"]["auc"]) < AUC_TOL
    for n in names:
        assert abs(out[n]["auc"] - jout[n]["auc"]) < AUC_TOL, n
        assert abs(out[n]["auc_drop"] - jout[n]["auc_drop"]) < 2 * AUC_TOL
        assert np.isfinite(out[n]["auc_drop"])
