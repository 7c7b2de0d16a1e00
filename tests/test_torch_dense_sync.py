"""Dense sync modes, against tests/test_dense_sync.py and the JAX package.

- ``AsyncDenseTable``: the update math, queued-grad merging, per-range
  learning rates and the stop-mid-merge flush, each held to the JAX
  table on the same pushes (the same NumPy arithmetic: equal arrays).
- kstep and async through ``Trainer`` on one rank: kstep with K=1 and
  SGD equals allreduce; kstep K=2 matches the JAX Trainer's kstep on
  ``make_mesh(1)`` (loss ``rel=2e-5``); async trains, applies every
  pushed grad, and round-trips its state through ``dense_state`` /
  ``restore_dense``.
- ``Trainer(mesh=make_mesh(1))`` — a world of one over gloo — is bit for
  bit the mesh-less trainer on both layouts (the collectives of one rank
  return their input's bits). kstep at world 2 runs in
  tests/test_torch_multirank_train.py.
"""

import numpy as np
import pytest
import torch

import torch_multirank_common as common
from paddlebox_tpu.parallel import AsyncDenseTable as JaxAsyncTable

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data import slot_record
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.parallel import AsyncDenseTable, make_mesh
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# AsyncDenseTable
# ---------------------------------------------------------------------------

def _drive(cls, p0, grads, **kw):
    tbl = cls(p0, **kw)
    tbl.start()
    for g in grads:
        tbl.push(g)
        tbl.flush()
    tbl.stop()
    return tbl


def test_async_table_update_math_matches_jax():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=64).astype(np.float32)
    grads = [rng.normal(size=64).astype(np.float32) for _ in range(3)]
    kw = dict(lr=0.1, betas=(0.9, 0.99))
    tbl = _drive(AsyncDenseTable, p0, grads, **kw)
    jtbl = _drive(JaxAsyncTable, p0, grads, **kw)
    np.testing.assert_array_equal(tbl.pull(), jtbl.pull())
    assert tbl.steps_applied == jtbl.steps_applied == 3
    assert tbl.grads_merged == 3
    b1, b2 = kw["betas"]
    want, m1, m2 = p0.copy(), 0.0, 0.0
    for g in grads:
        m1 = b1 * m1 + (1 - b1) * g
        m2 = b2 * m2 + (1 - b2) * g * g
        want = want - 0.1 * m1 / (np.sqrt(m2) + 1e-8)
    np.testing.assert_allclose(tbl.pull(), want, rtol=1e-5)


def test_async_table_merges_queued_grads():
    p0 = np.zeros(8, np.float32)
    outs = []
    for cls in (AsyncDenseTable, JaxAsyncTable):
        tbl = cls(p0, lr=0.1, merge_limit=4)
        for _ in range(4):      # queued before the thread starts: one apply
            tbl.push(np.ones(8, np.float32))
        tbl.start()
        tbl.flush()
        tbl.stop()
        assert tbl.steps_applied == 1 and tbl.grads_merged == 4
        outs.append(tbl.pull())
    np.testing.assert_array_equal(*outs)


def test_async_table_lr_map():
    p0 = np.zeros(4, np.float32)
    kw = dict(lr=1.0, betas=(0.0, 0.0), lr_map=[(slice(2, 4), 0.5)])
    got = _drive(AsyncDenseTable, p0, [np.ones(4, np.float32)], **kw).pull()
    want = _drive(JaxAsyncTable, p0, [np.ones(4, np.float32)], **kw).pull()
    np.testing.assert_array_equal(got, want)
    assert abs(got[0] / got[2] - 2.0) < 1e-5


def test_async_table_stop_mid_merge_then_flush():
    tbl = AsyncDenseTable(np.zeros(4, np.float32), lr=0.1, merge_limit=4)
    tbl.push(np.ones(4, np.float32))
    tbl.push(np.ones(4, np.float32))
    tbl._queue.put(None)
    tbl._run()
    tbl.flush()
    assert tbl.grads_merged == 2


# ---------------------------------------------------------------------------
# through the Trainer
# ---------------------------------------------------------------------------

def _port(max_len=1, mesh=None, **cfg_kw):
    schema = DataFeedSchema.ctr(num_sparse=common.NUM_SLOTS,
                                num_float=common.DENSE_DIM,
                                batch_size=common.BATCH, max_len=max_len)
    ds = SlotDataset(schema)
    ds.records = common.make_records(slot_record, schema,
                                     common.dataset_arrays(max_len))
    store = HostEmbeddingStore(EmbeddingConfig(
        dim=common.DIM, learning_rate=common.SPARSE_LR))
    cfg_kw.setdefault("dense_lr", common.DENSE_LR)
    tr = Trainer(DeepFMModel(common.NUM_SLOTS, common.DIM, common.DENSE_DIM,
                             hidden=common.HIDDEN),
                 store, schema,
                 TrainerConfig(global_batch_size=common.BATCH,
                               auc_buckets=common.AUC_BUCKETS, **cfg_kw),
                 seed=3, device=None if mesh is not None else "cpu",
                 mesh=mesh)
    return tr, ds, store


def _dense(tr):
    return [p.detach().clone() for p in tr.params]


def test_kstep_k1_sgd_matches_allreduce():
    tr_a, ds, _ = _port(dense_optimizer="sgd", dense_lr=0.1)
    tr_k, ds_k, _ = _port(dense_optimizer="sgd", dense_lr=0.1,
                          dense_sync_mode="kstep", param_sync_step=1)
    m_a, m_k = tr_a.train_pass(ds), tr_k.train_pass(ds_k)
    for a, b in zip(_dense(tr_a), _dense(tr_k)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert m_a["loss_mean"] == m_k["loss_mean"]
    assert not tr_k.push_overlap          # kstep pushes inline


def test_kstep_matches_jax_kstep():
    """kstep K=2 on one rank against the JAX Trainer's kstep on
    make_mesh(1), from the same initial dense parameters."""
    import jax

    from paddlebox_tpu.data import DataFeedSchema as JaxSchema
    from paddlebox_tpu.data import SlotDataset as JaxDataset
    from paddlebox_tpu.data import slot_record as jax_slot_record
    from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
    from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
    from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
    from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
    from paddlebox_tpu.train import Trainer as JaxTrainer
    from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

    from paddlebox_tpu_torch import weights

    schema = JaxSchema.ctr(num_sparse=common.NUM_SLOTS,
                           num_float=common.DENSE_DIM,
                           batch_size=common.BATCH, max_len=1)
    jds = JaxDataset(schema)
    jds.records = common.make_records(jax_slot_record, schema,
                                      common.dataset_arrays(1))
    jstore = JaxStore(JaxCfg(dim=common.DIM,
                             learning_rate=common.SPARSE_LR))
    jtr = JaxTrainer(JaxDeepFM(num_slots=common.NUM_SLOTS,
                               emb_dim=common.DIM,
                               dense_dim=common.DENSE_DIM,
                               hidden=common.HIDDEN),
                     jstore, schema, jax_make_mesh(1),
                     JaxTrainerConfig(global_batch_size=common.BATCH,
                                      dense_lr=common.DENSE_LR,
                                      auc_buckets=common.AUC_BUCKETS,
                                      dense_sync_mode="kstep",
                                      param_sync_step=2))
    tr, ds, store = _port(dense_sync_mode="kstep", param_sync_step=2)
    weights.load_model_params(tr.model, jax.tree.map(np.asarray,
                                                     jtr.eval_params()))
    for _ in range(common.PASSES):
        got, want = tr.train_pass(ds), jtr.train_pass(jds)
        for k in ("loss_first", "loss_mean"):
            assert got[k] == pytest.approx(want[k], rel=common.LOSS_REL)
        assert got["auc"] == pytest.approx(want["auc"], abs=common.AUC_ABS)
    tr.flush_sparse()
    jtr.flush_sparse()
    keys = np.sort(store.keys())
    np.testing.assert_allclose(store.get_rows(keys), jstore.get_rows(keys),
                               **common.TABLE_TOL)


def test_async_mode_trains_and_round_trips():
    tr, ds, _ = _port(dense_sync_mode="async")
    p0 = _dense(tr)
    m = tr.train_pass(ds)
    steps = common.N_EXAMPLES // common.BATCH
    assert np.isfinite(m["loss_mean"]) and m["steps"] == steps
    assert tr.dense_table.grads_merged == steps
    assert tr.dense_table.steps_applied > 0
    assert max(float((a - b).abs().max())
               for a, b in zip(_dense(tr), p0)) > 0
    # the model holds the table's parameters after the pass
    np.testing.assert_array_equal(
        np.concatenate([p.detach().numpy().reshape(-1) for p in tr.params]),
        tr.dense_table.pull())
    state = tr.dense_state()
    assert state["opt_state"]["steps"][0] > 0
    tr.dense_table.stop()
    tr2, ds2, _ = _port(dense_sync_mode="async")
    tr2.restore_dense(state["params"], state["opt_state"])
    np.testing.assert_array_equal(tr2.dense_table.pull(),
                                  tr.dense_table.pull())
    np.testing.assert_array_equal(tr2.dense_table._mom1,
                                  tr.dense_table._mom1)
    tr2.train_pass(ds2)                 # training continues
    tr2.dense_table.stop()


def test_kstep_restore_from_collapsed():
    from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
    tr, ds, _ = _port(dense_sync_mode="kstep", param_sync_step=2)
    tr.train_pass(ds)
    params = tr.eval_params()
    tr2, ds2, _ = _port(dense_sync_mode="kstep", param_sync_step=2)
    tr2.restore_dense(params)
    for a, b in zip(flatten_tree(tr2.eval_params()),
                    flatten_tree(params)):
        np.testing.assert_array_equal(a[1], b[1])
    tr2.train_pass(ds2)


def test_param_sync_step_and_mode_validated(monkeypatch):
    with pytest.raises(ValueError, match="param_sync_step"):
        _port(dense_sync_mode="kstep", param_sync_step=0)
    with pytest.raises(ValueError, match="ring"):
        _port(dense_sync_mode="ring")
    monkeypatch.setattr(flags, "push_overlap", "on")
    with pytest.raises(ValueError, match="allreduce"):
        _port(dense_sync_mode="kstep")


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1, device="cpu", backend="gloo")


@pytest.mark.parametrize("max_len", [1, 2])
@pytest.mark.parametrize("mode", ["allreduce", "kstep"])
def test_mesh_world1_bit_equal_to_meshless(mesh1, max_len, mode):
    assert mesh1.world == 1 and mesh1.backend == "gloo"
    kw = dict(dense_sync_mode=mode, param_sync_step=2)
    tr_m, ds_m, st_m = _port(max_len, mesh=mesh1, **kw)
    tr_p, ds_p, st_p = _port(max_len, **kw)
    assert tr_m.table_layout == "single" and tr_m.n_shards == 1
    for _ in range(common.PASSES):
        a, b = tr_m.train_pass(ds_m), tr_p.train_pass(ds_p)
        for k in ("loss_first", "loss_mean", "auc", "steps"):
            assert a[k] == b[k], k
    ea, eb = tr_m.eval_pass(ds_m), tr_p.eval_pass(ds_p)
    assert ea["auc"] == eb["auc"]
    tr_m.flush_sparse()
    tr_p.flush_sparse()
    keys = np.sort(st_p.keys())
    np.testing.assert_array_equal(st_m.get_rows(keys), st_p.get_rows(keys))
    for a, b in zip(_dense(tr_m), _dense(tr_p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
