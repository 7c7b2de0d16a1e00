"""The slice as a whole: the port's DeepFM training step against the JAX
Trainer's step AND the pure-NumPy golden step (tests/golden_deepfm.py),
following test_golden_parity._run_pair: same keys, same batches, initial
params carried from the JAX Trainer (weights.py) and the same
deterministic table init. 60 steps at max_len 1 and 4, dim 4 and 32
(and through the forced fused and binned push engines), held at
golden_deepfm's tolerances (loss rtol 2e-4 / atol 2e-5, table rtol 1e-3
/ atol 2e-5, mlp rtol 2e-3 / atol 2e-5). A 2x sparse learning
rate injected into the golden must break the loss tolerance. One more
case runs the whole BoxPS.begin_pass → train_pass(SlotDataset) →
end_pass lifecycle in both packages.
"""

import numpy as np
import pytest
import torch

import jax

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.embedding import PassWorkingSet as JaxWS
from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                           HostEmbeddingStore,
                                           PassWorkingSet)
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

from tests.golden_deepfm import GoldenDeepFM

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes, and torch's default pool (a thread per core
# in every worker) would oversubscribe them.
torch.set_num_threads(1)

NUM_SLOTS, DENSE_DIM = 4, 3
HIDDEN = (16, 16)
BATCH, STEPS, N_KEYS = 32, 60, 300
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
MLP_TOL = dict(rtol=2e-3, atol=2e-5)


def _port(emb_dim, max_len, jparams):
    store = HostEmbeddingStore(EmbeddingConfig(dim=emb_dim,
                                               optimizer="adagrad",
                                               learning_rate=0.05))
    schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                                batch_size=BATCH, max_len=max_len)
    tr = Trainer(DeepFMModel(NUM_SLOTS, emb_dim, DENSE_DIM, hidden=HIDDEN),
                 store, schema, TrainerConfig(global_batch_size=BATCH),
                 device="cpu")
    weights.load_deepfm_params(tr.model, jparams)
    return store, tr


def _jax(emb_dim, max_len):
    store = JaxStore(JaxCfg(dim=emb_dim, optimizer="adagrad",
                            learning_rate=0.05))
    schema = JaxSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                           batch_size=BATCH, max_len=max_len)
    mesh = make_mesh(1)
    tr = JaxTrainer(JaxDeepFM(num_slots=NUM_SLOTS, emb_dim=emb_dim,
                              dense_dim=DENSE_DIM, hidden=HIDDEN),
                    store, schema, mesh,
                    JaxTrainerConfig(global_batch_size=BATCH))
    return store, tr, mesh


def _run_pair(emb_dim, max_len, golden_lr_mult=1.0):
    """STEPS steps through the port's step, the JAX step and the golden;
    returns (port, jax, golden) loss trajectories plus final states.
    With flags.push_engine forced to scatter_accumulate in both packages
    the steps run the card's push algorithm (host dedup plan → premerge →
    fused row update) on the CPU; forced to binned_kernel, the port's
    steps run the binned engine's plain path (host block plan, or
    premerged lanes for multi-hot batches) while the JAX step resolves
    xla_scatter off-TPU."""
    jstore, jtr, mesh = _jax(emb_dim, max_len)
    jparams = jax.tree.map(np.asarray, jtr.params)
    store, tr = _port(emb_dim, max_len, jparams)
    rng = np.random.default_rng(7)
    keys = np.unique(rng.choice(1 << 40, N_KEYS).astype(np.uint64))
    jws = JaxWS.begin_pass(jstore, keys, mesh)
    ws = PassWorkingSet.begin_pass(store, keys, device="cpu")
    jtable = np.asarray(jws.table)
    # the deterministic row init is bit-identical in both packages; the
    # table is carried across all the same, as the params are
    np.testing.assert_array_equal(ws.table.numpy(), jtable)
    weights.load_table(ws, jtable)
    gold = GoldenDeepFM(jtable, jparams, NUM_SLOTS, emb_dim, DENSE_DIM,
                        HIDDEN, max_len=max_len,
                        lr_sparse=0.05 * golden_lr_mult,
                        dense_lr=tr.cfg.dense_lr)
    table, dstate = jws.table, jtr.pack_dense()
    losses = {"port": [], "jax": [], "gold": []}
    T = NUM_SLOTS * max_len
    for _ in range(STEPS):
        raw = rng.choice(keys, size=(BATCH, T))
        mask = rng.random((BATCH, T)) < 0.9
        idx = ws.translate(raw, mask)
        np.testing.assert_array_equal(idx, jws.translate(raw, mask))
        dense = rng.normal(size=(BATCH, DENSE_DIM)).astype(np.float32)
        labels = (rng.random(BATCH) < 0.3).astype(np.float32)
        loss, _ = tr.train_step(ws.table, *tr.stage(
            tr.pack_arrays(ws, idx, mask, dense, labels)))
        losses["port"].append(float(loss))
        out = jtr._step_fn(table, *dstate, idx, mask, dense, labels,
                           *jtr._host_plan(jws, idx))
        table, dstate, jloss, _, _ = jtr.split_step_out(out)
        losses["jax"].append(float(jloss))
        losses["gold"].append(gold.step(idx, mask, dense, labels))
    return ({k: np.array(v) for k, v in losses.items()}, ws.table.numpy(),
            np.asarray(table), weights.deepfm_params(tr.model),
            jax.tree.map(np.asarray, jtr.unpack_dense(dstate)[0]), gold,
            tr.resolved_push_engine(ws))


def _assert_params(got, want):
    for i, layer in enumerate(got["mlp"]):
        np.testing.assert_allclose(layer["w"], want["mlp"][i]["w"],
                                   **MLP_TOL)
        np.testing.assert_allclose(layer["b"], want["mlp"][i]["b"],
                                   **MLP_TOL)
    np.testing.assert_allclose(got["bias"], want["bias"], **MLP_TOL)
    np.testing.assert_allclose(got["wide_dense"], want["wide_dense"],
                               **MLP_TOL)


@pytest.fixture
def push_engine(request):
    old = (flags.push_engine, jax_flags.push_engine)
    flags.push_engine = jax_flags.push_engine = request.param
    yield request.param
    flags.push_engine, jax_flags.push_engine = old


@pytest.mark.parametrize("emb_dim,max_len,push_engine",
                         [(4, 1, "auto"), (32, 1, "auto"), (4, 4, "auto"),
                          (32, 4, "auto"), (32, 4, "scatter_accumulate"),
                          (8, 1, "binned_kernel"), (32, 1, "binned_kernel"),
                          (32, 4, "binned_kernel")],
                         indirect=["push_engine"])
def test_trajectory_parity(max_len, emb_dim, push_engine):
    losses, table, jtable, params, jparams, gold, engine = _run_pair(
        emb_dim, max_len)
    if push_engine != "auto":
        assert engine == push_engine
    for ref in ("jax", "gold"):
        np.testing.assert_allclose(losses["port"], losses[ref], **LOSS_TOL)
    np.testing.assert_allclose(table, jtable, **TABLE_TOL)
    np.testing.assert_allclose(table, gold.table, **TABLE_TOL)
    _assert_params(params, jparams)
    _assert_params(params, gold.params)


def test_detects_systematic_error():
    """A 2x sparse learning rate in the golden must blow the loss
    tolerance the parity test accepts."""
    losses, *_ = _run_pair(4, 1, golden_lr_mult=2.0)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(losses["port"], losses["gold"],
                                   **LOSS_TOL)


def _records(schema_cls, records_cls, schema, n, seed, max_len):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 50, 400, replace=False).astype(np.int64)
    lens = [rng.integers(1, max_len + 1, n) for _ in range(NUM_SLOTS)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32)
               for _ in range(DENSE_DIM)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return records_cls(schema, n, vals, offs, floats, z64, z64, z32, z32)


def test_boxps_pass_lifecycle_matches_reference():
    max_len, emb_dim, n = 4, 8, 8 * BATCH
    jstore, jtr, _ = _jax(emb_dim, max_len)
    store, tr = _port(emb_dim, max_len, jax.tree.map(np.asarray, jtr.params))
    jds = JaxDataset(jtr.schema)
    jds.records = _records(JaxSchema, JaxRecords, jtr.schema, n, 5, max_len)
    ds = SlotDataset(tr.schema)
    ds.records = _records(DataFeedSchema, SlotRecordBatch, tr.schema, n, 5,
                          max_len)
    jbox, box = JaxBoxPS(jstore), BoxPS(store)
    jbox.set_date(20261016)
    box.set_date(20261016)
    jbox.begin_pass()
    jout = jtr.train_pass(jds)
    jbox.end_pass()
    box.begin_pass()
    out = tr.train_pass(ds)
    assert box.end_pass()["pass_id"] == 1
    assert out["steps"] == jout["steps"] == 8
    np.testing.assert_allclose(out["loss_mean"], jout["loss_mean"],
                               **LOSS_TOL)
    # AUC from 65536-bucket histograms of nearly equal preds
    assert abs(out["auc"] - jout["auc"]) < 1e-3
    keys = np.unique(np.concatenate(ds.records.sparse_values)).astype(
        np.uint64)
    assert len(store) == len(jstore) == len(keys)
    # write-back is lazy in both packages: get_rows flushes the device
    # tier first (peek_rows would read the pre-pass rows)
    np.testing.assert_allclose(store.get_rows(keys), jstore.get_rows(keys),
                               **TABLE_TOL)
    # the pass really trained: counters moved off the fresh init
    assert store.get_rows(keys)[:, 0].sum() == float(
        sum(len(v) for v in ds.records.sparse_values))
