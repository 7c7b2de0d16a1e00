"""Quantized device storage (EmbeddingConfig.storage = int8 / int16) and
the bf16 pass-boundary transfer, the port against the JAX package on the
same numpy-seeded inputs (the JAX side on one CPU device, as its own
tests run it).

- the row codec bit-equal to the reference's (host and device forms);
- ``lookup`` dequantizing at the gather (rtol 1e-6);
- ``push`` on int8 / int16 tables under sgd, adagrad, adam and ftrl:
  ``fp`` planes within 1e-6, ``qx`` planes equal except where the f32
  update's last-bit rounding moved ``x / scale`` across a half step,
  where they may differ by exactly 1 (the count is reported); untouched
  rows keep their bits;
- ``device_width`` leaves quantized tables unpadded; the quantized
  resolver keeps the binned engine for the accumulator;
- one-hot passes at int16 and int8 and a multi-hot pass at int8 through
  the port's Trainer against the JAX Trainer (losses at LOSS_TOL,
  decoded tables at TABLE_TOL), and 60 steps against
  tests/golden_deepfm.py at int16 and int8 (test_golden_parity.py's
  tolerances);
- a quantized run's checkpoint keeps the host f32 and restores;
- ``flags.transfer_compress_embedx``: ``fetch_rows`` bit-equal to the
  reference's and byte counts equal to ``transfer_bytes`` in both
  packages, and a compressed pass against the reference's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.embedding import PassWorkingSet as JaxWS
from paddlebox_tpu.embedding import quant as jquant
from paddlebox_tpu.embedding import sharded as jsh
from paddlebox_tpu.embedding import working_set as jws_lib
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
                                           PassWorkingSet, quant, sharded)
from paddlebox_tpu_torch.embedding import working_set as ws_lib
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

from tests.golden_deepfm import GoldenDeepFM

torch.set_num_threads(1)

NUM_SLOTS, DENSE_DIM = 4, 3
HIDDEN = (16, 16)
BATCH = 32
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
STORAGES = ("int8", "int16")


def _cfgs(**kw):
    kw.setdefault("dim", 8)
    kw.setdefault("optimizer", "adagrad")
    kw.setdefault("learning_rate", 0.1)
    return EmbeddingConfig(**kw), JaxCfg(**kw)


def _rows(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, cfg.row_width)).astype(np.float32) * 0.05
    rows[:, 0] = rng.integers(0, 50, n)
    rows[:, 1] = rng.integers(0, 5, n)
    rows[:, cfg.opt_cols] = np.abs(rows[:, cfg.opt_cols])
    rows[0] = 0.0
    return rows


def _planes(t):
    return [p.numpy() for p in t] if quant.is_quant(t) else [t.numpy()]


def _jplanes(t):
    return [np.asarray(p) for p in t] if jquant.is_quant(t) else \
        [np.asarray(t)]


@pytest.mark.parametrize("storage", STORAGES)
def test_codec_bit_equal_to_reference(storage):
    cfg, jcfg = _cfgs(storage=storage)
    rows = _rows(cfg, 257)
    rows[5, cfg.embedx_cols] = 0.0            # an all-zero embedx row
    fp, qx = quant.encode_rows_np(rows, cfg)
    jfp, jqx = jquant.encode_rows_np(rows, jcfg)
    assert qx.dtype == np.dtype(storage) == jqx.dtype
    np.testing.assert_array_equal(fp, jfp)
    np.testing.assert_array_equal(qx, jqx)
    np.testing.assert_array_equal(quant.decode_rows_np(fp, qx, cfg),
                                  jquant.decode_rows_np(jfp, jqx, jcfg))
    # the device forms: split(assemble) of arbitrary rows, and the lanes
    t = quant.device_table(rows, cfg, torch.device("cpu"))
    jt = jquant.device_table(rows, jcfg, None)
    for a, b in zip(_planes(t), _jplanes(jt)):
        np.testing.assert_array_equal(a, b)
    got = quant.split_rows(torch.from_numpy(rows * 3.0), cfg)
    want = jquant.split_rows(jnp.asarray(rows * 3.0), jcfg)
    for a, b in zip(_planes(got), _jplanes(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        quant.assemble_rows(got.fp, got.qx, cfg).numpy(),
        np.asarray(jquant.assemble_rows(want.fp, want.qx, jcfg)))
    lanes = rows[:, cfg.embedx_cols].reshape(-1, 4, 2)
    q, s = quant.quantize_lanes(torch.from_numpy(lanes), storage)
    jq, js = jquant.quantize_lanes(jnp.asarray(lanes), storage)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_lanes(q, s).numpy(),
        np.asarray(jquant.dequantize_lanes(jq, js)))
    # a table with no embedx: the floor scale
    c0 = EmbeddingConfig(dim=0, storage=storage)
    r0 = np.ones((3, c0.row_width), np.float32)
    assert (quant.split_rows(torch.from_numpy(r0), c0).fp[:, -1]
            == np.float32(1e-12)).all()


@pytest.mark.parametrize("storage", STORAGES)
def test_lookup_dequantizes_like_reference(storage):
    cfg, jcfg = _cfgs(storage=storage)
    rows = _rows(cfg, 128, seed=1)
    t = quant.device_table(rows, cfg, torch.device("cpu"))
    jt = jquant.device_table(rows, jcfg, None)
    idx = np.random.default_rng(2).integers(0, 128, (7, 6)).astype(np.int32)
    got = sharded.lookup(t, torch.from_numpy(idx), cfg).numpy()
    want = np.asarray(jsh.lookup(jt, jnp.asarray(idx), jcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the pooled multi-hot pull takes lookup + sum for quantized tables
    pooled = sharded.fused_pull_pool(t, torch.from_numpy(idx), cfg, 3, 2)
    jpooled = jsh.fused_pull_pool(jt, jnp.asarray(idx), jcfg, 3, 2)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam", "ftrl"])
@pytest.mark.parametrize("storage", STORAGES)
def test_push_matches_reference(storage, optimizer, capsys):
    cfg, jcfg = _cfgs(storage=storage, optimizer=optimizer)
    n_rows, n_tok = 300, 2000
    rows = _rows(cfg, n_rows, seed=3)
    t = quant.device_table(rows, cfg, torch.device("cpu"))
    jt = jquant.device_table(rows, jcfg, None)
    rng = np.random.default_rng(4)
    for step in range(3):
        idx = rng.integers(0, n_rows // 2, n_tok).astype(np.int32)
        grads = rng.normal(scale=0.1, size=(n_tok, cfg.grad_width)).astype(
            np.float32)
        shows = (idx > 0).astype(np.float32)
        clks = (rng.random(n_tok) < 0.3).astype(np.float32) * shows
        grads[idx == 0] = 0.0
        engine = sharded.push(t, *(torch.from_numpy(a) for a in
                                   (idx, grads, shows, clks)), cfg)
        assert engine == "xla_scatter"
        jt = jsh.push(jt, *(jnp.asarray(a) for a in
                            (idx, grads, shows, clks)), jcfg)
    fp, qx = _planes(t)
    jfp, jqx = _jplanes(jt)
    np.testing.assert_allclose(fp, jfp, rtol=1e-6, atol=1e-6)
    diff = qx.astype(np.int32) - jqx.astype(np.int32)
    assert np.abs(diff).max() <= 1
    n_off = int((diff != 0).sum())
    # an off-by-one code sits on a half step of x / scale
    print(f"{storage} {optimizer}: {n_off} of {diff.size} codes differ "
          f"by 1")
    assert n_off <= diff.size // 100
    # rows no token touched keep every bit of both planes
    untouched = np.arange(n_rows // 2, n_rows)
    np.testing.assert_array_equal(fp[untouched], rows_fp(rows, cfg)[0][
        untouched])
    np.testing.assert_array_equal(qx[untouched], rows_fp(rows, cfg)[1][
        untouched])


def rows_fp(rows, cfg):
    return quant.encode_rows_np(rows, cfg)


def test_untouched_rows_keep_exact_bits():
    cfg, _ = _cfgs(dim=4, storage="int8")
    rows = _rows(cfg, 64, seed=9)
    t = quant.device_table(rows, cfg, torch.device("cpu"))
    fp0, qx0 = (p.clone() for p in t)
    idx = torch.tensor([5, 9], dtype=torch.int32)
    g = torch.full((2, cfg.grad_width), 0.5)
    sharded.push(t, idx, g, torch.ones(2), torch.zeros(2), cfg)
    untouched = np.setdiff1d(np.arange(64), [5, 9])
    assert torch.equal(t.qx[untouched], qx0[untouched])
    assert torch.equal(t.fp[untouched], fp0[untouched])
    assert not torch.equal(t.fp[[5, 9]], fp0[[5, 9]])


def test_device_width_and_resolver_for_quantized_tables():
    old = flags.table_pad_width
    flags.table_pad_width = "auto"
    try:
        f32, _ = _cfgs(dim=32)
        q8, _ = _cfgs(dim=32, storage="int8")
        assert ws_lib.device_width(f32) == 64
        assert ws_lib.device_width(q8) == q8.row_width
    finally:
        flags.table_pad_width = old
    cfg, _ = _cfgs(storage="int16")
    n_rows = 1 << 15
    # the card's auto engine for a quantized one-hot table is binned
    # (the accumulator); the fused engine never takes one
    assert kernels.resolve_push_engine(
        cfg, n_rows, premerged=False, device_type="cuda") == "binned_kernel"
    assert kernels.resolve_push_engine(
        cfg, n_rows, premerged=True, device_type="cuda") == "binned_kernel"
    assert kernels.resolve_push_engine(
        cfg, n_rows, premerged=False, device_type="cpu") == "xla_scatter"
    old = flags.push_engine
    flags.push_engine = "scatter_accumulate"
    try:
        assert kernels.resolve_push_engine(
            cfg, n_rows, premerged=True, device_type="cuda") == "xla_scatter"
    finally:
        flags.push_engine = old
    # transfer bytes follow the planes
    for storage, qb in (("int8", 1), ("int16", 2)):
        c, jc = _cfgs(storage=storage)
        assert ws_lib.transfer_bytes(c, 10) == jws_lib.transfer_bytes(
            jc, 10) == 10 * (4 * quant.fp_width(c) + qb * c.total_dim)


# ---------------------------------------------------------------------------
# whole passes: the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

def _records(records_cls, schema, n, seed, max_len, keys):
    rng = np.random.default_rng(seed)
    lens = [rng.integers(1, max_len + 1, n) for _ in range(NUM_SLOTS)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32)
               for _ in range(DENSE_DIM)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return records_cls(schema, n, vals, offs, floats, z64, z64, z32, z32)


def _pair(storage, emb_dim, max_len):
    kw = dict(dim=emb_dim, optimizer="adagrad", learning_rate=0.05,
              storage=storage)
    jstore = JaxStore(JaxCfg(**kw))
    jschema = JaxSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                            batch_size=BATCH, max_len=max_len)
    jtr = JaxTrainer(JaxDeepFM(num_slots=NUM_SLOTS, emb_dim=emb_dim,
                               dense_dim=DENSE_DIM, hidden=HIDDEN),
                     jstore, jschema, make_mesh(1),
                     JaxTrainerConfig(global_batch_size=BATCH))
    store = HostEmbeddingStore(EmbeddingConfig(**kw))
    schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                                batch_size=BATCH, max_len=max_len)
    tr = Trainer(DeepFMModel(NUM_SLOTS, emb_dim, DENSE_DIM, hidden=HIDDEN),
                 store, schema, TrainerConfig(global_batch_size=BATCH),
                 device="cpu")
    weights.load_deepfm_params(tr.model, jax.tree.map(np.asarray,
                                                      jtr.params))
    return (store, schema, tr), (jstore, jschema, jtr)


def _run_passes(storage, emb_dim, max_len, n_batches=6):
    """Two passes over overlapping key windows (the second reuses the
    resident planes and retires the rows the window dropped) through
    train_pass in both packages; returns the per-pass losses and the
    stores' rows of every key."""
    (store, schema, tr), (jstore, jschema, jtr) = _pair(storage, emb_dim,
                                                        max_len)
    rng = np.random.default_rng(11)
    all_keys = rng.choice(1 << 50, 500, replace=False).astype(np.int64)
    out, seen = [], []
    for p, window in enumerate((all_keys[:300], all_keys[150:450])):
        ds = SlotDataset(schema)
        ds.records = _records(SlotRecordBatch, schema, n_batches * BATCH,
                              p, max_len, window)
        jds = JaxDataset(jschema)
        jds.records = _records(JaxRecords, jschema, n_batches * BATCH, p,
                               max_len, window)
        seen += [v.astype(np.uint64) for v in ds.records.sparse_values]
        got, want = tr.train_pass(ds), jtr.train_pass(jds)
        assert got["steps"] == want["steps"] == n_batches
        out.append((got["loss_mean"], want["loss_mean"]))
        assert tr.resolved_push_engine(tr.last_ws) == "xla_scatter"
        assert quant.is_quant(tr.last_ws.table) == (storage != "f32")
    keys = np.unique(np.concatenate(seen))
    return out, store.get_rows(keys), jstore.get_rows(keys), tr


@pytest.mark.parametrize("storage,max_len", [("int16", 1), ("int8", 1),
                                             ("int8", 4)])
def test_trainer_passes_match_reference(storage, max_len):
    losses, rows, jrows, tr = _run_passes(storage, 8, max_len)
    for got, want in losses:
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    np.testing.assert_allclose(rows, jrows, **TABLE_TOL)
    # the pass trained and the host store stayed f32
    assert rows.dtype == np.float32 and rows[:, 0].sum() > 0
    if max_len > 1:
        assert tr.pull_engine == "fused_gather_pool"


@pytest.mark.parametrize("storage", STORAGES)
def test_golden_trajectory(storage):
    """60 steps of the port's step on a quantized table against the
    NumPy golden (test_golden_parity.py's allreduce case and
    tolerances)."""
    emb_dim, steps = 4, 60
    cfg = EmbeddingConfig(dim=emb_dim, optimizer="adagrad",
                          learning_rate=0.05, storage=storage)
    store = HostEmbeddingStore(cfg)
    schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                                batch_size=BATCH, max_len=1)
    tr = Trainer(DeepFMModel(NUM_SLOTS, emb_dim, DENSE_DIM, hidden=HIDDEN),
                 store, schema, TrainerConfig(global_batch_size=BATCH),
                 device="cpu")
    rng = np.random.default_rng(7)
    keys = np.unique(rng.choice(1 << 40, 300).astype(np.uint64))
    ws = PassWorkingSet.begin_pass(store, keys, device="cpu")
    host = np.zeros((ws.padded_rows, cfg.row_width), np.float32)
    host[1:1 + len(keys)] = store.peek_rows(keys)
    gold = GoldenDeepFM(host, weights.deepfm_params(tr.model), NUM_SLOTS,
                        emb_dim, DENSE_DIM, HIDDEN, lr_sparse=0.05,
                        initial_g2sum=cfg.initial_g2sum,
                        dense_lr=tr.cfg.dense_lr, storage=storage)
    losses, gold_losses = [], []
    for _ in range(steps):
        raw = rng.choice(keys, size=(BATCH, NUM_SLOTS))
        mask = rng.random((BATCH, NUM_SLOTS)) < 0.9
        idx = ws.translate(raw, mask)
        dense = rng.normal(size=(BATCH, DENSE_DIM)).astype(np.float32)
        labels = (rng.random(BATCH) < 0.3).astype(np.float32)
        loss, _ = tr.train_step(ws.table, *tr.stage(
            tr.pack_arrays(ws, idx, mask, dense, labels)))
        losses.append(float(loss))
        gold_losses.append(gold.step(idx, mask, dense, labels))
    np.testing.assert_allclose(losses, gold_losses, rtol=2e-4, atol=2e-5)
    fw_table = quant.decode_rows_np(ws.table.fp.numpy(),
                                    ws.table.qx.numpy(), cfg)
    np.testing.assert_allclose(fw_table, gold.table, rtol=1e-3, atol=2e-5)
    params = weights.deepfm_params(tr.model)
    for got, want in ((params["bias"], gold.params["bias"]),
                      (params["wide_dense"], gold.params["wide_dense"])):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    for i, layer in enumerate(params["mlp"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(layer[k], gold.params["mlp"][i][k],
                                       rtol=2e-3, atol=2e-5)


def test_quant_checkpoint_keeps_f32_host(tmp_path):
    (store, schema, tr), _ = _pair("int16", 4, 1)
    keys = np.random.default_rng(3).choice(1 << 50, 200, replace=False)
    ds = SlotDataset(schema)
    ds.records = _records(SlotRecordBatch, schema, 4 * BATCH, 0, 1, keys)
    tr.train_pass(ds)
    k = np.unique(keys.astype(np.uint64))
    k = k[np.isin(k, store.keys())]
    rows = store.get_rows(k)                   # the flush hook fires
    assert rows.dtype == np.float32 and rows[:, 0].sum() > 0
    # the host rows are the decoded device rows, so embedx sits on the
    # row's quantization grid
    fp, qx = quant.encode_rows_np(rows, store.cfg)
    np.testing.assert_allclose(quant.decode_rows_np(fp, qx, store.cfg),
                               rows, rtol=1e-6, atol=1e-9)
    store.save_base(str(tmp_path / "b"))
    loaded = HostEmbeddingStore.load(str(tmp_path / "b"))
    assert loaded.cfg.storage == "int16"
    np.testing.assert_array_equal(loaded.get_rows(k), rows)
    jloaded = JaxStore.load(str(tmp_path / "b"))
    np.testing.assert_array_equal(jloaded.get_rows(k), rows)


# ---------------------------------------------------------------------------
# the bf16 pass-boundary transfer (flags.transfer_compress_embedx)
# ---------------------------------------------------------------------------

@pytest.fixture
def compress():
    old = (flags.transfer_compress_embedx, jax_flags.transfer_compress_embedx)
    flags.transfer_compress_embedx = jax_flags.transfer_compress_embedx = True
    yield
    flags.transfer_compress_embedx, jax_flags.transfer_compress_embedx = old


def test_compressed_transfer_matches_reference(compress):
    """The reference's roundtrip test (test_embedding.py:445) in both
    packages: counters (far beyond bf16's 2^8), w and optimizer state
    exact; embedx rounded to bf16 once, bit-equal across packages; the
    bytes of a begin/fetch equal to transfer_bytes."""
    cfg, jcfg = _cfgs(dim=8, optimizer="adagrad")
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 40, 200, replace=False).astype(np.uint64)
    stores = []
    for store in (HostEmbeddingStore(cfg), JaxStore(jcfg)):
        rows = store.lookup_or_init(keys)
        rows[:, 0] = np.arange(200) * 997 + 100_000      # large counters
        rows[:, 1] = np.arange(200) * 13 + 50_000
        rows[:, 2] = np.linspace(-3, 3, 200)
        rows[:, cfg.embedx_cols] = np.random.default_rng(1).normal(
            size=(200, cfg.total_dim))
        store.write_back(keys, rows)
        stores.append(store)
    ws = PassWorkingSet.begin_pass(stores[0], keys, device="cpu")
    before = stores[0].get_rows(ws.sorted_keys)
    jws = JaxWS.begin_pass(stores[1], keys, make_mesh(1))
    assert ws.h2d_bytes == ws_lib.transfer_bytes(cfg, ws.padded_rows)
    assert ws_lib.transfer_bytes(cfg, 7) == jws_lib.transfer_bytes(
        jcfg, 7) == 7 * (4 * (cfg.row_width - 8) + 2 * 8)
    sel = np.arange(1, 1 + len(keys))
    got, nbytes = ws_lib.fetch_rows(ws.table, sel, cfg)
    want, jbytes = jws_lib.fetch_rows(jws.table, sel, jcfg)
    np.testing.assert_array_equal(got, want)
    assert nbytes == ws_lib.transfer_bytes(cfg, len(sel))
    assert jbytes == jws_lib.transfer_bytes(jcfg, jws_lib.bucket_size(
        len(sel)))                   # the reference pads to a bucket
    np.testing.assert_array_equal(got[:, :3], before[:, :3])
    np.testing.assert_array_equal(got[:, cfg.opt_cols],
                                  before[:, cfg.opt_cols])
    np.testing.assert_allclose(got[:, cfg.embedx_cols],
                               before[:, cfg.embedx_cols], rtol=1 / 128)
    assert np.abs(got - before).max() > 0            # really bf16
    bf = torch.from_numpy(before[:, cfg.embedx_cols]).to(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[:, cfg.embedx_cols], bf)
    # quantized storage refuses the redundant compression
    q, _ = _cfgs(storage="int8")
    with pytest.raises(ValueError, match="redundant"):
        PassWorkingSet.begin_pass(HostEmbeddingStore(q), keys[:4],
                                  device="cpu")


def test_compressed_pass_matches_reference(compress):
    losses, rows, jrows, tr = _run_passes("f32", 8, 1)
    for got, want in losses:
        np.testing.assert_allclose(got, want, **LOSS_TOL)
    np.testing.assert_allclose(rows, jrows, **TABLE_TOL)
    fm = tr.feed_mgr
    # the second boundary staged fresh rows through the bf16 transfer
    assert fm.last_h2d_bytes == ws_lib.transfer_bytes(
        tr.store.cfg, ws_lib.bucket_size(fm.last_fresh_rows))
    # every host row's embedx went through bf16 at least once
    x = rows[:, tr.store.cfg.embedx_cols]
    np.testing.assert_array_equal(
        x, torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def test_quant_rows_path_uses_planes_on_disk(tmp_path):
    """A quantized table over a spill store: the planes come from and go
    back to the disk tier through the same hooks (the host stays f32)."""
    from paddlebox_tpu_torch.embedding.spill_store import \
        SpillEmbeddingStore
    cfg, _ = _cfgs(dim=4, storage="int8")
    store = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / "s"),
                                cache_rows=16)
    keys = np.arange(1, 101, dtype=np.uint64)
    ws = PassWorkingSet.begin_pass(store, keys, device="cpu")
    assert quant.is_quant(ws.table)
    assert ws.h2d_bytes == ws_lib.transfer_bytes(cfg, ws.padded_rows)
    ws.translate(keys)
    nbytes = ws.end_pass(store)
    assert nbytes == ws_lib.transfer_bytes(cfg, len(keys))
    fp, qx = quant.encode_rows_np(store.get_rows(keys), cfg)
    np.testing.assert_array_equal(fp, ws.table.fp.numpy()[1:101])
    np.testing.assert_array_equal(qx, ws.table.qx.numpy()[1:101])
    assert os.path.getsize(store._rows_path) >= 100 * cfg.row_width * 4
