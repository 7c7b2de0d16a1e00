"""The replica tiers, the port against the JAX package on the same store
history.

- ``TrainerReplicaCache``: refresh / serve / ``note_written`` and the
  stale-key discipline (an eviction folded out of the replica, a log
  overflow dropping the whole replica) answer as the reference's;
- three Trainer passes over windows A, B, A on a spill store with
  ``flags.use_replica_cache``, bit-equal on the CPU to the same passes
  without it, for an f32 table (rows filled on the device from the
  replica's plane), an int8 table and the bf16 transfer (filled on the
  host before the conversion); pass 3's replica hits are above 0 and
  equal the JAX Trainer's;
- ``ReplicaCache``, ``InputTable`` and ``pull_cache_value`` against the
  reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import SpillEmbeddingStore as JaxSpill
from paddlebox_tpu.embedding import replica_cache as jrc
from paddlebox_tpu.embedding import tiering as jtiering
from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, tiering
from paddlebox_tpu_torch.embedding import replica_cache as rc_lib
from paddlebox_tpu_torch.embedding.spill_store import SpillEmbeddingStore
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)


def _cfgs(**kw):
    kw.setdefault("dim", 4)
    kw.setdefault("optimizer", "adagrad")
    kw.setdefault("learning_rate", 0.1)
    return EmbeddingConfig(**kw), JaxCfg(**kw)


def _keys(lo, hi):
    return np.arange(lo, hi, dtype=np.uint64) * np.uint64(2654435761) + 1


def _served(out):
    if out is None:
        return None
    return (out.n, out.hit.tolist(), out.rows.tolist(),
            np.asarray(out.plane)[out.src].tolist())


def test_replica_unit_surface_matches_reference(tmp_path):
    cfg, jcfg = _cfgs()
    st = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / "p"),
                             cache_rows=96)
    jst = JaxSpill(jcfg, spill_dir=str(tmp_path / "j"), cache_rows=96)
    rc = rc_lib.TrainerReplicaCache(st, device="cpu", capacity_rows=64)
    jr = jrc.TrainerReplicaCache(jst, mesh=None, capacity_rows=64)
    keys = _keys(0, 128)
    for s in (st, jst):
        rows = s.lookup_or_init(keys)
        rows[:, 0] = np.arange(128) % 7          # the ranking signal
        s.write_back(keys, rows)
    assert tiering.end_pass_rebalance(st) == jtiering.end_pass_rebalance(
        jst)
    assert rc.refresh() == jr.refresh() == 64     # capacity-bound
    np.testing.assert_array_equal(rc._keys, jr._keys)
    out, jout = rc.serve(keys), jr.serve(keys)
    assert _served(out) == _served(jout)
    # replica bytes are store bytes (both stores read alike: a read
    # moves the tier signals)
    np.testing.assert_array_equal(out.rows, st.get_rows(keys[out.hit]))
    jst.get_rows(keys[jout.hit])
    # the write-back invalidation, then an eviction the log carries
    for r, s in ((rc, st), (jr, jst)):
        r.note_written(keys[:40])
        rows = s.get_rows(keys)
        rows[40:60, 0] = 0.0
        s.write_back(keys[40:60], rows[40:60])
    assert _served(rc.serve(keys)) == _served(jr.serve(keys))
    for r, s in ((rc, st), (jr, jst)):
        tiering_mod = tiering if r is rc else jtiering
        tiering_mod.end_pass_rebalance(s)
        r.refresh()
        assert s.shrink(min_show=1.0) > 0
    got, want = rc.serve(keys), jr.serve(keys)
    assert _served(got) == _served(want) and got is not None
    alive = np.isin(keys, st.keys())
    assert not (got.hit & ~alive).any()          # evicted keys never served
    assert rc.replica_hits == jr.replica_hits > 0
    assert len(rc) == len(jr)
    # a stale-key log that cannot prove completeness drops everything
    for r, s in ((rc, st), (jr, jst)):
        s.stale_keys_since = lambda marker: None
        assert r.serve(keys) is None and len(r) == 0
        assert r.serve(keys) is None             # until the next refresh


def test_replica_cache_input_table_and_pull_cache_value():
    rng = np.random.default_rng(0)
    keys = rng.choice(1 << 40, 50, replace=False).astype(np.uint64)
    rows = rng.normal(size=(50, 6)).astype(np.float32)
    c = rc_lib.ReplicaCache.from_keys_rows(keys, rows)
    j = jrc.ReplicaCache.from_keys_rows(keys, rows)
    c.add(keys[:3], rows[:3] * 2)
    j.add(keys[:3], rows[:3] * 2)
    extra = np.array([7, 8], np.uint64)
    c.add(extra, rows[:2])
    j.add(extra, rows[:2])
    probe = np.concatenate([keys, extra, np.array([1, 2], np.uint64)])
    probe = probe.reshape(6, 9)
    idx = c.translate(probe)
    np.testing.assert_array_equal(idx, j.translate(probe))
    assert len(c) == len(j) == 53
    table = c.to_hbm("cpu")
    assert c.to_hbm("cpu") is table               # copied once
    got = rc_lib.pull_cache_value(table, torch.from_numpy(idx)).numpy()
    want = np.asarray(jrc.pull_cache_value(
        j.to_hbm(make_mesh(1)), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 9, 6)
    empty = rc_lib.ReplicaCache(dim=3)
    np.testing.assert_array_equal(empty.translate(keys[:4]), 0)
    with pytest.raises(ValueError, match="duplicate"):
        rc_lib.ReplicaCache.from_keys_rows(keys[[0, 0]], rows[:2])
    with pytest.raises(ValueError, match="mismatch"):
        c.add(keys[:2], rows[:3])
    t, jt = rc_lib.InputTable(), jrc.InputTable()
    words = ["a", "b", "a", "c", "b"]
    np.testing.assert_array_equal(t.lookup(words), jt.lookup(words))
    np.testing.assert_array_equal(t.lookup(["d", "a"], insert=False),
                                  jt.lookup(["d", "a"], insert=False))
    assert len(t) == len(jt) == 3


NUM_SLOTS, DENSE_DIM, BATCH = 4, 3, 32


def _records(records_cls, schema, n, seed, keys):
    rng = np.random.default_rng(seed)
    lens = [np.ones(n, np.int64) for _ in range(NUM_SLOTS)]
    vals = [rng.choice(keys, n) for _ in range(NUM_SLOTS)]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32)
               for _ in range(DENSE_DIM)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return records_cls(schema, n, vals, offs, floats, z64, z64, z32, z32)


_RNG = np.random.default_rng(9)
_KEYS = _RNG.choice(1 << 50, 400, replace=False).astype(np.int64)
WINDOWS = (_KEYS[:250], _KEYS[150:400], _KEYS[:250])      # A, B, A


def _port_run(tmp_path, name, storage, use_replica):
    flags.use_replica_cache = use_replica
    try:
        cfg, _ = _cfgs(dim=8, storage=storage)
        store = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / name),
                                    cache_rows=192)
        schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS,
                                    num_float=DENSE_DIM, batch_size=BATCH,
                                    max_len=1)
        tr = Trainer(DeepFMModel(NUM_SLOTS, 8, DENSE_DIM, hidden=(16,)),
                     store, schema, TrainerConfig(global_batch_size=BATCH),
                     device="cpu")
    finally:
        flags.use_replica_cache = False
    outs, hits = [], []
    for p, window in enumerate(WINDOWS):
        ds = SlotDataset(schema)
        ds.records = _records(SlotRecordBatch, schema, 4 * BATCH, p, window)
        outs.append(tr.train_pass(ds)["loss_mean"])
        hits.append(tr.feed_mgr.last_replica_hits)
    keys = np.asarray(sorted(set(_KEYS.tolist())), np.uint64)
    keys = keys[np.isin(keys, store.keys())]
    return outs, hits, store.get_rows(keys), tr


def _jax_hits(tmp_path, storage):
    old = jax_flags.use_replica_cache
    jax_flags.use_replica_cache = True
    try:
        _, jcfg = _cfgs(dim=8, storage=storage)
        store = JaxSpill(jcfg, spill_dir=str(tmp_path / "jax"),
                         cache_rows=192)
        schema = JaxSchema.ctr(num_sparse=NUM_SLOTS, num_float=DENSE_DIM,
                               batch_size=BATCH, max_len=1)
        tr = JaxTrainer(JaxDeepFM(num_slots=NUM_SLOTS, emb_dim=8,
                                  dense_dim=DENSE_DIM, hidden=(16,)),
                        store, schema, make_mesh(1),
                        JaxTrainerConfig(global_batch_size=BATCH))
    finally:
        jax_flags.use_replica_cache = old
    hits = []
    for p, window in enumerate(WINDOWS):
        ds = JaxDataset(schema)
        ds.records = _records(JaxRecords, schema, 4 * BATCH, p, window)
        before = tr.replica_cache.replica_hits
        tr.train_pass(ds)
        hits.append(tr.replica_cache.replica_hits - before)
    return hits


@pytest.fixture
def compress(request):
    old = (flags.transfer_compress_embedx, jax_flags.transfer_compress_embedx)
    flags.transfer_compress_embedx = jax_flags.transfer_compress_embedx = \
        request.param
    yield request.param
    flags.transfer_compress_embedx, jax_flags.transfer_compress_embedx = old


@pytest.mark.parametrize("storage,compress", [("f32", False),
                                              ("int8", False),
                                              ("f32", True)],
                         indirect=["compress"])
def test_replica_run_bit_equal_with_hits(tmp_path, storage, compress):
    base = _port_run(tmp_path, "base", storage, False)
    repl = _port_run(tmp_path, "repl", storage, True)
    assert repl[0] == base[0]                       # losses, exactly
    np.testing.assert_array_equal(repl[2], base[2])
    hits = repl[1]
    assert base[1] == [0, 0, 0] and hits[2] > 0
    assert hits == _jax_hits(tmp_path, storage)
    rc = repl[3].replica_cache
    assert rc.refreshes == 3 and rc.replica_hits == sum(hits)
