"""The disk spill tier and its tier manager, the port against the JAX
package on the same numpy-seeded operations.

- ``SpillEmbeddingStore`` under one mixed sequence of ``lookup_or_init``
  / ``write_back`` / ``get_rows`` / ``shrink`` / ``save_base`` /
  ``save_delta``: equal rows, equal cache hit / miss / conflict counts,
  equal ``tier_end_pass`` dicts, and chains that load across packages
  and across store classes (the streamed payloads read by ``np.load`` as
  ``savez`` output);
- ``TierManager`` admit / evict decisions equal to the reference's on one
  access stream, for the ``freq`` and ``direct`` policies at assoc 1
  and 4;
- ``autotune_cache_rows``, ``end_pass_rebalance``, ``store_from_flags``
  (``n_shards > 1`` builds a sharded store of spill shards),
  ``describe`` and ``spill_stats``;
- the two fault windows leave the authoritative rows intact;
- two Trainer passes on a spill store whose cache holds under half the
  keys, bit-equal to the same passes on a ``HostEmbeddingStore``.
"""

import io
import os
import zipfile

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.embedding import SpillEmbeddingStore as JaxSpill
from paddlebox_tpu.embedding import tiering as jtiering

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                           HostEmbeddingStore, tiering)
from paddlebox_tpu_torch.embedding import spill_store as sp
from paddlebox_tpu_torch.embedding.spill_store import SpillEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils import faultpoint

torch.set_num_threads(1)


def _cfgs(**kw):
    kw.setdefault("dim", 4)
    kw.setdefault("optimizer", "adagrad")
    kw.setdefault("learning_rate", 0.1)
    return EmbeddingConfig(**kw), JaxCfg(**kw)


def _keys(lo, hi):
    return np.arange(lo, hi, dtype=np.uint64) * np.uint64(2654435761) + 1


def _tier_state(st):
    t = st.tier
    return dict(ctags=st._ctags.copy(), freq=t._freq.copy(),
                score=t._score.copy(), show=t._show.copy(),
                totals=(t.total_admitted, t.total_evicted, t.passes),
                counts=(st.cache_hits, st.cache_misses,
                        st.conflict_misses))


def _assert_same_tier(a, b):
    sa, sb = _tier_state(a), _tier_state(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _stream(st, seed, rounds=6, keyspace=3000, n=400):
    """The mixed operation sequence both packages' stores run: pass-like
    rounds of skewed lookups, updates written back, reads, a boundary
    re-scoring, an eviction shrink and saves. Returns the per-round
    tier_end_pass dicts and the live keys."""
    rng = np.random.default_rng(seed)
    all_keys = _keys(0, keyspace)
    stats = []
    for r in range(rounds):
        # Zipf-skewed picks: a hot head that earns its slots, a cold tail
        pick = np.unique(np.minimum(rng.zipf(1.3, n), keyspace) - 1)
        ks = all_keys[pick]
        rows = st.lookup_or_init(ks)
        upd = rows + rng.normal(size=rows.shape).astype(np.float32) * 0.1
        upd[:, 0] = rows[:, 0] + rng.integers(0, 3, len(ks))
        st.write_back(ks, upd)
        st.get_rows(ks[: len(ks) // 2])
        if hasattr(st, "tier_end_pass"):
            stats.append(st.tier_end_pass())
        if r == 2:
            st.shrink(min_show=1.0)
    return stats


@pytest.mark.parametrize("policy,assoc", [("freq", 1), ("freq", 4),
                                          ("direct", 1), ("direct", 4)])
def test_tier_decisions_match_reference(tmp_path, policy, assoc):
    cfg, jcfg = _cfgs()
    st = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / "p"),
                             cache_rows=64, tier_policy=policy,
                             cache_assoc=assoc)
    jst = JaxSpill(jcfg, spill_dir=str(tmp_path / "j"), cache_rows=64,
                   tier_policy=policy, cache_assoc=assoc)
    got, want = _stream(st, 1), _stream(jst, 1)
    assert got == want
    _assert_same_tier(st, jst)
    assert st.cache_hits > 0 and st.cache_misses > 0
    if policy == "freq" and assoc == 4:
        assert st.conflict_misses > 0 and st.tier.total_evicted > 0


def test_spill_store_matches_reference_with_chains(tmp_path):
    cfg, jcfg = _cfgs()
    st = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / "p"),
                             cache_rows=37)
    jst = JaxSpill(jcfg, spill_dir=str(tmp_path / "j"), cache_rows=37)
    ram = HostEmbeddingStore(cfg)
    for i, s in enumerate((st, jst, ram)):
        s.lookup_or_init(_keys(0, 50))
        s.save_base(str(tmp_path / f"ck{i}"))
    stats = [_stream(s, 2, rounds=4) for s in (st, jst)]
    assert stats[0] == stats[1]
    _stream(ram, 2, rounds=4)
    for i, s in enumerate((st, jst, ram)):
        s.save_delta(str(tmp_path / f"ck{i}"))
    keys = st.keys()
    np.testing.assert_array_equal(keys, jst._keys[:jst._n])
    np.testing.assert_array_equal(keys, ram.keys())
    rows = st.get_rows(keys)
    np.testing.assert_array_equal(rows, jst.get_rows(keys))
    np.testing.assert_array_equal(rows, ram.get_rows(keys))
    _assert_same_tier(st, jst)
    # the streamed chain and the savez chain hold the same bytes' worth
    for name in ("base.npz", "delta-00001.npz"):
        with np.load(tmp_path / "ck0" / name) as a, \
                np.load(tmp_path / "ck2" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                np.testing.assert_array_equal(a[f], b[f])
    # chains load across packages and store classes
    for d in ("ck0", "ck1"):
        path = str(tmp_path / d)
        for loaded in (HostEmbeddingStore.load(path), JaxStore.load(path)):
            np.testing.assert_array_equal(loaded.get_rows(keys), rows)
        sp2 = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / (d + "s")),
                                  cache_rows=16)
        sp2.restore(path)
        np.testing.assert_array_equal(sp2.get_rows(keys), rows)
        jsp2 = JaxSpill(jcfg, spill_dir=str(tmp_path / (d + "j")),
                        cache_rows=16)
        jsp2.restore(path)
        np.testing.assert_array_equal(jsp2.get_rows(keys), rows)


def test_streamed_npz_reads_as_savez(tmp_path):
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(500, 6)).astype(np.float32)
    keys = rng.integers(1, 1 << 50, size=500).astype(np.uint64)
    idx = rng.permutation(500)[:333].astype(np.int64)
    removed = np.array([7, 9], dtype=np.uint64)
    old = sp._STREAM_CHUNK_ROWS
    sp._STREAM_CHUNK_ROWS = 100            # several chunks
    try:
        buf = io.BytesIO()
        sp._write_rows_npz(buf, keys[idx], rows, idx, len(idx),
                           removed=removed)
        base = io.BytesIO()
        sp._write_rows_npz(base, keys, rows, None, 500)
    finally:
        sp._STREAM_CHUNK_ROWS = old
    for b, want in ((buf, dict(keys=keys[idx], rows=rows[idx],
                               removed=removed)),
                    (base, dict(keys=keys, rows=rows))):
        b.seek(0)
        with np.load(b) as z:
            assert sorted(z.files) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(z[k], v)
                assert z[k].dtype == v.dtype
        b.seek(0)
        with zipfile.ZipFile(b) as zf:
            assert zf.getinfo("rows.npy").compress_type == \
                zipfile.ZIP_DEFLATED


def test_autotune_rebalance_and_flags(tmp_path, monkeypatch):
    cfg, jcfg = _cfgs()
    # the autotune's decisions off the same windows
    for stats in (dict(pass_hits=10, pass_misses=90, evicted=40,
                       hot_rows=64),
                  dict(pass_hits=95, pass_misses=5, evicted=0, hot_rows=3),
                  dict(pass_hits=50, pass_misses=50, evicted=1,
                       hot_rows=30),
                  dict(pass_hits=0, pass_misses=0)):
        got = []
        for mod, st_cls, c, d in ((tiering, SpillEmbeddingStore, cfg, "p"),
                                  (jtiering, JaxSpill, jcfg, "j")):
            st = st_cls(c, spill_dir=str(tmp_path / d), cache_rows=512,
                        cache_assoc=4)
            got.append((mod.autotune_cache_rows(st, dict(stats)),
                        st._cache_slots))
        assert got[0] == got[1]
    # end_pass_rebalance under the autotune flag, both packages
    monkeypatch.setattr(flags, "spill_cache_autotune", True)
    monkeypatch.setattr(jax_flags, "spill_cache_autotune", True)
    out = []
    for mod, st_cls, c, d in ((tiering, SpillEmbeddingStore, cfg, "p2"),
                              (jtiering, JaxSpill, jcfg, "j2")):
        st = st_cls(c, spill_dir=str(tmp_path / d),
                    cache_rows=tiering.CACHE_MIN_ROWS)
        # two disjoint sweeps: the second evicts the first (thrash)
        st.lookup_or_init(_keys(0, 4 * tiering.CACHE_MIN_ROWS))
        st.lookup_or_init(_keys(4 * tiering.CACHE_MIN_ROWS,
                                8 * tiering.CACHE_MIN_ROWS))
        out.append((mod.end_pass_rebalance(st), st._cache_slots))
    assert out[0] == out[1]
    assert out[0][0]["cache_resized"] == 1
    assert tiering.end_pass_rebalance(HostEmbeddingStore(cfg)) is None
    # flag-driven construction
    assert isinstance(tiering.store_from_flags(cfg), HostEmbeddingStore)
    monkeypatch.setattr(flags, "table_tiering", "spill")
    monkeypatch.setattr(flags, "spill_cache_rows", 32)
    monkeypatch.setattr(flags, "spill_dir", str(tmp_path / "root"))
    st = tiering.store_from_flags(cfg)
    assert isinstance(st, SpillEmbeddingStore) and st._cache_slots == 32
    st.lookup_or_init(_keys(0, 64))
    # the reference's per-shard layout, shard 0
    assert os.path.exists(tmp_path / "root" / "shard-00" / "rows.dat")
    assert tiering.describe(st) == "spill"
    assert tiering.describe(HostEmbeddingStore(cfg)) is None
    s = tiering.spill_stats(st)
    assert s["cache_rows"] == 32 and s["spill_bytes"] > 0
    assert s["cache_misses"] == 64 and s["assoc"] == 4
    assert tiering.spill_stats(HostEmbeddingStore(cfg)) is None
    assert tiering.fault_in_seconds(st) > 0.0
    # n_shards > 1: a sharded store, every shard spill-backed in its own
    # shard-SS directory
    sh = tiering.store_from_flags(cfg, n_shards=2)
    assert sh.n_shards == 2 and tiering.describe(sh) == "sharded+spill"
    sh.lookup_or_init(_keys(0, 64))
    assert os.path.exists(tmp_path / "root" / "shard-01" / "rows.dat")
    monkeypatch.setattr(flags, "table_tiering", "ssd")
    with pytest.raises(ValueError, match="table_tiering"):
        tiering.store_from_flags(cfg)
    with pytest.raises(ValueError, match="policy"):
        tiering.TierManager(4, policy="lru")


def test_fault_windows_leave_authoritative_rows(tmp_path):
    cfg, _ = _cfgs()
    st = SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / "s"),
                             cache_rows=8)
    keys = _keys(0, 50)
    rows = st.lookup_or_init(keys)
    rows[:, 2] = 3.25
    st.write_back(keys, rows)
    ck = str(tmp_path / "ck")
    st.save_base(ck)
    rows2 = rows.copy()
    rows2[:10, 2] = 7.5
    st.write_back(keys[:10], rows2[:10])
    try:
        # dying before the msync + stream of a delta: the chain stays at
        # the base, the live rows are untouched and the retry lands
        faultpoint.arm("tiering.save.pre_flush", action="ioerror")
        with pytest.raises(faultpoint.FaultInjected):
            st.save_delta(ck)
        faultpoint.disarm()
        np.testing.assert_array_equal(st.get_rows(keys), rows2)
        np.testing.assert_array_equal(
            HostEmbeddingStore.load(ck).get_rows(keys), rows)
        st.save_delta(ck)
        np.testing.assert_array_equal(
            HostEmbeddingStore.load(ck).get_rows(keys), rows2)
        # dying inside the boundary re-scoring: the cache is never
        # authoritative
        faultpoint.arm("tiering.evict.pre", action="ioerror")
        with pytest.raises(faultpoint.FaultInjected):
            st.tier_end_pass()
        faultpoint.disarm()
        np.testing.assert_array_equal(st.get_rows(keys), rows2)
        st.tier_end_pass()
        np.testing.assert_array_equal(st.get_rows(keys), rows2)
    finally:
        faultpoint.disarm()


NUM_SLOTS, DENSE_DIM, BATCH = 4, 3, 32


def _records(schema, n, seed, keys):
    rng = np.random.default_rng(seed)
    lens = [rng.integers(1, 3, n) for _ in range(NUM_SLOTS)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32)
               for _ in range(DENSE_DIM)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats, z64, z64, z32,
                           z32)


def test_training_on_a_spill_store_is_bit_equal(tmp_path):
    """Two passes (a BoxPS pass, then a trainer-owned one) over windows
    whose keys outnumber the cache more than twice: the spill tier is a
    storage choice, never a math change."""
    rng = np.random.default_rng(5)
    all_keys = rng.choice(1 << 50, 600, replace=False).astype(np.int64)
    windows = (all_keys[:400], all_keys[200:600])
    results = {}
    for name in ("ram", "spill"):
        cfg, _ = _cfgs(dim=8)
        store = (HostEmbeddingStore(cfg) if name == "ram" else
                 SpillEmbeddingStore(cfg, spill_dir=str(tmp_path / name),
                                     cache_rows=150))
        schema = DataFeedSchema.ctr(num_sparse=NUM_SLOTS,
                                    num_float=DENSE_DIM, batch_size=BATCH,
                                    max_len=2)
        tr = Trainer(DeepFMModel(NUM_SLOTS, 8, DENSE_DIM, hidden=(16,)),
                     store, schema, TrainerConfig(global_batch_size=BATCH),
                     device="cpu")
        box = BoxPS(store)
        outs = []
        for p, window in enumerate(windows):
            ds = SlotDataset(schema)
            ds.records = _records(schema, 6 * BATCH, p, window)
            if p == 0:
                box.begin_pass()
                outs.append(tr.train_pass(ds))
                outs[-1]["box"] = box.end_pass(trainer=tr)
            else:
                outs.append(tr.train_pass(ds))
        keys = np.unique(all_keys.astype(np.uint64))
        keys = keys[np.isin(keys, store.keys())]
        results[name] = (outs, store.get_rows(keys), store)
    spill = results["spill"][2]
    assert spill._cache_slots < 0.5 * len(spill)
    for a, b in zip(results["ram"][0], results["spill"][0]):
        assert a["loss_mean"] == b["loss_mean"] and a["auc"] == b["auc"]
    np.testing.assert_array_equal(results["ram"][1], results["spill"][1])
    # the boundary ran once a pass: BoxPS.end_pass, then train_pass
    outs = results["spill"][0]
    assert "tiering" in outs[0]["box"] and "tiering" not in outs[0]
    assert outs[1]["tiering"]["pass_misses"] > 0
    assert spill.tier.passes == 2
    assert "tiering" not in results["ram"][0][1]
