"""The port's FeedPassManager and stale-key log against the JAX
package's (``paddlebox_tpu/embedding/feed_pass.py``, ``store.py``).

Both packages' stores and managers are driven through the same key
windows, table edits and store mutations (inputs from a numpy seed or
fixed key windows; the JAX manager runs on the CPU as its own tests run
it). The two packages lay rows out differently (the reference buckets
its row count; the port keeps ``max(min_rows, K + 1)``), so working
sets are compared row by key, with the fresh / reused / stale / patched
counts, and stores array by array after a flush — all bit-identical.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.embedding import store as jax_store_mod
from paddlebox_tpu.embedding.feed_pass import FeedPassManager as JaxManager
from paddlebox_tpu.utils import faultpoint as jax_faultpoint

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.embedding import store as store_mod
from paddlebox_tpu_torch.embedding.feed_pass import FeedPassManager
from paddlebox_tpu_torch.embedding.working_set import (bucket_size,
                                                       fetch_rows,
                                                       transfer_bytes)
from paddlebox_tpu_torch.native.key_index import sorted_unique
from paddlebox_tpu_torch.utils import faultpoint

torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def _restore():
    saved = (flags.incremental_feed, jax_flags.incremental_feed)
    yield
    flags.incremental_feed, jax_flags.incremental_feed = saved
    faultpoint.disarm()
    jax_faultpoint.disarm()


def _cfg(pkg):
    return (EmbeddingConfig if pkg == "port" else JaxCfg)(
        dim=4, optimizer="adagrad", learning_rate=0.1)


def _store(pkg):
    return (HostEmbeddingStore if pkg == "port" else JaxStore)(_cfg(pkg))


def _manager(pkg, store):
    if pkg == "port":
        return FeedPassManager(store, device="cpu")
    return JaxManager(store)


def _set_incremental(on: bool) -> None:
    flags.incremental_feed = jax_flags.incremental_feed = on


def _keys(lo, hi):
    return np.sort(np.arange(lo, hi, dtype=np.uint64)
                   * np.uint64(2654435761) + np.uint64(1))


def _rows_of(ws, keys):
    """The working set's logical rows of ``keys`` (present ones), read
    without marking them touched."""
    idx = ws._tindex.lookup(np.asarray(keys, np.uint64)) + 1
    rw = ws.cfg.row_width
    if torch.is_tensor(ws.table):
        return ws.table[torch.from_numpy(idx)][:, :rw].numpy().copy()
    return np.asarray(ws.table)[idx][:, :rw].copy()


def _edit(pkg, mgr, ws, keys, next_keys):
    """The drill's table edit: every key touched; keys staying into the
    next window get +1 show, the cold tail's show is zeroed (so a
    pure-eviction shrink evicts it), and every w column moves +0.5."""
    idx = ws.translate(keys)
    staying = np.isin(keys, next_keys)
    if pkg == "port":
        t = ws.table
        it = torch.from_numpy(idx.astype(np.int64))
        st = torch.from_numpy(staying)
        t[it[st], 0] += 1.0
        t[it[~st], 0] = 0.0
        t[it, 2] += 0.5
        mgr.end_pass(ws)
    else:
        t = np.asarray(ws.table).copy()
        t[idx[staying], 0] += 1.0
        t[idx[~staying], 0] = 0.0
        t[idx, 2] += 0.5
        mgr.end_pass(ws, jnp.asarray(t))


def _replay(pkg, store, keys, value):
    """A foreign delta replay (``apply_delta_file``) rewriting ``keys``'
    w column to ``value`` in the store."""
    donor = _store(pkg)
    rows = donor.lookup_or_init(keys)
    rows[:, 2] = value
    donor.write_back(keys, rows)
    with tempfile.TemporaryDirectory() as d:
        store.apply_delta_file(donor.save_delta(os.path.join(d, "dd")))


def _store_arrays(store):
    n = store._n
    return {"keys": store._keys[:n].copy(), "rows": store._rows[:n].copy(),
            "dirty": store._dirty[:n].copy(),
            "tombstones": np.array(sorted(store._tombstones), np.uint64)}


# ---------------------------------------------------------------------------
# the stale-key log
# ---------------------------------------------------------------------------

def _log_case(pkg, case):
    """One mutation sequence; returns stale_keys_since(marker) taken
    before it."""
    store = _store(pkg)
    keys = _keys(0, 100)
    rows = store.lookup_or_init(keys)
    rows[:50, 0] = 5.0                    # the first half stays warm
    store.write_back(keys, rows)
    m = store.mutation_marker()
    if case == "pure_eviction":
        store.shrink(min_show=1.0, decay=1.0)
    elif case == "decay_shrink":
        store.shrink(min_show=1.0, decay=0.5)
    elif case == "ingest":
        _replay(pkg, store, _keys(10, 20), 7.0)
    elif case == "remove":
        store._remove(np.concatenate([keys[5:15], _keys(500, 505)]))
    elif case == "restore":
        with tempfile.TemporaryDirectory() as d:
            store.save_base(os.path.join(d, "base"))
            store.restore(os.path.join(d, "base"))
    elif case == "ring_rollover":
        for i in range(store_mod._STALE_LOG_EVENTS + 1):
            _replay(pkg, store, keys[i % 100:i % 100 + 1], float(i))
        m2 = store.mutation_marker()       # a marker inside the window
        _replay(pkg, store, keys[:3], 1.0)
        return store.stale_keys_since(m), store.stale_keys_since(m2)
    elif case == "oversized_event":
        _replay(pkg, store, _keys(200, 220), 3.0)    # 20 keys > cap 16
    elif case == "two_events":
        store.shrink(min_show=1.0, decay=1.0)
        _replay(pkg, store, _keys(0, 10), 2.0)
    return store.stale_keys_since(m), None


@pytest.mark.parametrize("case", ["pure_eviction", "decay_shrink", "ingest",
                                  "remove", "restore", "ring_rollover",
                                  "oversized_event", "two_events"])
def test_stale_keys_since_matches_reference(case, monkeypatch):
    if case == "oversized_event":
        monkeypatch.setattr(store_mod, "_STALE_LOG_MAX_KEYS", 16)
        monkeypatch.setattr(jax_store_mod, "_STALE_LOG_MAX_KEYS", 16)
    got = _log_case("port", case)
    want = _log_case("jax", case)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g is not None and g.dtype == np.uint64
            np.testing.assert_array_equal(g, w)
    expect_none = case in ("decay_shrink", "restore", "ring_rollover",
                           "oversized_event")
    assert (got[0] is None) == expect_none
    if case == "pure_eviction":
        np.testing.assert_array_equal(got[0], _keys(0, 100)[50:])
    if case == "ring_rollover":
        assert got[1] is not None and len(got[1]) == 3


def test_every_mutation_logs_one_event():
    """A mutation that bumps the count without logging would make
    stale_keys_since give up (silently: every boundary a full rebuild)."""
    store = _store("port")
    keys = _keys(0, 40)
    store.lookup_or_init(keys)
    m = store.mutation_marker()
    store.shrink(min_show=-1.0)                       # evicts nothing
    _replay("port", store, keys[:3], 1.0)             # _ingest
    store._remove(keys[3:5])                          # _remove
    assert store.mutation_count - m == len(store._stale_log) == 3
    np.testing.assert_array_equal(store.stale_keys_since(m), keys[:5])


# ---------------------------------------------------------------------------
# the manager against the reference's
# ---------------------------------------------------------------------------

N, CHURN, PASSES = 300, 30, 5
# the store mutation at each boundary (after pass p's end_pass and the
# staging of pass p + 1): a provable pure-eviction shrink, a foreign
# delta replay over resident keys (stale rows), an unprovable decay
# shrink (full rebuild), then nothing (clean reuse)
MUTATIONS = ("evict", "replay", "decay", "none")


def _window(p):
    return _keys(p * CHURN, p * CHURN + N)


def _drive(pkg, incremental, preload, flush_first=False):
    """PASSES passes over the sliding windows with the boundary
    mutations above. ``flush_first``: flush before each mutation, as a
    save would (without it, an unprovable mutation discards the unsynced
    device rows: the store wins, as in the reference)."""
    _set_incremental(incremental)
    store = _store(pkg)
    mgr = _manager(pkg, store)
    per_pass = []
    for p in range(PASSES):
        keys = _window(p)
        ws = mgr.begin_pass(keys)
        per_pass.append(dict(
            rows=_rows_of(ws, keys), fresh=mgr.last_fresh_rows,
            reused=mgr.last_reused_rows, stale=mgr.last_stale_rows,
            patched=mgr.last_patched_rows))
        if p == PASSES - 1:
            break
        nxt = _window(p + 1)
        _edit(pkg, mgr, ws, keys, nxt)
        if preload:
            mgr.begin_feed_pass(nxt)
        kind = MUTATIONS[p % len(MUTATIONS)]
        if flush_first:
            mgr.flush()
        if kind == "evict":
            store.shrink(min_show=0.5, decay=1.0)
        elif kind == "replay":
            _replay(pkg, store, keys[100:110], 42.0)
        elif kind == "decay":
            store.shrink(min_show=0.5, decay=0.5)
    mgr.flush()
    return per_pass, _store_arrays(store), store


@pytest.mark.parametrize("incremental,preload",
                         [(True, True), (True, False), (False, False)])
def test_manager_matches_reference(incremental, preload):
    got, got_store, _ = _drive("port", incremental, preload)
    want, want_store, _ = _drive("jax", incremental, preload)
    for p, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.pop("rows"), w.pop("rows"),
                                      err_msg=f"pass {p}")
        assert g == w, f"pass {p}: {g} != {w}"
    for name in want_store:
        np.testing.assert_array_equal(got_store[name], want_store[name],
                                      err_msg=name)
    if incremental:
        assert sum(g["reused"] for g in got[1:]) > 0
        # the replayed resident rows re-fetch as stale, or, once a
        # staging is in flight, patch it
        key = "patched" if preload else "stale"
        assert sum(g[key] for g in got) >= 10
    else:
        assert all(g["reused"] == 0 for g in got[1:] if g["fresh"] == N)


def test_incremental_bit_parity_with_full_rebuild():
    inc, _, s1 = _drive("port", True, True, flush_first=True)
    full, _, s2 = _drive("port", False, False, flush_first=True)
    for g, w in zip(inc, full):
        np.testing.assert_array_equal(g["rows"], w["rows"])
    every = np.unique(np.concatenate([_window(p) for p in range(PASSES)]))
    live = every[np.isin(every, s2.keys())]
    np.testing.assert_array_equal(np.sort(s1.keys()), np.sort(s2.keys()))
    np.testing.assert_array_equal(s1.get_rows(live), s2.get_rows(live))
    assert sum(g["reused"] for g in inc[1:]) > 0
    assert sum(g["fresh"] for g in inc[1:]) < sum(g["fresh"] for g in full[1:])


def _staged_then_mutated(pkg):
    """Stage pass 2, then mutate the store: the staging is patched with
    the rewritten rows, not discarded."""
    _set_incremental(True)
    store = _store(pkg)
    mgr = _manager(pkg, store)
    k1 = _keys(0, 300)
    ws1 = mgr.begin_pass(k1)
    ws1.translate(k1)
    mgr.end_pass(ws1, ws1.table)
    k2 = np.unique(np.concatenate([k1[50:], _keys(9000, 9050)]))
    mgr.begin_feed_pass(k2)
    mgr.wait_feed_pass_done()
    # (a) resident, (b) freshly staged and (c) retiring keys rewritten
    mut = np.unique(np.concatenate([k1[60:70], _keys(9000, 9010), k1[:5]]))
    _replay(pkg, store, mut, 13.0)
    ws2 = mgr.begin_pass(k2)
    counts = (mgr.last_fresh_rows, mgr.last_patched_rows,
              mgr.last_reused_rows)
    return _rows_of(ws2, k2), counts


def test_staged_feed_patched_after_mutation():
    got, counts = _staged_then_mutated("port")
    want, jcounts = _staged_then_mutated("jax")
    np.testing.assert_array_equal(got, want)
    assert counts == jcounts == (50, 20, 250)
    k2 = np.unique(np.concatenate([_keys(0, 300)[50:], _keys(9000, 9050)]))
    hit = np.isin(k2, np.concatenate([_keys(0, 300)[60:70],
                                      _keys(9000, 9010)]))
    np.testing.assert_array_equal(got[hit, 2], 13.0)


def _mismatch(pkg):
    store = _store(pkg)
    mgr = _manager(pkg, store)
    p1 = _keys(0, 100)
    ws1 = mgr.begin_pass(p1)
    ws1.translate(p1)
    mgr.end_pass(ws1, ws1.table)
    mgr.begin_feed_pass(_keys(100, 200))     # staged for the wrong keys
    actual = _keys(50, 250)
    ws2 = mgr.begin_pass(actual)
    return (_rows_of(ws2, actual), mgr.last_fresh_rows,
            mgr.last_reused_rows, store.get_rows(actual))


def test_staging_discarded_on_key_mismatch():
    rows, fresh, reused, stored = _mismatch("port")
    jrows, jfresh, jreused, _ = _mismatch("jax")
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(rows, stored)
    assert (fresh, reused) == (jfresh, jreused) == (150, 50)


def test_feed_error_reraised_at_wait():
    store = _store("port")
    mgr = _manager("port", store)
    ws = mgr.begin_pass(_keys(0, 10))
    ws.translate(_keys(0, 10))
    mgr.end_pass(ws)

    def boom(keys):
        raise RuntimeError("feed fetch failed")

    orig, store.lookup_or_init = store.lookup_or_init, boom
    try:
        mgr.begin_feed_pass(_keys(5, 20))
        with pytest.raises(RuntimeError, match="feed fetch failed"):
            mgr.wait_feed_pass_done()
    finally:
        store.lookup_or_init = orig
    mgr.wait_feed_pass_done()                 # raised once, then clear
    ws2 = mgr.begin_pass(_keys(5, 20))
    np.testing.assert_array_equal(ws2.sorted_keys, _keys(5, 20))
    assert mgr.last_reused_rows == 5


def _eval_case(pkg):
    """Train pass 1, stage pass 2, then an eval pass over resident and
    unseen keys, then train pass 2."""
    store = _store(pkg)
    mgr = _manager(pkg, store)
    k1 = _keys(0, 100)
    ws1 = mgr.begin_pass(k1)
    _edit(pkg, mgr, ws1, k1, k1)
    k2 = np.unique(np.concatenate([k1[20:], _keys(7000, 7030)]))
    mgr.begin_feed_pass(k2)
    mgr.wait_feed_pass_done()
    n_keys, dirty = len(store), int(store._dirty[:store._n].sum())
    ev_keys = np.unique(np.concatenate([k1[:50], _keys(8000, 8020)]))
    ev = mgr.begin_pass(ev_keys, test_mode=True)
    ev_rows = _rows_of(ev, ev_keys)
    ev_counts = (mgr.last_fresh_rows, mgr.last_reused_rows)
    grew = (len(store) != n_keys
            or int(store._dirty[:store._n].sum()) != dirty)
    retained = mgr._current is ws1
    ws2 = mgr.begin_pass(k2)
    return (ev_rows, ev_counts, grew, retained, _rows_of(ws2, k2),
            (mgr.last_fresh_rows, mgr.last_reused_rows))


def test_eval_pass_reuses_but_never_inserts_or_retains():
    got = _eval_case("port")
    want = _eval_case("jax")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == (20, 50)
    assert not got[2] and not want[2]         # store neither grown nor dirty
    assert got[3] and want[3]                 # the train set stays retained
    np.testing.assert_array_equal(got[4], want[4])
    # the train staging survived the eval and was consumed by pass 2
    assert got[5] == want[5] == (30, 80)
    # eval saw the trained (device) values of resident rows
    np.testing.assert_array_equal(got[0][:50, 2], want[0][:50, 2])


def test_flush_refused_while_a_pass_is_open():
    store = _store("port")
    mgr = _manager("port", store)
    keys = _keys(0, 50)
    ws = mgr.begin_pass(keys)
    _edit("port", mgr, ws, keys, keys)
    mgr.pass_opened()
    with pytest.raises(RuntimeError, match="training pass is open"):
        mgr.flush()
    with pytest.raises(RuntimeError, match="training pass is open"):
        store.get_rows(keys)                  # the store's flush hook
    mgr.pass_closed()
    assert mgr.flush() == transfer_bytes(store.cfg, len(keys))
    np.testing.assert_array_equal(store.get_rows(keys)[:, 0], 1.0)


def test_delta_stage_ioerror_leaves_manager_usable():
    _set_incremental(True)
    store = _store("port")
    mgr = _manager("port", store)
    k1 = _keys(0, 100)
    ws1 = mgr.begin_pass(k1)
    _edit("port", mgr, ws1, k1, k1)
    faultpoint.arm("feed_pass.delta_stage.pre", action="ioerror")
    k2 = _keys(50, 150)
    with pytest.raises(OSError):
        mgr.begin_pass(k2)
    faultpoint.disarm()
    ws2 = mgr.begin_pass(k2)
    np.testing.assert_array_equal(ws2.sorted_keys, k2)
    assert (mgr.last_fresh_rows, mgr.last_reused_rows) == (50, 50)
    # the trained rows carried over; the retiring ones were written back
    np.testing.assert_array_equal(_rows_of(ws2, k1[50:])[:, 2],
                                  store.get_rows(k1[50:])[:, 2])
    np.testing.assert_array_equal(store.get_rows(k1[:50])[:, 0], 1.0)


def test_flush_faultpoint_keeps_rows_unsynced():
    store = _store("port")
    mgr = _manager("port", store)
    keys = _keys(0, 30)
    ws = mgr.begin_pass(keys)
    _edit("port", mgr, ws, keys, keys)
    faultpoint.arm("feed_pass.flush.pre", action="ioerror")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(OSError):
            store.save_base(os.path.join(d, "base"))
        faultpoint.disarm()
        store.save_base(os.path.join(d, "base"))   # the retry flushes
        saved = HostEmbeddingStore.load(os.path.join(d, "base"))
    np.testing.assert_array_equal(saved.get_rows(keys)[:, 0], 1.0)


def test_helpers_and_unported_options():
    assert [bucket_size(x) for x in (1, 16, 17, 100, 1000)] == \
        [1, 16, 20, 112, 1024]
    cfg = _cfg("port")
    t = torch.arange(60, dtype=torch.float32).reshape(5, 12)
    rows, nbytes = fetch_rows(t, np.array([3, 1]), cfg)
    np.testing.assert_array_equal(rows, t[[3, 1], :cfg.row_width].numpy())
    assert nbytes == transfer_bytes(cfg, 2) == 2 * cfg.row_width * 4
    store = _store("port")
    for kw in (dict(mesh=object()), dict(ownership=object())):
        with pytest.raises(NotImplementedError, match="item 11"):
            FeedPassManager(store, device="cpu", **kw)
    mgr = FeedPassManager(store, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        mgr.set_replica(object())
    mgr.close()
    assert mgr._hook not in store._flush_hooks


@pytest.mark.parametrize("case", ["random_u64", "signed_i64", "sorted",
                                  "empty", "one", "all_equal"])
def test_sorted_unique_is_np_unique(case):
    """The boundary's key dedup (a sort, not numpy's hash-based unique)
    gives np.unique's array: values, order and dtype."""
    rng = np.random.default_rng(11)
    a = {"random_u64": rng.integers(0, 1 << 64, 5000, dtype=np.uint64,
                                    endpoint=False)[rng.integers(0, 5000,
                                                                 20000)],
         "signed_i64": rng.integers(-(1 << 62), 1 << 62, 3000,
                                    dtype=np.int64)[rng.integers(0, 3000,
                                                                 9000)],
         "sorted": _keys(0, 1000),
         "empty": np.zeros(0, np.uint64),
         "one": np.array([7], np.int64),
         "all_equal": np.full(50, 3, np.uint64)}[case]
    got = sorted_unique(a.copy())
    want = np.unique(a)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_store_forbidding_reuse_gets_eager_write_back():
    """A store shared between trainers (supports_resident_reuse False):
    every pass rebuilds in full and end_pass writes the touched rows back
    at once."""
    class SharedStore(HostEmbeddingStore):
        supports_resident_reuse = False

    store = SharedStore(_cfg("port"))
    mgr = FeedPassManager(store, device="cpu")
    keys = _keys(0, 40)
    for p in range(2):
        ws = mgr.begin_pass(keys)
        assert (mgr.last_fresh_rows, mgr.last_reused_rows) == (40, 0)
        _edit("port", mgr, ws, keys, keys)
        assert mgr.last_d2h_bytes == transfer_bytes(store.cfg, 40)
        np.testing.assert_array_equal(store.peek_rows(keys)[:, 0], p + 1)
    assert mgr.flush() == 0


def test_staging_races_store_mutations():
    """The feed thread stages while the main thread shrinks the store (the
    drill's order), with the interpreter switching threads as often as it
    can: whichever runs first, the stores end bit-identical to the full
    rebuild's."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runs = []
        for incremental in (True, False):
            _set_incremental(incremental)
            store = _store("port")
            mgr = _manager("port", store)
            for p in range(6):
                keys, nxt = _window(p), _window(p + 1)
                ws = mgr.begin_pass(keys)
                _edit("port", mgr, ws, keys, nxt)
                if incremental and p < 5:
                    mgr.begin_feed_pass(nxt)
                store.shrink(min_show=0.5, decay=1.0)
            mgr.close()
            assert mgr._thread is None
            runs.append((store.keys(), store._rows[:len(store)].copy()))
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
