"""The slice as a whole: the port's trainer on the incremental, overlapped
pass boundary against the JAX trainer, and every reader of the store
seeing the lazily written-back rows.

- Three checkpointed passes in each package (``BoxPS.end_pass(
  checkpointer=...)``, base_every 3: a base and two deltas), each
  ``train_pass(preload_keys=<the next pass's keys>)``, with a
  pure-eviction shrink between passes 2 and 3: losses at
  tests/golden_deepfm.py's LOSS_TOL, the feed manager's fresh / reused /
  stale / patched counts equal, the store and every array of every chain
  member at TABLE_TOL (keys and tombstones exact);
- ``PassCheckpointer.save``, ``BoxPS.shrink_table``, ``FleetUtil`` saves
  and ``Trainer.resume`` see a pass's rows through the flush hooks;
- resume after a lazy pass rebuilds the working set in full;
- an eval pass between a preload and its pass keeps the staging;
- ``SlotDataset.preload_into_memory`` / ``wait_preload_done``.
"""

import os

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.parser import format_multislot_example
from paddlebox_tpu_torch.embedding import HostEmbeddingStore
from paddlebox_tpu_torch.fleet import FleetUtil
from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer

from tests.test_torch_resume import (LOSS_TOL, STEPS, TABLE_TOL, _dataset,
                                     _make, _store_state)

torch.set_num_threads(1)

MIN_SHOW = 2.0           # the shrink between passes 2 and 3 evicts keys
#                          shown less often (and the preloaded pass-3
#                          keys, still at show 0)


def _ckpt(pkg, root):
    if pkg == "port":
        return PassCheckpointer(root, keep_last_n=3, base_every=3)
    from paddlebox_tpu.utils.pass_ckpt import PassCheckpointer as JaxCkpt
    return JaxCkpt(root, keep_last_n=3, base_every=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(f"inc_{pkg}"))
        store, tr, box = _make(pkg)
        ckpt = _ckpt(pkg, root)
        dss = {p: _dataset(pkg, tr, p) for p in (1, 2, 3)}
        run = {"root": root, "losses": [], "counts": [], "saves": []}
        for p in (1, 2, 3):
            box.set_date(20261017)
            box.begin_pass()
            nxt = dss[p + 1].unique_keys() if p < 3 else None
            st = tr.train_pass(dss[p], metrics=box.metrics,
                               preload_keys=nxt)
            fm = tr.feed_mgr
            run["losses"].append(st["loss_mean"])
            run["counts"].append((fm.last_fresh_rows, fm.last_reused_rows,
                                  fm.last_stale_rows, fm.last_patched_rows))
            # the staging inserts the next pass's fresh keys: join it so
            # the snapshot's key set does not depend on thread timing
            tr.wait_feed_pass_done()
            box.end_pass(checkpointer=ckpt, trainer=tr, dataset=dss[p])
            if pkg == "port":
                run["saves"].append(dict(ckpt.last_save))
            if p == 2:
                box.shrink_table(MIN_SHOW)
        run["store"] = _store_state(store)
        run["tombstones"] = sorted(store._tombstones)
        out[pkg] = run
    return out


def test_preloaded_passes_match_reference(runs):
    port, ref = runs["port"], runs["jax"]
    np.testing.assert_allclose(port["losses"], ref["losses"], **LOSS_TOL)
    assert port["counts"] == ref["counts"]
    fresh, reused, _, patched = zip(*port["counts"])
    assert reused[1] > 0 and reused[2] > 0      # rows stayed on the device
    assert patched[2] > 0          # the shrink overtook pass 3's staging
    np.testing.assert_array_equal(port["store"][0], ref["store"][0])
    np.testing.assert_allclose(port["store"][1], ref["store"][1],
                               **TABLE_TOL)
    assert port["tombstones"] == ref["tombstones"]
    # each save flushed the device rows the passes left unsynced
    for sv in port["saves"]:
        assert sv["flush_bytes"] > 0 and sv["flush_seconds"] >= 0


def test_chain_members_after_lazy_passes_match_reference(runs):
    chains = [os.path.join(runs[pkg]["root"], "chain-0001")
              for pkg in ("port", "jax")]
    members = ["base.npz", "delta-00001.npz", "delta-00002.npz"]
    for name in members:
        with np.load(os.path.join(chains[0], name)) as g, \
                np.load(os.path.join(chains[1], name)) as w:
            assert sorted(g.files) == sorted(w.files), name
            for k in w.files:
                if k == "rows":
                    np.testing.assert_allclose(g[k], w[k], **TABLE_TOL,
                                               err_msg=name)
                else:
                    np.testing.assert_array_equal(g[k], w[k],
                                                  err_msg=f"{name}:{k}")
    with np.load(os.path.join(chains[0], "delta-00002.npz")) as z:
        assert len(z["removed"]) > 0          # the shrink's tombstones


# ---------------------------------------------------------------------------
# the store's readers see the lazy rows through the flush hooks
# ---------------------------------------------------------------------------

def _one_pass(seed=1):
    store, tr, box = _make("port", carry=False)
    ds = _dataset("port", tr, seed)
    box.begin_pass()
    tr.train_pass(ds, metrics=box.metrics)
    keys = ds.unique_keys()
    pre = store.peek_rows(keys)               # the store before any flush
    return store, tr, box, ds, keys, pre


@pytest.mark.parametrize("reader", ["checkpointer", "shrink_table",
                                    "fleet_util", "resume"])
def test_store_readers_flush_the_device_rows(tmp_path, reader):
    store, tr, box, ds, keys, pre = _one_pass()
    # the pass's updates are still on the card only
    np.testing.assert_array_equal(pre[:, 0], 0.0)
    dev = tr.last_ws.table[torch.from_numpy(
        tr.last_ws._tindex.lookup(keys) + 1)][:, :store.cfg.row_width]
    dev = dev.numpy().copy()
    if reader == "checkpointer":
        ckpt = PassCheckpointer(str(tmp_path / "snap"), base_every=2)
        box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
        assert ckpt.last_save["flush_bytes"] == len(keys) * \
            store.cfg.row_width * 4
        saved = HostEmbeddingStore.load(
            str(tmp_path / "snap" / "chain-0001"))
        np.testing.assert_array_equal(saved.get_rows(keys), dev)
    elif reader == "shrink_table":
        box.end_pass()
        evicted = box.shrink_table(MIN_SHOW)
        assert evicted == int((dev[:, 0] < MIN_SHOW).sum()) > 0
        kept = keys[dev[:, 0] >= MIN_SHOW]
        np.testing.assert_array_equal(store.get_rows(kept),
                                      dev[dev[:, 0] >= MIN_SHOW])
    elif reader == "fleet_util":
        box.end_pass()
        fu = FleetUtil(str(tmp_path / "fleet"))
        fu.save_model(store, tr.eval_params(), day=20261017)
        loaded, _, _ = fu.load_model(tr.eval_params())
        np.testing.assert_array_equal(loaded.get_rows(keys), dev)
    else:
        root = str(tmp_path / "snap")
        box.end_pass(checkpointer=PassCheckpointer(root), trainer=tr,
                     dataset=ds)
        store2, tr2, box2 = _make("port", carry=False, seed=3)
        assert tr2.resume(PassCheckpointer(root), box=box2)["pass_id"] == 1
        np.testing.assert_array_equal(store2.get_rows(keys), dev)


def test_resume_after_lazy_pass_rebuilds_in_full(tmp_path):
    """Pass 2's rows are still on the card when the job resumes pass 1's
    snapshot: the restore wins, the unsynced rows are dropped, and the
    next pass builds its working set from the restored store."""
    store, tr, box, ds, keys, _ = _one_pass()
    root = str(tmp_path / "snap")
    box.end_pass(checkpointer=PassCheckpointer(root), trainer=tr,
                 dataset=ds)
    snap = _store_state(store)
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 2), metrics=box.metrics)
    box.end_pass()
    assert tr.feed_mgr.last_reused_rows > 0
    assert tr.resume(PassCheckpointer(root), box=box)["pass_id"] == 1
    got = _store_state(store)
    np.testing.assert_array_equal(got[0], snap[0])
    np.testing.assert_array_equal(got[1], snap[1])
    ds3 = _dataset("port", tr, 3)
    box.begin_pass()
    tr.train_pass(ds3, metrics=box.metrics)
    fm = tr.feed_mgr
    assert fm.last_reused_rows == 0
    assert fm.last_fresh_rows == len(ds3.unique_keys())


def test_eval_pass_keeps_the_train_staging():
    store, tr, box = _make("port", carry=False)
    ds1, ds2 = _dataset("port", tr, 1), _dataset("port", tr, 2)
    tr.train_pass(ds1, preload_keys=ds2.unique_keys())
    tr.wait_feed_pass_done()
    n_keys = len(store)
    dirty = int(store._dirty[:store._n].sum())
    out = tr.eval_pass(_dataset("port", tr, 5, n=3 * 32 + 5))
    assert out["examples"] == 3 * 32 + 5
    assert len(store) == n_keys
    assert int(store._dirty[:store._n].sum()) == dirty
    tr.train_pass(ds2)
    k1, k2 = ds1.unique_keys(), ds2.unique_keys()
    fm = tr.feed_mgr
    assert fm.last_fresh_rows == len(np.setdiff1d(k2, k1))
    assert fm.last_reused_rows == len(np.intersect1d(k1, k2))


def test_failed_pass_closes_the_pass():
    store, tr, box = _make("port", carry=False)
    ds = _dataset("port", tr, 1)
    tr.train_pass(ds)

    def boom(*a, **k):
        raise RuntimeError("step failed")

    tr.train_step = boom
    with pytest.raises(RuntimeError, match="step failed"):
        tr.train_pass(_dataset("port", tr, 2))
    assert not tr.feed_mgr._in_pass
    assert tr.flush_sparse() >= 0             # flushing is legal again


def test_dataset_preload_round_trip(tmp_path):
    schema = DataFeedSchema.ctr(num_sparse=2, num_float=1, batch_size=4,
                                max_len=2)
    rng = np.random.default_rng(0)
    files = []
    for f in range(3):
        lines = []
        for _ in range(10):
            vals = [("label", [float(rng.integers(0, 2))]),
                    ("dense_0", [float(rng.normal())])]
            vals += [(s.name, rng.integers(1, 1 << 40, rng.integers(1, 3))
                      .tolist()) for s in schema.sparse_slots]
            lines.append(format_multislot_example(vals, schema))
        path = str(tmp_path / f"part-{f}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        files.append(path)
    want = SlotDataset(schema)
    want.set_filelist(files)
    want.load_into_memory(global_shuffle=False)
    ds = SlotDataset(schema)
    ds.set_filelist(files)
    ds.preload_into_memory(global_shuffle=False)
    ds.wait_preload_done()
    assert ds.num_examples == want.num_examples == 30
    np.testing.assert_array_equal(ds.unique_keys(), want.unique_keys())
    a, b = next(ds.batches(30)), next(want.batches(30))
    for name in ("ids", "mask", "floats"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    ds.wait_preload_done()                    # nothing pending: no-op
    bad = SlotDataset(schema)
    bad.set_filelist([str(tmp_path / "missing")])
    bad.preload_into_memory()
    with pytest.raises(OSError):
        bad.wait_preload_done()
