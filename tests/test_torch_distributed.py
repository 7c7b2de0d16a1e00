"""The port's control plane, case for case against tests/test_distributed.py:
``FileStore``, ``HostCollectives``, ``ShardOwnership``, ``RoleMaker`` and
the launcher, with the JAX package's classes on the same inputs.

The launcher cases spawn real worker processes on localhost (no JAX in
them): two ranks join ``torch.distributed`` over gloo through
``RoleMaker.init_distributed``, build ``make_mesh``, and run the host
collectives, the mesh's device collectives, ``summary_update`` over a
mesh axis and the global AUC; the pytest side holds their numbers to the
JAX package's on the same data.
"""

import json
import os
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu.distributed import FileStore as JaxFileStore
from paddlebox_tpu.distributed import HostCollectives as JaxCollectives
from paddlebox_tpu.distributed import RoleMaker as JaxRoleMaker
from paddlebox_tpu.distributed import ShardOwnership as JaxOwnership

from paddlebox_tpu_torch.distributed import (FileStore, HostCollectives,
                                             RoleMaker, ShardOwnership)
from paddlebox_tpu_torch.distributed.launch import launch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_filestore_set_get_wait(tmp_path):
    st = FileStore(str(tmp_path), timeout_s=2)
    assert st.get("k") is None
    st.set("k", b"v1")
    assert st.get("k") == b"v1"
    st.set("k", b"v2")
    assert st.wait("k") == b"v2"
    with pytest.raises(TimeoutError):
        st.wait("missing", timeout_s=0.1)
    # one store directory, both packages: the same keys and bytes
    jst = JaxFileStore(str(tmp_path), timeout_s=2)
    assert jst.get("k") == b"v2"
    jst.set("j", b"from-jax")
    assert st.wait("j") == b"from-jax"


def _threaded_ranks(tmp_path, world, fn, cls=HostCollectives, store_cls=None,
                    **col_kwargs):
    store = (store_cls or FileStore)(str(tmp_path), timeout_s=20)
    results = [None] * world
    errs = []

    def run(r):
        try:
            results[r] = fn(cls(store, r, world, **col_kwargs), r)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert not errs, errs
    return results


def _collective_body(col, r):
    col.barrier()
    s = col.all_reduce(np.full(4, r + 1.0), op="sum")
    g = col.all_gather(f"host{r}")
    b = col.broadcast({"day": 20260729} if r == 0 else None)
    m = col.all_reduce(np.asarray([float(r)]), op="max")
    return s, g, b, m


def test_collectives_allreduce_gather_bcast(tmp_path):
    got = _threaded_ranks(tmp_path / "port", 3, _collective_body)
    want = _threaded_ranks(tmp_path / "jax", 3, _collective_body,
                           cls=JaxCollectives, store_cls=JaxFileStore)
    for (s, g, b, m), (js, jg, jb, jm) in zip(got, want):
        np.testing.assert_array_equal(s, js)
        np.testing.assert_allclose(s, np.full(4, 6.0))
        assert g == jg == ["host0", "host1", "host2"]
        assert b == jb == {"day": 20260729}
        assert m[0] == jm[0] == 2.0


def test_collectives_repeat_rounds(tmp_path):
    def body(col, r):
        return [float(col.all_reduce(np.asarray([r + i + 0.0]))[0])
                for i in range(3)]

    for got in _threaded_ranks(tmp_path, 2, body):
        assert got == [1.0, 3.0, 5.0]


def test_collectives_store_cleanup(tmp_path):
    def body(col, r):
        for _ in range(12):
            col.all_reduce(np.asarray([1.0]))

    _threaded_ranks(tmp_path, 2, body, cleanup_lag=3)
    files = os.listdir(str(tmp_path))
    assert len(files) <= 3 * 4, sorted(files)


def test_global_auc_across_ranks(tmp_path):
    """Two accumulators with disjoint halves: compute_global over the host
    collectives equals one accumulator fed both, and the JAX package's
    global AUC on the same data."""
    import jax
    from paddlebox_tpu.metrics.auc import AucAccumulator as JaxAcc
    from paddlebox_tpu.metrics.auc import auc_update as jax_auc_update

    from paddlebox_tpu_torch.metrics.auc import AucAccumulator

    rng = np.random.default_rng(0)
    preds = rng.random(400).astype(np.float32)
    labels = (rng.random(400) < preds).astype(np.float32)
    ref = AucAccumulator(1 << 10)
    ref.update(torch.from_numpy(preds), torch.from_numpy(labels))
    want = ref.compute()
    jref = JaxAcc(1 << 10)
    jref.update(jax.jit(jax_auc_update), preds, labels)
    jwant = jref.compute()
    halves = [(preds[:200], labels[:200]), (preds[200:], labels[200:])]

    def body(col, r):
        acc = AucAccumulator(1 << 10)
        acc.update(*(torch.from_numpy(a) for a in halves[r]))
        return acc.compute_global(col)

    for got in _threaded_ranks(tmp_path, 2, body):
        for w in (want, jwant):
            assert got["auc"] == pytest.approx(w["auc"], abs=1e-12)
            assert got["size"] == w["size"]
            assert got["mae"] == pytest.approx(w["mae"], rel=1e-6)


@pytest.mark.parametrize("n_shards,world", [(1, 1), (4, 2), (5, 2), (3, 4),
                                            (8, 3)])
def test_shard_ownership_matches_jax(n_shards, world):
    from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
    from paddlebox_tpu.embedding import ShardedEmbeddingStore as JaxSharded

    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    from paddlebox_tpu_torch.embedding.store import ShardedEmbeddingStore

    keys = np.random.default_rng(5).choice(1 << 50, 300,
                                           replace=False).astype(np.uint64)
    st = ShardedEmbeddingStore(EmbeddingConfig(dim=4), n_shards)
    jst = JaxSharded(JaxCfg(dim=4), n_shards)
    parts = []
    for rank in range(world):
        o, jo = (ShardOwnership(n_shards, world, rank),
                 JaxOwnership(n_shards, world, rank))
        np.testing.assert_array_equal(o.owned, jo.owned)
        assert o.owns_all() == jo.owns_all()
        assert repr(o) == repr(jo)
        got = o.filter_keys(st, keys)
        np.testing.assert_array_equal(got, jo.filter_keys(jst, keys))
        parts.append(got)
        w2 = max(1, world - 1)
        r2 = min(rank, w2 - 1)
        assert (o.with_world(w2, r2).diff(o)
                == jo.with_world(w2, r2).diff(jo))
        assert o == ShardOwnership(n_shards, world, rank)
        assert hash(o) == hash(ShardOwnership(n_shards, world, rank))
    # the world's slices are disjoint and cover the key set
    allk = np.concatenate(parts)
    assert len(allk) == len(keys) and len(np.unique(allk)) == len(keys)
    assert ShardOwnership.for_store(st, world, 0) == (
        None if n_shards == 1 else ShardOwnership(n_shards, world, 0))
    for bad in ((0, 1, 0), (2, 0, 0), (2, 2, 2)):
        with pytest.raises(ValueError):
            ShardOwnership(*bad)
        with pytest.raises(ValueError):
            JaxOwnership(*bad)


def test_role_maker_from_env_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("PBTPU_TRAINER_ID", "1")
    monkeypatch.setenv("PBTPU_TRAINER_ENDPOINTS",
                       "127.0.0.1:7000, 127.0.0.1:7001")
    monkeypatch.setenv("PBTPU_STORE_DIR", str(tmp_path))
    monkeypatch.setenv("PBTPU_RUN_ID", "run7")
    monkeypatch.setenv("PBTPU_COORDINATOR", "127.0.0.1:7002")
    monkeypatch.setenv("LOCAL_RANK", "0")
    rm, jrm = RoleMaker.from_env(), JaxRoleMaker.from_env()
    for k in ("rank", "endpoints", "store_dir", "run_id", "coordinator",
              "world_size", "is_first_worker"):
        assert getattr(rm, k) == getattr(jrm, k), k
    assert rm.local_rank == 0
    col = rm.collectives(timeout_s=5)
    assert (col.rank, col.world) == (1, 2)
    monkeypatch.delenv("PBTPU_RUN_ID")
    with pytest.raises(ValueError, match="PBTPU_RUN_ID"):
        RoleMaker.from_env().collectives()
    with pytest.raises(ValueError, match="PBTPU_RUN_ID"):
        JaxRoleMaker.from_env().collectives()


WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, %(repo)r)
    import torch
    from paddlebox_tpu_torch.distributed import RoleMaker
    from paddlebox_tpu_torch.metrics.auc import AucAccumulator, psum_state
    from paddlebox_tpu_torch.ops.cross_norm import summary_update
    from paddlebox_tpu_torch.parallel import make_mesh
    from paddlebox_tpu_torch.parallel.mesh import num_shards, shard_axes

    rm = RoleMaker.from_env()
    assert rm.world_size == 2, rm
    assert os.environ["LOCAL_RANK"] == str(rm.rank)
    col = rm.collectives(timeout_s=60)
    tot = col.all_reduce(np.full(8, rm.rank + 1.0), op="sum")
    assert tot[0] == 3.0, tot
    assert rm.init_distributed(device="cpu") == "gloo"
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.axis_names) == (2, rm.rank, ("dp",))
    assert (num_shards(mesh), shard_axes(mesh)) == (2, ("dp",))
    assert mesh.table_rows(5) == slice(5 * rm.rank, 5 * rm.rank + 5)
    out = {}
    # the device collectives: tiled all-to-all, psum, pmean, all-gather
    x = torch.arange(6, dtype=torch.int32) + 10 * rm.rank
    out["a2a"] = mesh.all_to_all(x).tolist()
    out["bf16_a2a"] = mesh.all_to_all(
        torch.arange(4, dtype=torch.float32).to(torch.bfloat16)
        + rm.rank).float().tolist()
    out["psum"] = mesh.psum(torch.full((3,), rm.rank + 1.0)).tolist()
    out["pmean"] = mesh.pmean(torch.full((2,), float(rm.rank))).tolist()
    out["gather"] = mesh.all_gather(torch.full((2,), float(rm.rank))).tolist()
    out["slice"] = [mesh.batch_slice(8).start, mesh.batch_slice(8).stop]
    # summary_update over the mesh axis: the batch sums of both ranks
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(2, 5, 3)).astype(np.float32)
    summ = torch.from_numpy(np.stack([np.full(3, 1e4), np.zeros(3),
                                      np.full(3, 1e4)]).astype(np.float32))
    out["summary"] = summary_update(summ, torch.from_numpy(xs[rm.rank]),
                                    axis_name="dp", mesh=mesh).tolist()
    # the global AUC over the mesh's host collectives and psum_state
    preds = rng.random((2, 200)).astype(np.float32)
    labels = (rng.random((2, 200)) < preds).astype(np.float32)
    acc = AucAccumulator(1 << 10)
    acc.update(torch.from_numpy(preds[rm.rank]),
               torch.from_numpy(labels[rm.rank]))
    g = psum_state(acc.dev, mesh)
    out["psum_pos"] = float(g["pos"].sum())
    out["auc"] = acc.compute_global(mesh.collectives())["auc"]
    out["jax_loaded"] = "jax" in sys.modules
    with open(os.path.join(%(work)r, f"out{rm.rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
""")


def test_launcher_two_ranks_mesh_and_collectives(tmp_path):
    from paddlebox_tpu.metrics.auc import AucAccumulator as JaxAcc
    from paddlebox_tpu.metrics.auc import auc_update as jax_auc_update
    from paddlebox_tpu.ops.cross_norm import summary_update as jax_summary

    import jax
    import jax.numpy as jnp

    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"repo": REPO, "work": str(tmp_path)})
    code = launch(2, [sys.executable, str(script)],
                  store_dir=str(tmp_path / "store"),
                  base_env={"OMP_NUM_THREADS": "1"})
    assert code == 0
    outs = []
    for r in range(2):
        with open(tmp_path / f"out{r}.json") as f:
            outs.append(json.load(f))
    assert outs[0]["a2a"] == [0, 1, 2, 10, 11, 12]
    assert outs[1]["a2a"] == [3, 4, 5, 13, 14, 15]
    assert outs[0]["bf16_a2a"] == [0.0, 1.0, 1.0, 2.0]
    for r, o in enumerate(outs):
        assert o["psum"] == [3.0] * 3 and o["pmean"] == [0.5] * 2
        assert o["gather"] == [0.0, 0.0, 1.0, 1.0]
        assert o["slice"] == [4 * r, 4 * r + 4]
        assert not o["jax_loaded"]
    # summary_update(axis_name=) = JAX's update over both ranks' batches
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(2, 5, 3)).astype(np.float32)
    summ = np.stack([np.full(3, 1e4), np.zeros(3),
                     np.full(3, 1e4)]).astype(np.float32)
    want = np.asarray(jax_summary(jnp.asarray(summ),
                                  jnp.asarray(xs.reshape(10, 3))))
    for o in outs:
        np.testing.assert_allclose(o["summary"], want, rtol=1e-6)
    preds = rng.random((2, 200)).astype(np.float32)
    labels = (rng.random((2, 200)) < preds).astype(np.float32)
    jacc = JaxAcc(1 << 10)
    jacc.update(jax.jit(jax_auc_update), preds.reshape(-1),
                labels.reshape(-1))
    for o in outs:
        assert o["auc"] == pytest.approx(jacc.compute()["auc"], abs=1e-12)
        assert o["psum_pos"] == 400 - float(
            (1 - labels).sum())


def test_launcher_propagates_failure(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(3)")
    code = launch(2, [sys.executable, str(script)],
                  store_dir=str(tmp_path / "store"))
    assert code == 3


def test_launcher_module_entry_point(tmp_path):
    """``python -m paddlebox_tpu_torch.distributed.launch --nprocs N --
    <cmd>`` runs like the JAX launcher: every rank sees its id, the
    endpoints, LOCAL_RANK and a run id."""
    import subprocess

    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent(f"""
        import os
        r = os.environ["PBTPU_TRAINER_ID"]
        assert os.environ["LOCAL_RANK"] == r
        assert len(os.environ["PBTPU_TRAINER_ENDPOINTS"].split(",")) == 3
        assert os.environ["PBTPU_RUN_ID"]
        open(os.path.join({str(tmp_path)!r}, "r" + r), "w").close()
    """))
    proc = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu_torch.distributed.launch",
         "--nprocs", "3", "--", sys.executable, str(script)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert proc.returncode == 0
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("r")) == ["r0", "r1", "r2"]


def test_data_generator_pipe(tmp_path):
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.data.data_generator import \
        MultiSlotDataGenerator

    schema = DataFeedSchema.ctr(num_sparse=2, num_float=0, max_len=2)

    class Gen(MultiSlotDataGenerator):
        def generate_sample(self, line):
            a, b = line.split(",")
            yield [("label", [int(a) % 2]), ("slot_0", [int(a)]),
                   ("slot_1", [int(b), int(b) + 1])]

    raw = tmp_path / "raw.csv"
    raw.write_text("3,10\n4,20\n")
    out = tmp_path / "out.txt"
    with open(raw) as fin, open(out, "w") as fout:
        n = Gen(schema).process(fin, out=fout)
    assert n == 2
    ds = SlotDataset(schema)
    ds.set_filelist([str(out)])
    ds.load_into_memory(global_shuffle=False)
    assert ds.num_examples == 2
    np.testing.assert_array_equal(ds.records.sparse_values[0], [3, 4])
    np.testing.assert_array_equal(ds.records.sparse_values[1],
                                  [10, 11, 20, 21])


def test_boxps_attach_collectives_barriers_the_pass():
    """``attach_collectives`` puts a world barrier at ``begin_pass`` and
    ``end_pass`` (the JAX package's lifecycle); with a heartbeat, each
    boundary publishes a beat first and collectives without a watchdog
    get the heartbeat as theirs, as in the JAX package."""
    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
    from paddlebox_tpu_torch.fleet import BoxPS

    class Recorder:
        def __init__(self, calls):
            self.calls = calls
            self.watchdog = None

        def barrier(self, name="barrier"):
            self.calls.append(name)

    class Beat:
        def __init__(self, calls):
            self.calls = calls

        def publish(self):
            self.calls.append("publish")

    box = BoxPS(HostEmbeddingStore(EmbeddingConfig(dim=4)))
    calls = []
    rec = Recorder(calls)
    box.attach_collectives(rec)
    box.begin_pass()
    box.end_pass()
    assert calls == ["begin_pass", "end_pass"]
    calls.clear()
    beat = Beat(calls)
    box.attach_collectives(rec, heartbeat=beat)
    assert rec.watchdog is beat
    box.begin_pass()
    box.end_pass()
    assert calls == ["begin_pass", "publish", "publish", "end_pass"]