"""The port's host parameter-server cluster
(``paddlebox_tpu_torch.distributed.ps``) against the JAX package's,
tested the reference's way (real localhost sockets, threaded servers
in-process, the standalone server as a subprocess):

- the counterparts of tests/test_ps.py: framing round trip, sparse
  pull/push against a local store with the same in-table optimizer,
  async pushes and their flush, the dense table, save -> shrink -> load,
  a server error raised client-side, concurrent pushers on the striped
  locks, and a deadline on every call;
- the wire across the packages: the framing bytes are the JAX
  package's, a port client on JAX servers and a JAX client on port
  servers pull the same rows after the same pushes;
- a port Trainer on a RemoteEmbeddingStore agrees with one on a
  HostEmbeddingStore, and with the JAX Trainer on its RemoteEmbeddingStore,
  over two passes from the same params and records (losses rtol 2e-5,
  AUC 2e-4, rows rtol 1e-4 / atol 1e-6: tests/test_torch_multirank_train.py's
  tolerances);
- ``python -m paddlebox_tpu_torch.distributed.ps --port 0`` serves.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu.distributed import ps as jps
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg

from paddlebox_tpu_torch.distributed import ps
from paddlebox_tpu_torch.distributed.ps import (PSClient, PSServer,
                                                RemoteEmbeddingStore)
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.embedding.optim import apply_updates

from tests.torch_multirank_common import AUC_ABS, LOSS_REL, TABLE_TOL

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cluster():
    servers = [PSServer().start() for _ in range(2)]
    client = PSClient([(s.host, s.port) for s in servers])
    yield client, servers
    client.stop_servers()
    for s in servers:
        s.stop()


def test_pack_roundtrip_and_bytes_match_reference():
    h = {"cmd": "x", "n": 3}
    arrs = [np.arange(6, dtype=np.uint64).reshape(2, 3),
            np.ones(4, np.float32), np.zeros((0, 5), np.float32)]
    raw = ps._pack(h, arrs)
    assert raw == jps._pack(h, arrs)
    header, out = ps._unpack(raw[8:])
    assert header["cmd"] == "x" and header["n"] == 3
    for a, b in zip(out, arrs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _local_push(local, cfg, pkeys, grads, shows, clks):
    uniq, inv = np.unique(pkeys, return_inverse=True)
    m = np.zeros((len(uniq), cfg.grad_width + 2), np.float32)
    np.add.at(m, inv, np.concatenate([grads, shows[:, None],
                                      clks[:, None]], axis=1))
    rows = local.lookup_or_init(uniq)
    gw = cfg.grad_width
    local.write_back(uniq, apply_updates(
        torch.from_numpy(rows), torch.from_numpy(m[:, :gw]),
        torch.from_numpy(m[:, gw].copy()),
        torch.from_numpy(m[:, gw + 1].copy()), cfg).numpy())


@pytest.mark.parametrize("opt", ["adagrad", "sgd", "adam"])
def test_sparse_pull_push_matches_local_store(cluster, opt):
    client, _ = cluster
    cfg = EmbeddingConfig(dim=4, optimizer=opt, learning_rate=0.1)
    client.create_sparse_table("emb", cfg)
    keys = np.array([1, 2, 3, 4, 5, 1 << 50], dtype=np.uint64)
    pulled = client.pull_sparse("emb", keys)
    assert pulled.shape == (6, cfg.pull_width)
    pkeys = np.array([1, 2, 1], dtype=np.uint64)
    grads = np.ones((3, cfg.grad_width), np.float32) * 0.5
    shows, clks = np.ones(3, np.float32), np.zeros(3, np.float32)
    client.push_sparse("emb", pkeys, grads, shows, clks)
    local = HostEmbeddingStore(cfg)
    local.lookup_or_init(keys)
    _local_push(local, cfg, pkeys, grads, shows, clks)
    got = client.pull_sparse("emb", keys)
    want = local.get_rows(keys)[:, :cfg.pull_width]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    counts = [s["sparse"]["emb"] for s in client.stats()]
    assert sum(counts) == 6 and all(c > 0 for c in counts)


def test_sparse_async_push_flush(cluster):
    client, _ = cluster
    cfg = EmbeddingConfig(dim=2, optimizer="sgd", learning_rate=1.0)
    client.create_sparse_table("t", cfg)
    keys = np.arange(1, 9, dtype=np.uint64)
    client.pull_sparse("t", keys)
    for _ in range(4):
        client.push_sparse("t", keys, np.ones((8, cfg.grad_width),
                                              np.float32),
                           np.ones(8, np.float32), np.zeros(8, np.float32),
                           wait=False)
    client.flush()
    got = client.pull_sparse("t", keys)
    np.testing.assert_allclose(got[:, 0], 4.0)      # shows accumulated
    np.testing.assert_allclose(got[:, 2], -4.0)     # w -= lr * sum(g)
    # a failed async push raises at the flush, not never
    client.push_sparse("nope", keys, np.ones((8, cfg.grad_width),
                                             np.float32),
                       np.ones(8, np.float32), np.zeros(8, np.float32),
                       wait=False)
    with pytest.raises(RuntimeError, match="not created"):
        client.flush()


def test_dense_table(cluster):
    client, _ = cluster
    client.create_dense_table("mlp", np.zeros(16, np.float32), lr=0.5)
    client.push_dense("mlp", np.ones(16, np.float32))
    import time
    for _ in range(200):
        got = client.pull_dense("mlp")
        if np.any(got != 0):
            break
        time.sleep(0.01)
    assert np.all(got != 0)
    # placement by the name's CRC-32: the same server in every process
    import zlib
    assert client._dense_owner("mlp") == zlib.crc32(b"mlp") % 2


def test_save_load_shrink(cluster, tmp_path):
    client, _ = cluster
    cfg = EmbeddingConfig(dim=2)
    client.create_sparse_table("emb", cfg)
    keys = np.arange(1, 33, dtype=np.uint64)
    client.pull_sparse("emb", keys)
    half = keys[:16]
    client.push_sparse("emb", half, np.ones((16, cfg.grad_width),
                                            np.float32),
                       np.ones(16, np.float32), np.zeros(16, np.float32))
    files = client.save("emb", str(tmp_path / "ck"))
    assert len(files) == 2
    before = client.pull_sparse("emb", keys)
    assert client.shrink("emb", min_show=0.5) == 16
    client.load("emb", str(tmp_path / "ck"))
    np.testing.assert_allclose(client.pull_sparse("emb", keys), before,
                               rtol=1e-6)


def test_error_propagates_and_calls_have_a_deadline(cluster):
    client, _ = cluster
    with pytest.raises(RuntimeError, match="not created"):
        client.pull_sparse("nope", np.array([1], dtype=np.uint64))
    # a server that accepts and never answers: the call raises at its
    # deadline instead of hanging
    mute = socket.socket()
    mute.bind(("127.0.0.1", 0))
    mute.listen(1)
    try:
        slow = PSClient([mute.getsockname()], timeout_s=0.5)
        with pytest.raises(OSError):
            slow.stats()
        slow.close()
    finally:
        mute.close()


def test_concurrent_pushers_striped_locks():
    from paddlebox_tpu_torch.distributed.ps import _SparseTable
    cfg = EmbeddingConfig(dim=4, optimizer="sgd", learning_rate=0.01)
    table = _SparseTable(cfg)
    n_threads, n_pushes, n_keys = 8, 20, 500
    rng = np.random.default_rng(0)
    pool = rng.choice(1 << 40, n_keys, replace=False).astype(np.uint64)
    init = {k: r for k, r in zip(pool, table.store.lookup_or_init(pool)
                                 .copy())}
    per_thread = []
    for t in range(n_threads):
        r = np.random.default_rng(t + 1)
        per_thread.append([(r.choice(pool, size=64),
                            r.normal(size=(64, cfg.grad_width))
                            .astype(np.float32)) for _ in range(n_pushes)])
    errors = []

    def worker(batches):
        try:
            for k, g in batches:
                table.push(k, g, np.ones(len(k), np.float32),
                           np.zeros(len(k), np.float32))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(b,)) for b in per_thread]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    show, gsum = {}, {}
    for batches in per_thread:
        for k, g in batches:
            for i, key in enumerate(k):
                show[key] = show.get(key, 0.0) + 1.0
                gsum[key] = gsum.get(key, np.zeros(cfg.grad_width)) \
                    + g[i].astype(np.float64)
    touched = np.array(sorted(show), dtype=np.uint64)
    rows = table.store.get_rows(touched)
    np.testing.assert_allclose(rows[:, 0], [show[k] for k in touched],
                               rtol=0, atol=0)
    want_w = np.stack([init[k][2:2 + cfg.grad_width]
                       - cfg.learning_rate * gsum[k] for k in touched])
    np.testing.assert_allclose(rows[:, 2:2 + cfg.grad_width], want_w,
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the wire across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_cross_package_client_and_servers_agree(client_pkg):
    """A port client on JAX servers (and the reverse) pulls the rows a
    same-package pair pulls, after the same pushes, save and load."""
    keys = np.random.default_rng(3).choice(1 << 45, 200,
                                           replace=False).astype(np.uint64)
    pk = np.random.default_rng(4).choice(keys, 300)
    g = np.random.default_rng(5).normal(size=(300, 9)).astype(np.float32)

    def run(client_mod, server_mod, cfg_cls):
        servers = [server_mod.PSServer().start() for _ in range(2)]
        client = client_mod.PSClient([(s.host, s.port) for s in servers])
        try:
            cfg = cfg_cls(dim=8, optimizer="adagrad", learning_rate=0.05)
            client.create_sparse_table("e", cfg)
            first = client.pull_sparse("e", keys)
            client.push_sparse("e", pk, g, np.ones(300, np.float32),
                               (g[:, 0] > 0).astype(np.float32))
            rows = client.pull_sparse("e", keys, rows=True)
            return first, rows, [s["sparse"]["e"] for s in client.stats()]
        finally:
            client.stop_servers()
            for s in servers:
                s.stop()

    same = run(ps, ps, EmbeddingConfig)
    if client_pkg == "port":
        mixed = run(ps, jps, EmbeddingConfig)
    else:
        mixed = run(jps, ps, JaxCfg)
    ref = run(jps, jps, JaxCfg)
    np.testing.assert_array_equal(mixed[0], ref[0])
    np.testing.assert_array_equal(same[0], ref[0])
    assert mixed[2] == ref[2] == same[2]
    # the in-table optimizer runs on the serving side's package
    np.testing.assert_allclose(mixed[1], ref[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(same[1], ref[1], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# a Trainer on the PS cluster
# ---------------------------------------------------------------------------

def _trainer_run(kind):
    """Two passes of the resume tests' DeepFM job with the table on a
    2-server cluster (``remote``, ``jax-remote``) or local (``host``).
    Returns (pass stats, sorted keys, their rows)."""
    from tests import test_torch_resume as tr_mod
    servers, client = [], None
    try:
        if kind == "host":
            store, tr, box = tr_mod._make("port")
        else:
            mod = ps if kind == "remote" else jps
            pkg = "port" if kind == "remote" else "jax"
            cfg_cls = EmbeddingConfig if pkg == "port" else JaxCfg
            servers = [mod.PSServer().start() for _ in range(2)]
            client = mod.PSClient([(s.host, s.port) for s in servers])
            store = mod.RemoteEmbeddingStore(client, "emb", cfg_cls(
                dim=tr_mod.EMB_DIM, optimizer="adagrad",
                learning_rate=0.05))
            _, tr, box = _make_on(pkg, store)
        pkg = "jax" if kind == "jax-remote" else "port"
        stats = []
        for p in (1, 2):
            ds = tr_mod._dataset(pkg, tr, p)
            box.begin_pass()
            stats.append(tr.train_pass(ds, metrics=box.metrics))
            box.end_pass()
        if pkg == "port":
            tr.flush_sparse()
        keys = np.unique(np.concatenate(
            [tr_mod._dataset(pkg, tr, p).unique_keys() for p in (1, 2)])
        ).astype(np.uint64)
        rows = store.peek_rows(keys)
        return stats, keys, rows
    finally:
        if client is not None:
            client.stop_servers()
        for s in servers:
            s.stop()


def _make_on(pkg, store):
    """``tests.test_torch_resume._make``'s trainer and box on ``store``."""
    from tests import test_torch_resume as tr_mod
    if pkg == "port":
        from paddlebox_tpu_torch import weights
        from paddlebox_tpu_torch.data import DataFeedSchema
        from paddlebox_tpu_torch.fleet import BoxPS
        from paddlebox_tpu_torch.models import DeepFMModel
        from paddlebox_tpu_torch.train import Trainer, TrainerConfig
        schema = DataFeedSchema.ctr(num_sparse=tr_mod.NUM_SLOTS,
                                    num_float=tr_mod.DENSE_DIM,
                                    batch_size=tr_mod.BATCH, max_len=4)
        tr = Trainer(DeepFMModel(tr_mod.NUM_SLOTS, tr_mod.EMB_DIM,
                                 tr_mod.DENSE_DIM, hidden=tr_mod.HIDDEN),
                     store, schema,
                     TrainerConfig(global_batch_size=tr_mod.BATCH,
                                   auc_buckets=tr_mod.AUC_BUCKETS),
                     device="cpu")
        weights.load_deepfm_params(tr.model, tr_mod._init_params(4))
        box = BoxPS(store)
    else:
        from paddlebox_tpu.data import DataFeedSchema as JaxSchema
        from paddlebox_tpu.fleet.boxps import BoxPS as JaxBoxPS
        from paddlebox_tpu.models import DeepFMModel as JaxDeepFM
        from paddlebox_tpu.parallel import make_mesh
        from paddlebox_tpu.train import Trainer as JaxTrainer
        from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig
        schema = JaxSchema.ctr(num_sparse=tr_mod.NUM_SLOTS,
                               num_float=tr_mod.DENSE_DIM,
                               batch_size=tr_mod.BATCH, max_len=4)
        tr = JaxTrainer(JaxDeepFM(num_slots=tr_mod.NUM_SLOTS,
                                  emb_dim=tr_mod.EMB_DIM,
                                  dense_dim=tr_mod.DENSE_DIM,
                                  hidden=tr_mod.HIDDEN),
                        store, schema, make_mesh(1),
                        JaxTrainerConfig(global_batch_size=tr_mod.BATCH,
                                         auc_buckets=tr_mod.AUC_BUCKETS))
        box = JaxBoxPS(store)
    box.init_metric("auc", n_buckets=tr_mod.AUC_BUCKETS)
    return store, tr, box


def test_trainer_on_remote_store_agrees(tmp_path):
    runs = {k: _trainer_run(k) for k in ("remote", "host", "jax-remote")}
    got, want = runs["remote"], runs["host"]
    np.testing.assert_array_equal(got[1], want[1])
    for other in ("host", "jax-remote"):
        ref = runs[other]
        np.testing.assert_array_equal(got[1], ref[1])
        for a, b in zip(got[0], ref[0]):
            for k in ("loss_first", "loss_last", "loss_mean"):
                np.testing.assert_allclose(a[k], b[k], rtol=LOSS_REL,
                                           err_msg=f"{other} {k}")
            assert abs(a["auc"] - b["auc"]) < AUC_ABS
            assert a["steps"] == b["steps"]
        np.testing.assert_allclose(got[2], ref[2], **TABLE_TOL)
    # the trained rows landed on the servers
    assert np.all(got[2][:, 0] > 0)


def test_standalone_server_process():
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.distributed.ps",
         "--port", "0"], cwd=REPO, stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        line = proc.stdout.readline()
        assert line.startswith("ps server listening on "), line
        host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
        client = PSClient([(host, int(port))])
        client.create_sparse_table("e", EmbeddingConfig(dim=2))
        assert client.pull_sparse("e", np.arange(1, 5, dtype=np.uint64)
                                  ).shape == (4, 5)
        assert client.stop_servers() == []
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def test_remote_store_api(cluster, tmp_path):
    """RemoteEmbeddingStore's host-store surface: save_base / load /
    shrink run its flush hooks first, go to every server and (load,
    shrink) count as mutations; len is the servers' sum."""
    client, _ = cluster
    cfg = EmbeddingConfig(dim=4)
    store = RemoteEmbeddingStore(client, "e", cfg)
    keys = np.arange(1, 41, dtype=np.uint64)
    rows = store.lookup_or_init(keys)
    assert len(store) == 40 and not store.supports_resident_reuse
    calls = []
    store.register_flush_hook(lambda: calls.append(1))
    rows[:20, 0] = 3.0
    store.write_back(keys, rows)
    np.testing.assert_array_equal(store.peek_rows(keys), rows)
    store.save_base(str(tmp_path / "b"))
    assert calls == [1]
    assert store.shrink(min_show=1.0) == 20 and len(store) == 20
    store.load(str(tmp_path / "b"))
    np.testing.assert_array_equal(store.peek_rows(keys), rows)
    assert store.mutation_count == 2 and len(calls) == 3
