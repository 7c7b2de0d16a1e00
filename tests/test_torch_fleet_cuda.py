"""The serving fleet, the router and the exported program on the card.
Every test carries the ``cuda`` marker and skips without a CUDA card;
the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py

- a ``ReplicaFleet`` with no device named runs its two replica
  processes on the card (``--device cuda``, a CUDA context each on
  cuda:0); behind the ``Router`` they serve v1 from one staged copy with
  the scores of a ``Predictor`` on the card (rtol 1e-5, atol 1e-6), and
  stopping the fleet leaves no replica alive;
- ``LocalReplica``s (a ``FleetReplicaServer`` and a ``BatchingFrontend``
  each, in process, on the card) behind the router answer the same;
- ``export_stablehlo`` traces on the card by default and
  ``load_stablehlo`` places the program on the card by default, or on
  the CPU when asked; both equal ``Predictor.predict``.
"""

import os
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.inference import Predictor, ServingTable
from paddlebox_tpu_torch.inference.stablehlo import (export_stablehlo,
                                                     load_stablehlo)
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.serving import BatchingFrontend, ServingPublisher
from paddlebox_tpu_torch.serving.fleet import (FleetReplicaServer,
                                               LocalReplica, ReplicaFleet,
                                               SharedStagingCache)
from paddlebox_tpu_torch.serving.router import Router
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, DIM, DENSE, BATCH = 4, 8, 1, 64
FWD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _records(schema, n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, 400, replace=False).astype(np.int64)
    vals = [rng.choice(keys, n) for _ in range(S)]
    offs = [np.arange(n + 1, dtype=np.int64) for _ in range(S)]
    floats = [(rng.random(n) < 0.3).astype(np.float32),
              rng.normal(size=n).astype(np.float32)]
    z = np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats,
                           np.arange(n, dtype=np.uint64),
                           np.zeros(n, np.uint64), z, z)


@pytest.fixture(scope="module")
def job(card, tmp_path_factory):
    """One pass trained on the card and published as v1."""
    root = str(tmp_path_factory.mktemp("fleet") / "serve")
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH)
    store = HostEmbeddingStore(EmbeddingConfig(dim=DIM, learning_rate=0.15))
    model = DeepFMModel(S, DIM, DENSE, hidden=(16,))
    tr = Trainer(model, store, schema,
                 TrainerConfig(global_batch_size=BATCH, dense_lr=3e-3))
    ds = SlotDataset(schema)
    ds.records = _records(schema, 4 * BATCH, 0)
    box = BoxPS(store)
    pub = ServingPublisher(root, model, schema, publish_base_every=1,
                           quant="f32")
    box.begin_pass()
    tr.train_pass(ds)
    box.end_pass(trainer=tr, publisher=pub)
    pb = next(iter(ds.batches(BATCH)))
    _, dense = tr.split_floats(pb.floats)
    req = (pb.ids.astype(np.uint64), pb.mask, dense)
    want = Predictor(model, tr.eval_params(), ServingTable.from_store(store),
                     schema).predict(*req)
    return root, schema, tr, store, req, want


def _wait(cond, timeout_s, what):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def _health(rep):
    try:
        return rep.health()
    except Exception:   # noqa: BLE001 — a replica before its bind
        return {}


def test_subprocess_fleet_on_the_card(job, tmp_path):
    root, _, _, _, req, want = job
    fleet = ReplicaFleet(root, replicas=2, workdir=str(tmp_path / "fw"),
                         poll_s=0.1, supervise_tick_s=0.05, window_s=0,
                         replica_env=lambda i: {"PYTHONPATH": REPO})
    assert fleet.device == "cuda"
    router = Router(fleet.replicas, timeout_s=60.0, health_ttl_s=0.2)
    fleet.attach_router(router)
    fleet.start()
    procs = [r.proc for r in fleet.replicas]
    try:
        _wait(lambda: all(_health(r).get("active_version") == 1
                          for r in fleet.replicas), 180, "v1 on both")
        for _ in range(4):
            np.testing.assert_allclose(router.score(*req), want, **FWD_TOL)
        assert sorted(os.listdir(os.path.join(
            fleet.staging_root, "versions"))) == ["v-000001"]
        assert router.stats()["failures"] == 0
    finally:
        fleet.stop()
    assert all(p.poll() is not None for p in procs)


def test_local_replicas_on_the_card(job, tmp_path):
    root, _, _, _, req, want = job
    cache = SharedStagingCache(str(tmp_path / "staging"))
    reps = []
    for i in range(2):
        srv = FleetReplicaServer(root, staging_cache=cache)
        assert srv.device.type == "cuda" and srv.poll_once() == 1
        reps.append(LocalReplica(f"r{i}", srv, BatchingFrontend(
            srv, max_batch=BATCH, max_wait_s=0.002).start()))
    try:
        router = Router(reps, timeout_s=60.0, health_ttl_s=1.0)
        ids, mask, dense = req
        for i in range(8):
            got = router.score(ids[i], mask[i], dense[i])
            np.testing.assert_allclose(got, want[i], **FWD_TOL)
        assert cache.downloads == 1
    finally:
        for r in reps:
            r.frontend.stop()
            r.server.stop()


def test_exported_program_on_the_card(job, tmp_path):
    root, schema, tr, store, req, want = job
    table = ServingTable.from_store(store)
    path = str(tmp_path / "prog")
    export_stablehlo(path, tr.model, tr.eval_params(), schema,
                     batch_size=BATCH, pull_width=table.pull_width)
    ids, mask, dense = req
    pulled = table.lookup(ids, mask)
    call = load_stablehlo(path)
    assert call.device.type == "cuda"
    params = list(call.program.parameters())
    assert params and all(p.device.type == "cuda" for p in params)
    np.testing.assert_allclose(call(pulled, mask, dense), want, **FWD_TOL)
    on_cpu = load_stablehlo(path, device="cpu")
    np.testing.assert_allclose(on_cpu(pulled, mask, dense), want, **FWD_TOL)
