"""The port's serving path on the card against the same path on the CPU.
Every test carries the ``cuda`` marker and skips without a CUDA card.
The file imports no JAX, so it runs where only the port's dependencies
are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py

- ``Predictor`` on ``cuda`` (the default) against ``device="cpu"`` on one
  export: probabilities within the zoo tests' MLP tolerance (rtol 2e-3 /
  atol 2e-5: cuBLAS and the CPU BLAS sum in other orders); its module's
  parameters and its staged inputs live on the card;
- a ``ServingServer`` with no device given serves from the card, and a
  ``BatchingFrontend`` over it returns the server's scores.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.data import DataFeedSchema
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.inference import (Predictor, ServingTable,
                                           save_inference_model)
from paddlebox_tpu_torch.models import MMoEModel, DeepFMModel
from paddlebox_tpu_torch.serving import (BatchingFrontend, ServingPublisher,
                                         ServingServer)

pytestmark = pytest.mark.cuda

S, DIM, DENSE = 26, 8, 13
MLP_TOL = dict(rtol=2e-3, atol=2e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _store(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    store = HostEmbeddingStore(EmbeddingConfig(dim=DIM))
    keys = rng.choice(1 << 40, n, replace=False).astype(np.uint64)
    rows = store.lookup_or_init(keys)
    rows[:, 0] = rng.integers(0, 50, n)
    rows[:, 1] = np.minimum(rows[:, 0], rng.integers(0, 5, n))
    rows[:, 2:3 + DIM] = rng.normal(scale=0.1, size=(n, 1 + DIM))
    store.write_back(keys, rows)
    return store, keys


def _request(keys, B, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.choice(keys, (B, S)).astype(np.uint64)
    mask = rng.random((B, S)) < 0.95
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    return ids, mask, dense


@pytest.mark.parametrize("family", ["deepfm", "mmoe"])
def test_predictor_on_the_card_matches_cpu(card, tmp_path, family):
    if family == "deepfm":
        model = DeepFMModel(S, DIM, DENSE, hidden=(400, 400, 400))
    else:
        model = MMoEModel(S, DIM, DENSE, num_experts=2, num_tasks=2,
                          expert_hidden=(64,), expert_out=16,
                          tower_hidden=(16,))
    model.init(torch.Generator().manual_seed(0))
    store, keys = _store()
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE)
    path = str(tmp_path / "export")
    save_inference_model(path, model, weights.model_params(model), store,
                         schema)
    gpu, cpu = Predictor.load(path), Predictor.load(path, device="cpu")
    assert gpu.device.type == "cuda"
    assert all(p.is_cuda for p in gpu.model.parameters())
    ids, mask, dense = _request(keys, 2048)
    staged = gpu.stage(gpu.table.lookup(ids, mask), mask, dense)
    assert all(t.is_cuda for t in staged)
    got = gpu.predict(ids, mask, dense)
    want = cpu.predict(ids, mask, dense)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **MLP_TOL)


def test_server_and_frontend_serve_from_the_card(card, tmp_path):
    model = DeepFMModel(S, DIM, DENSE, hidden=(64, 64))
    model.init(torch.Generator().manual_seed(1))
    store, keys = _store()
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE)
    root = str(tmp_path / "serve")
    pub = ServingPublisher(root, model, schema, quant="int8",
                           publish_base_every=2, hot_top_k=64)
    pub.publish(store, weights.model_params(model), pass_id=1)
    srv = ServingServer(root)
    assert srv.poll_once() == 1
    assert srv.active.predictor.device.type == "cuda"
    ids, mask, dense = _request(keys, 256)
    want = srv.predict(ids, mask, dense)
    fe = BatchingFrontend(srv, max_batch=64, max_wait_s=0.005).start()
    try:
        futs = [fe.submit(ids[i], mask[i], dense[i]) for i in range(256)]
        got = np.asarray([f.result(timeout=60) for f in futs])
    finally:
        fe.stop()
    np.testing.assert_allclose(got, want, **MLP_TOL)
    assert fe.stats()["failures"] == 0
    assert srv.health()["device"] == "cuda"
