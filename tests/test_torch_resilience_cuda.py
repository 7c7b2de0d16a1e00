"""The resilient world on the card. Every test carries the ``cuda``
marker and skips without a CUDA card; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_resilience_cuda.py

- the 2 -> 1 elastic kill of tests/test_torch_elastic.py with both ranks
  on cuda:0 (tests/torch_resilience_worker.py, device "cuda") under the
  deterministic scatter_accumulate push engine: the survivor's final
  planes are bit-equal to the simulated shrink's, and its passes launch
  scatter_accumulate;
- a Trainer on the card against a RemoteEmbeddingStore (two in-process
  PSServers) agrees with the same passes on a HostEmbeddingStore on the
  card (the binned push's f32 atomics: rows within rtol 1e-3 / atol
  2e-5, losses within rtol 2e-4 / atol 2e-5) and launches the one-hot
  kernels.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddlebox_tpu_torch.ops import kernels
    kernels.build_kernels()          # before any world forms
    return torch.device("cuda")


def test_elastic_kill_on_the_card_bit_equal_to_simulated_shrink(card,
                                                                tmp_path):
    import torch_resilience_worker as w
    spec = dict(w.ELASTIC_SPEC, device="cuda",
                push_engine="scatter_accumulate")
    live = tmp_path / "live"
    codes, errs = w.run_world(live, spec, 2, {
        "PBTPU_FAULTPOINT": "trainer.step.pre",
        "PBTPU_FAULTPOINT_AFTER": str(w.ELASTIC_STEPS + 1),
        "PBTPU_FAULTPOINT_ONLY_RANK": "1"}, device_ranks=[0, 0])
    assert codes == [0, 137], (codes, errs)
    info = w.read_info(live, 0)
    m = info["drain_snapshot"]["mid_steps"]
    assert info["elected"] == [1, m] and info["members"] == [0]
    assert info["launches"]["scatter_accumulate"] > 0
    sim = tmp_path / "sim"
    codes, errs = w.run_world(sim, dict(spec, sim={"orig_members": [0, 1],
                                                   "dead": [1],
                                                   "elected": [1, m]}), 1)
    assert codes == [0], (codes, errs)
    with np.load(live / "out_0.npz") as a, np.load(sim / "out_0.npz") as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trainer_on_remote_store_on_the_card(card):
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.distributed.ps import (PSClient, PSServer,
                                                    RemoteEmbeddingStore)
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.ops import kernels
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    import torch_resilience_worker as w

    cfg = EmbeddingConfig(dim=8, optimizer="adagrad", learning_rate=0.05)
    schema = DataFeedSchema.ctr(num_sparse=4, num_float=3, batch_size=256,
                                max_len=1)
    keys, rng = w.draw_keys(5000)
    data = [w.make_records(schema, 8 * 256, keys, rng, 1) for _ in range(2)]
    servers = [PSServer().start() for _ in range(2)]
    client = PSClient([(s.host, s.port) for s in servers])
    try:
        out = {}
        for kind in ("remote", "host"):
            store = (RemoteEmbeddingStore(client, "e", cfg)
                     if kind == "remote" else HostEmbeddingStore(cfg))
            tr = Trainer(DeepFMModel(4, 8, 3, hidden=(32, 32)), store,
                         schema, TrainerConfig(global_batch_size=256),
                         seed=3)
            stats = []
            kernels.reset_launches()
            for recs in data:
                ds = SlotDataset(schema)
                ds.records = recs
                stats.append(tr.train_pass(ds))
            launches = w.launch_counts()
            tr.flush_sparse()
            k = np.sort(np.unique(np.concatenate(
                [r.unique_keys() for r in data])).astype(np.uint64))
            out[kind] = (stats, store.peek_rows(k), launches)
        (rs, rr, rl), (hs, hr, hl) = out["remote"], out["host"]
        assert rl == hl and rl["binned_merge_acc"] == 16
        for a, b in zip(rs, hs):
            np.testing.assert_allclose(a["loss_mean"], b["loss_mean"],
                                       rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(rr, hr, rtol=1e-3, atol=2e-5)
    finally:
        client.stop_servers()
        for s in servers:
            s.stop()
