"""The mesh on the card. Every test carries the ``cuda`` marker and skips
without a CUDA card; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

- ``Trainer(mesh=make_mesh(1))`` over NCCL is bit for bit the mesh-less
  trainer on the multi-hot layout (gather_pool and the premerged
  scatter_accumulate push are deterministic; the collectives of one rank
  return their input's bits);
- two ranks on the one card over gloo (tests/torch_multirank_worker.py,
  device "cuda") run the routed pulls and pushes of both table layouts:
  the f32 results equal the single-shard plain versions on the CPU bit
  for bit (exact lattice payloads), the compressed wires stay within
  rtol 2e-2 with exact show/clk columns, and the ranks launch the
  kernels (gather_pool for the pooled pull, scatter_accumulate for the
  sharded apply, merge_update behind the token-level push).
"""

import numpy as np
import pytest
import torch

import torch_multirank_common as common
from torch_multirank_spawn import run_world
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data import slot_record
from paddlebox_tpu_torch.embedding import sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _job(mesh=None, device=None):
    schema = DataFeedSchema.ctr(num_sparse=common.NUM_SLOTS,
                                num_float=common.DENSE_DIM,
                                batch_size=common.BATCH, max_len=2)
    ds = SlotDataset(schema)
    ds.records = common.make_records(slot_record, schema,
                                     common.dataset_arrays(2))
    store = HostEmbeddingStore(EmbeddingConfig(
        dim=common.DIM, learning_rate=common.SPARSE_LR))
    tr = Trainer(DeepFMModel(common.NUM_SLOTS, common.DIM, common.DENSE_DIM,
                             hidden=common.HIDDEN), store, schema,
                 TrainerConfig(global_batch_size=common.BATCH,
                               auc_buckets=common.AUC_BUCKETS),
                 device=device, mesh=mesh)
    return tr, ds, store


def test_world1_nccl_bit_equal_to_meshless(card):
    import torch.distributed as dist

    from paddlebox_tpu_torch.parallel import make_mesh
    mesh = make_mesh(1)
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    runs = []
    for m in (mesh, None):
        tr, ds, store = _job(mesh=m)
        outs = [tr.train_pass(ds) for _ in range(common.PASSES)]
        tr.flush_sparse()
        keys = np.sort(store.keys())
        runs.append((outs, keys, store.get_rows(keys),
                     [p.detach().cpu() for p in tr.params]))
    (om, km, rm, dm), (op, kp, rp, dp) = runs
    for a, b in zip(om, op):
        for k in ("loss_first", "loss_mean", "auc"):
            assert a[k] == b[k], k
    np.testing.assert_array_equal(km, kp)
    np.testing.assert_array_equal(rm, rp)
    for a, b in zip(dm, dp):
        assert torch.equal(a, b)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2_card(card, tmp_path_factory):
    work = tmp_path_factory.mktemp("card2")
    return run_world(str(work), 2, ["ops"], device="cuda")


def _reference():
    cfg = EmbeddingConfig(dim=common.DIM, optimizer="sgd",
                          learning_rate=0.0625)
    case = common.ops_case(2, cfg.row_width, cfg.grad_width)
    table = torch.from_numpy(case["table"])
    args = [torch.from_numpy(case[k]) for k in ("idx", "grads", "shows",
                                                  "clks")]
    pushed = table.clone()
    sharded.push(pushed, *args, cfg)
    return {"pull": sharded.lookup(table, args[0], cfg).numpy(),
            "pooled": sharded.fused_pull_pool(
                table, torch.from_numpy(case["pidx"]), cfg, common.OPS_S,
                common.OPS_L).numpy(),
            "push": pushed.numpy()}


def test_world2_card_routed_ops(world2_card):
    infos, arrays = world2_card
    ref = _reference()

    def gathered(k):
        return np.concatenate([a[k] for a in arrays])

    assert all(i["ops_dropped"] == 0 and not i["jax_loaded"] for i in infos)
    for k in ("pull_single", "pull_single_dedup", "pull_sharded"):
        np.testing.assert_array_equal(gathered(k), ref["pull"])
    for k in ("pull_pooled", "pull_pooled_noplan"):
        np.testing.assert_array_equal(gathered(k), ref["pooled"])
    for k in ("push_single", "push_single_dedup", "push_f32_flat",
              "push_noplan_flat", "push_deferred"):
        np.testing.assert_array_equal(gathered(k), ref["push"])
    for k in ("push_bf16_flat", "push_int8_flat"):
        got = gathered(k)
        np.testing.assert_allclose(got, ref["push"], rtol=2e-2, atol=2e-2)
        np.testing.assert_array_equal(got[:, :2], ref["push"][:, :2])
    for i in infos:
        n = i["launches"]
        assert n["gather_pool"] >= 2            # the two pooled pulls
        assert n["scatter_accumulate"] >= 5     # the sharded applies
        assert n["merge_update"] >= 2           # the token-level pushes
