"""The step's two dispatch modes on the card: the deferred sparse push
(``flags.push_overlap``) and the k-step superstep
(``TrainerConfig.steps_per_dispatch``), each against the inline single
step on the same card, and against the CPU. Every test carries the
``cuda`` marker and skips without a CUDA card. The file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_dispatch_cuda.py

Small jobs (26 one-hot or multi-hot slots, dim 8 / 16, batch 256, 6
steps a pass, two passes): each layout's two kernels launch once a step
in every mode, one deferred apply lands a step with overlap on and none
at k=4, and the modes agree within tests/golden_deepfm.py's loss and
table tolerances (the kernels' f32 atomics reorder sums, so the card is
not held bitwise).
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.train import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda

S, DENSE, BATCH, STEPS = 26, 13, 256, 6
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
LAYOUTS = {"onehot": (1, 8, ("binned_merge_acc", "merge_update")),
           "multihot": (4, 16, ("gather_pool", "scatter_accumulate"))}
KERNELS = ("gather_pool", "scatter_accumulate", "binned_merge_acc",
           "merge_update")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _flags(monkeypatch):
    monkeypatch.setattr(flags, "push_overlap", flags.push_overlap)


def _records(schema, max_len, seed):
    n = STEPS * BATCH
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, 20000, replace=False).astype(np.int64)
    lens = [rng.integers(1, max_len + 1, n) for _ in range(S)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.25).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats, z64, z64, z32, z32)


def _run(layout, device, overlap="auto", k=1):
    """Two passes of one job; returns (losses, keys, rows, trainer,
    launches of the second pass)."""
    max_len, dim, _ = LAYOUTS[layout]
    flags.push_overlap = overlap
    store = HostEmbeddingStore(EmbeddingConfig(dim=dim, optimizer="adagrad",
                                               learning_rate=0.05))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=max_len)
    tr = Trainer(DeepFMModel(S, dim, DENSE, hidden=(64, 64)), store, schema,
                 TrainerConfig(global_batch_size=BATCH, auc_buckets=1 << 12,
                               steps_per_dispatch=k), seed=0, device=device)
    losses = []
    for p in (1, 2):
        ds = SlotDataset(schema)
        ds.records = _records(schema, max_len, p)
        for name in KERNELS:
            getattr(kernels, name).launches = 0
        out = tr.train_pass(ds)
        launches = {n: getattr(kernels, n).launches for n in KERNELS}
        losses.append(out["loss_mean"])
    keys = np.sort(store.keys())
    return np.array(losses), keys, store.get_rows(keys), tr, launches


def _agree(a, b):
    np.testing.assert_allclose(a[0], b[0], **LOSS_TOL)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[2], b[2], **TABLE_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_deferred_apply_on_the_card(card, layout):
    """Overlap on against off on the card, and against the CPU: the same
    kernels a step, one apply a step, the same training within the
    golden tolerances."""
    on = _run(layout, card, "on")
    off = _run(layout, card, "off")
    want = {n: (STEPS if n in LAYOUTS[layout][2] else 0) for n in KERNELS}
    assert on[4] == want and off[4] == want
    assert on[3].push_overlap and on[3].push_applies == 2 * STEPS
    assert off[3].push_applies == 0
    assert on[3]._push_stager.pending() == 0
    _agree(on, off)
    _agree(on, _run(layout, "cpu", "on"))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_superstep_on_the_card(card, layout):
    """k=4 (a group of 4 and a tail of 2 a pass) against k=1 on the card,
    and against the CPU."""
    k4 = _run(layout, card, k=4)
    k1 = _run(layout, card, k=1)
    want = {n: (STEPS if n in LAYOUTS[layout][2] else 0) for n in KERNELS}
    assert k4[4] == want and k1[4] == want
    assert not k4[3].push_overlap and k4[3].push_applies == 0
    _agree(k4, k1)
    _agree(k4, _run(layout, "cpu", k=4))


def test_superstep_stages_one_buffer_per_array(card):
    """A superstep's fixed-shape arrays cross as one pinned (k, ...)
    buffer each; the push plans stay per batch."""
    max_len, dim, _ = LAYOUTS["multihot"]
    store = HostEmbeddingStore(EmbeddingConfig(dim=dim))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=max_len)
    tr = Trainer(DeepFMModel(S, dim, DENSE, hidden=(64,)), store, schema,
                 TrainerConfig(global_batch_size=BATCH,
                               steps_per_dispatch=4), device=card)
    ds = SlotDataset(schema)
    ds.records = _records(schema, max_len, 1)
    ws = tr.feed_mgr.begin_pass(ds.unique_keys())
    pbs = list(ds.batches(BATCH))[:4]
    host = tr._stack_host([tr._pack_host(ws, pb, pin=False) for pb in pbs])
    assert all(t.is_pinned() for t in host[:4])
    staged = tr.stage(host)
    assert staged[0].shape == (4, BATCH, S * max_len)
    assert staged[0].is_cuda and len(staged[4]) == 4
    assert all(p.uniq.is_cuda for p in staged[4])
