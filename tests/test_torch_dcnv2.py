"""DLRM-DCNv2 in the port (``models/dlrm.py``'s ``DLRMDCNv2Model`` over
``models/dcn.py``'s ``LowRankCrossNet``), which the JAX package lacks, so
it is held against its formula and the benchmark's plain reference
(``portbench/reference/dlrm_dcnv2.py``, plain torch):

- the low-rank cross against x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l
  in float64, values and gradients;
- the model against the reference on seeded weights at a small size:
  logits and every parameter's and every pulled row's gradient, from
  raw tokens (the gather + seqpool pull) and from pooled slots (the
  fused pull);
- training through ``BoxPS.begin_pass`` -> ``train_pass(preload_keys=)``
  -> ``end_pass``: uneven hotness resolves to ``gather_seqpool``, even
  to the fused pull, the push premerges, the pull counts its tokens, and
  the unread first-order w column never moves;
- the ``interaction`` span, and ``attribute_step``'s isolated
  ``interaction`` for this model and not for ``DLRMModel``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.schema import Slot, SlotType
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS
from paddlebox_tpu_torch.models import DLRMDCNv2Model, DLRMModel
from paddlebox_tpu_torch.models.dcn import LowRankCrossNet
from paddlebox_tpu_torch.monitor.registry import STATS
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils import step_probe

from portbench import program
from portbench.reference import ctr
from portbench.reference import dlrm_dcnv2 as ref

torch.set_num_threads(1)

S, DENSE, DIM, BATCH = 4, 5, 8, 32
UNEVEN = [3, 1, 2, 1]
CFG = {"family": "dlrm_dcnv2", "num_sparse": S, "num_dense": DENSE,
       "embedding_dim": DIM, "bottom_hidden": [16], "top_hidden": [16, 8],
       "dcn_num_layers": 2, "dcn_low_rank_dim": 4, "hotness": UNEVEN}
ECFG = EmbeddingConfig(dim=DIM, optimizer="adagrad", learning_rate=0.05,
                       initial_range=0.02)


def _model(cfg=CFG):
    return DLRMDCNv2Model(cfg["num_sparse"], cfg["embedding_dim"],
                          cfg["num_dense"],
                          bottom_hidden=tuple(cfg["bottom_hidden"]),
                          top_hidden=tuple(cfg["top_hidden"]),
                          num_cross_layers=cfg["dcn_num_layers"],
                          low_rank_dim=cfg["dcn_low_rank_dim"])


def _seeded(cfg=CFG, seed=5):
    """The model and the reference's parameters, the same seeded values."""
    params = ctr.make_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    model = _model(cfg)
    weights.load_model_params(model, program.param_tree(params))
    return model, params


def test_low_rank_cross_matches_its_formula():
    dim, rank, layers = 12, 4, 3
    net = LowRankCrossNet(dim, rank, layers)
    net.init(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for layer in net:
            layer.w.b.normal_(0, 0.1)
    # in f64 both sides, so the formula is held to f64 rounding alone
    net.double()
    gen = torch.Generator().manual_seed(2)
    x0 = torch.randn(6, dim, generator=gen, dtype=torch.float64)
    cot = torch.randn(6, dim, generator=gen, dtype=torch.float64)
    params = [t for layer in net for t in (layer.v.w, layer.w.w, layer.w.b)]
    x0.requires_grad_()
    got = net(x0)
    g_got = torch.autograd.grad((got * cot).sum(), [x0, *params])

    p64 = [p.detach().double().requires_grad_() for p in params]
    x64 = x0.detach().double().requires_grad_()
    x = x64
    for v, w, b in zip(p64[0::3], p64[1::3], p64[2::3]):
        x = x64 * ((x @ v) @ w + b) + x
    g_want = torch.autograd.grad((x * cot).sum(), [x64, *p64])
    torch.testing.assert_close(got, x.detach(), rtol=1e-12, atol=1e-12)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # V projects without a bias; every layer keeps the input's width
    assert all(layer.v.b is None for layer in net)
    assert [tuple(layer.v.w.shape) for layer in net] == [(dim, rank)] * 3


def test_parameters_are_the_references():
    model = _model()
    got = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert sorted(got) == sorted(ref.param_shapes(CFG))
    assert model.top_in == (S + 1) * DIM
    assert model.pooled_pull_ok


@pytest.mark.parametrize("pooled", [False, True], ids=["tokens", "pooled"])
def test_model_matches_the_plain_reference(pooled):
    """Logits and every gradient: the dense parameters' and the pulled
    rows' (w and embedding columns), the reference pooling the tokens
    itself."""
    model, params = _seeded()
    gen = torch.Generator().manual_seed(7)
    T = sum(UNEVEN)
    rows = torch.randn(BATCH, T, 3 + DIM, generator=gen) * 0.5
    dense = torch.randn(BATCH, DENSE, generator=gen)
    labels = (torch.rand(BATCH, generator=gen) < 0.3).float()
    seg = np.repeat(np.arange(S), UNEVEN)
    mask = torch.ones(BATCH, T, dtype=torch.bool)

    pulled = rows.clone().requires_grad_()
    if pooled:
        pooled_rows = ctr.pool(CFG, pulled)
        logit = model(PooledSlots(pooled_rows), mask, dense, seg, S)
    else:
        logit = model(pulled, mask, dense, seg, S)
    loss = F.binary_cross_entropy_with_logits(logit, labels)
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, [*model.parameters(), pulled])

    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    w = rows[..., 2].clone().requires_grad_()
    x = rows[..., 3:].clone().requires_grad_()
    want_logit = ref.forward(CFG, p, ctr.pool(CFG, w), ctr.pool(CFG, x),
                             dense, "float32")
    want_loss = F.binary_cross_entropy_with_logits(want_logit, labels)
    want = torch.autograd.grad(want_loss, [p[n] for n in names] + [w, x])

    torch.testing.assert_close(logit, want_logit, rtol=1e-5, atol=1e-6)
    for n, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7, msg=n)
    g_rows = got[-1]
    torch.testing.assert_close(g_rows[..., 3:], want[-1], rtol=1e-4,
                               atol=1e-7)
    # the first-order w is pooled and not read: zero gradient, as the
    # reference's, and show/clk are counters
    assert not g_rows[..., :3].any() and not want[-2].any()


def _schema(hotness):
    slots = [Slot("label", SlotType.FLOAT, max_len=1)]
    slots += [Slot(f"dense_{i}", SlotType.FLOAT, max_len=1)
              for i in range(DENSE)]
    slots += [Slot(f"slot_{i}", SlotType.UINT64, max_len=h)
              for i, h in enumerate(hotness)]
    return DataFeedSchema(slots, batch_size=BATCH)


def _dataset(schema, hotness, n, seed):
    """n examples, slot s holding hotness[s] ids each from its own 60."""
    rng = np.random.default_rng(seed)
    vals = [(np.uint64(s + 1) << np.uint64(40))
            + rng.integers(0, 60, n * h).astype(np.uint64)
            for s, h in enumerate(hotness)]
    offs = [np.arange(n + 1, dtype=np.int64) * h for h in hotness]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    ds = SlotDataset(schema)
    ds.records = SlotRecordBatch(schema, n, [v.view(np.int64) for v in vals],
                                 offs, floats, z64, z64, z32, z32)
    return ds, np.unique(np.concatenate(vals))


def _trainer(hotness, model=None):
    store = HostEmbeddingStore(ECFG)
    schema = _schema(hotness)
    tr = Trainer(model if model is not None else _model(), store, schema,
                 TrainerConfig(dense_lr=1e-3, dense_optimizer="adam",
                               global_batch_size=BATCH),
                 seed=3, device="cpu")
    return store, schema, tr


@pytest.mark.parametrize("hotness,engine", [
    (UNEVEN, "gather_seqpool"), ([2] * S, "fused_gather_pool")],
    ids=["uneven", "even"])
def test_trains_through_boxps(hotness, engine, monkeypatch):
    """On the card auto takes ``scatter_accumulate`` over premerged lanes
    at these rows; the CPU forces it (its plain version), so the pack
    builds the dedup plan the card's steps premerge with."""
    assert kernels.resolve_push_engine(ECFG, 1 << 20, premerged=True,
                                       device_type="cuda") == \
        "scatter_accumulate"
    monkeypatch.setattr(flags, "push_engine", "scatter_accumulate")
    store, schema, tr = _trainer(hotness)
    box = BoxPS(store)
    box.set_date(20240101)
    data = [_dataset(schema, hotness, 2 * BATCH, s) for s in (1, 2, 3)]
    try:
        assert tr.pull_engine == engine
        assert tr.push_premerged()
        tokens0 = STATS.get("trainer.tokens")
        plans0 = STATS.get("trainer.plan_tokens")
        keys = np.union1d(data[0][1], data[1][1])
        rows0 = store.peek_rows(keys)           # the init rows
        for (ds, _), (_, nxt) in zip(data[:2], data[1:]):
            box.begin_pass()
            out = tr.train_pass(ds, preload_keys=nxt)
            box.end_pass()
            assert out["steps"] == 2 and np.isfinite(out["loss_mean"])
            assert tr.resolved_push_engine(tr.last_ws) == \
                "scatter_accumulate"
        tokens = 4 * BATCH * sum(hotness)
        assert STATS.get("trainer.tokens") - tokens0 == tokens
        assert STATS.get("trainer.plan_tokens") - plans0 == tokens
        rows1 = store.get_rows(keys)
    finally:
        tr.feed_mgr.close()
    # show counts every token; the embeddings train; the unread w stays
    assert rows1[:, 0].sum() - rows0[:, 0].sum() == tokens
    assert np.abs(rows1[:, 3:3 + DIM] - rows0[:, 3:3 + DIM]).max() > 0
    np.testing.assert_array_equal(rows1[:, 2], rows0[:, 2])


def test_interaction_opens_its_range():
    model, _ = _seeded()
    T = sum(UNEVEN)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(torch.zeros(2, T, 3 + DIM), torch.ones(2, T, dtype=torch.bool),
              torch.zeros(2, DENSE), np.repeat(np.arange(S), UNEVEN), S)
    assert "pbt/interaction" in {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("cls", [DLRMDCNv2Model, DLRMModel],
                         ids=["dlrm_dcnv2", "dlrm"])
def test_attribute_step_times_the_interaction(cls):
    model = (_model() if cls is DLRMDCNv2Model
             else DLRMModel(S, DIM, DENSE, bottom_hidden=(16,),
                            top_hidden=(16, 8)))
    store, schema, tr = _trainer(UNEVEN, model)
    ds, keys = _dataset(schema, UNEVEN, BATCH, 4)
    try:
        tr.train_pass(ds)
        ws = tr.last_ws
        pb = next(iter(ds.batches(BATCH)))
        idx = ws.translate(pb.ids, pb.mask)
        labels, dense = tr.split_floats(pb.floats)
        staged = tr.stage(tr.pack_arrays(ws, idx, pb.mask, dense, labels))
        att = step_probe.attribute_step(tr, ws, staged, 0.01, windows=1)
    finally:
        tr.feed_mgr.close()
    base = {"lookup", "dense_fwd_bwd", "sparse_push"}
    if cls is DLRMDCNv2Model:
        assert set(att["isolated"]) == base | {"interaction"}
        assert att["isolated"]["interaction"] > 0
        # one window of a warm-up and one timed call
        assert att["calls"]["isolated_interaction"] == 2
    else:
        assert set(att["isolated"]) == base
        assert "isolated_interaction" not in att["calls"]
