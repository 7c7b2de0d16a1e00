"""The port's model zoo against the JAX package's.

Every family of ``MODEL_REGISTRY`` (dnn_ctr, deepfm, wide_deep, dcn_v2,
dlrm, mmoe, pv_rank), at a few slots and narrow widths, from JAX-drawn
parameters carried across through ``weights.py``:

- the forward on per-token pulls and on pooled pulls (PooledSlots),
  logits at rtol 1e-5 / atol 1e-6, and the gradients of the dense params
  and of the pulled tensor at rtol 1e-4 / atol 1e-6; MMoE's
  ``apply_tasks``; DLRM in bf16 at its own stated tolerance;
- a 3-step ``train_pass`` then an ``eval_pass`` of every family on the
  one-hot and the multi-hot layout against the JAX Trainer on
  ``make_mesh(1)``, at tests/test_torch_trainer.py's tolerances (loss
  rtol 2e-4 / atol 2e-5, table rtol 1e-3 / atol 2e-5, MLP rtol 2e-3 /
  atol 2e-5);
- a port with a dropped cross-layer bias (DCNv2) or a wrong rank-pair
  block (PV-rank) must fail those tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.data import SlotDataset as JaxDataset
from paddlebox_tpu.data.slot_record import SlotRecordBatch as JaxRecords
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.ops import PooledSlots as JaxPooled
from paddlebox_tpu.ops.rank_attention import (
    build_rank_offset as jax_build_rank_offset)
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.train import Trainer as JaxTrainer
from paddlebox_tpu.train import TrainerConfig as JaxTrainerConfig

from paddlebox_tpu_torch import models, weights
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.ops.rank_attention import build_rank_offset
from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils.checkpoint import flatten_tree

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes.
torch.set_num_threads(1)

S, DENSE = 3, 2
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
MLP_TOL = dict(rtol=2e-3, atol=2e-5)
# bf16 keeps 8 significant bits (a relative step of 2^-8 ≈ 3.9e-3 per
# rounding); the products of a DLRM forward round a handful of times on
# the way to the logit, and the two packages' bf16 matmuls need not round
# the same partial sums
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

# narrow widths of every family (both packages take the same keywords)
WIDTHS = {
    "dnn_ctr": dict(hidden=(16, 8)),
    "deepfm": dict(hidden=(16, 8)),
    "wide_deep": dict(hidden=(16, 8)),
    "dcn_v2": dict(hidden=(16, 8), num_cross_layers=2),
    "dlrm": dict(bottom_hidden=(16,), top_hidden=(16, 8)),
    "mmoe": dict(num_experts=3, num_tasks=2, expert_hidden=(16,),
                 expert_out=8, tower_hidden=(8,)),
    "pv_rank": dict(hidden=(16, 8), max_rank=3, slot_proj=4, att_dim=4),
}
NAMES = sorted(WIDTHS)


def _pair(name, emb_dim, **extra):
    jm = jmodels.MODEL_REGISTRY[name](S, emb_dim, DENSE, **WIDTHS[name],
                                      **extra.get("jax", {}))
    pm = models.MODEL_REGISTRY[name](S, emb_dim, DENSE, **WIDTHS[name],
                                     **extra.get("port", {}))
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    weights.load_model_params(pm, jparams)
    return jm, pm, jparams


def _inputs(emb_dim, B=12, L=2, seed=0):
    """Per-token pulls with counter-like show/clk, a mask, dense floats,
    and a rank_offset over page views of 1-3 ads."""
    rng = np.random.default_rng(seed)
    P = 3 + emb_dim
    pulled = rng.normal(scale=0.5, size=(B, S * L, P)).astype(np.float32)
    pulled[..., 0] = rng.integers(0, 9, size=(B, S * L))
    pulled[..., 1] = np.minimum(pulled[..., 0],
                                rng.integers(0, 3, size=(B, S * L)))
    mask = rng.random((B, S * L)) < 0.8
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    pv = np.repeat(np.arange(B), rng.integers(1, 4, B))[:B]
    rank = np.concatenate([np.arange(1, (pv == g).sum() + 1)
                           for g in np.unique(pv)]).astype(np.int32)
    ro = build_rank_offset(rank, pv.astype(np.uint64), 3)
    seg = np.repeat(np.arange(S, dtype=np.int32), L)
    return pulled, mask, dense, ro, seg


def _pooled(pulled, mask, seg):
    """Per-(example, slot) sums of the masked tokens."""
    x = pulled * mask[..., None]
    return np.stack([x[:, seg == s].sum(axis=1) for s in range(S)], axis=1)


def _leaves(tree):
    return {p: np.asarray(v) for p, v in flatten_tree(tree)}


def _assert_trees(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **tol)


def _both(name, jm, pm, jparams, x, mask, dense, ro, seg, pooled,
          port_fn=None, jax_fn=None):
    """Logits and their gradients (of Σ logits·cot) in both packages."""
    extras_j = (jnp.asarray(ro),) if name == "pv_rank" else ()
    extras_p = (torch.from_numpy(ro),) if name == "pv_rank" else ()
    cot = np.linspace(-1.0, 1.5, x.shape[0]).astype(np.float32)
    jwrap = JaxPooled if pooled else (lambda a: a)
    pwrap = PooledSlots if pooled else (lambda a: a)
    jax_fn = jax_fn or jm.apply
    port_fn = port_fn or pm

    def jloss(p, xx):
        out = jax_fn(p, jwrap(xx), jnp.asarray(mask), jnp.asarray(dense),
                     seg, S, *extras_j)
        return jnp.sum(out.reshape(x.shape[0], -1)[:, 0] * cot), out

    (_, jout), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    pout = port_fn(pwrap(xt), torch.from_numpy(mask),
                   torch.from_numpy(dense), seg, S, *extras_p)
    params = list(pm.parameters())
    grads = torch.autograd.grad(
        (pout.reshape(x.shape[0], -1)[:, 0] * torch.from_numpy(cot)).sum(),
        [*params, xt], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip([*params, xt], grads)]
    return (np.asarray(jout), jax.tree.map(np.asarray, jg), np.asarray(jgx),
            pout.detach().numpy(),
            weights.tree(pm, [g.numpy() for g in grads[:-1]]),
            grads[-1].numpy())


def test_registry_matches_reference():
    assert list(models.MODEL_REGISTRY) == list(jmodels.MODEL_REGISTRY)
    for name, cls in models.MODEL_REGISTRY.items():
        assert cls.name == name
        jcls = jmodels.MODEL_REGISTRY[name]
        assert cls.pooled_pull_ok == jcls.pooled_pull_ok


@pytest.mark.parametrize("pooled", [False, True], ids=["tokens", "pooled"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_grads_match_reference(name, pooled):
    emb_dim = 4
    jm, pm, jparams = _pair(name, emb_dim)
    pulled, mask, dense, ro, seg = _inputs(emb_dim, seed=len(name))
    x = _pooled(pulled, mask, seg) if pooled else pulled
    jout, jg, jgx, pout, pg, pgx = _both(name, jm, pm, jparams, x, mask,
                                         dense, ro, seg, pooled)
    np.testing.assert_allclose(pout, jout, **FWD_TOL)
    _assert_trees(pg, jg, GRAD_TOL)
    np.testing.assert_allclose(pgx, jgx, **GRAD_TOL)
    # the params round-trip through the JAX layout unchanged
    _assert_trees(weights.model_params(pm), jparams, dict(rtol=0, atol=0))


def test_mmoe_apply_tasks_matches_reference():
    jm, pm, jparams = _pair("mmoe", 4)
    pulled, mask, dense, ro, seg = _inputs(4, seed=11)
    jout, jg, jgx, pout, pg, pgx = _both(
        "mmoe", jm, pm, jparams, pulled, mask, dense, ro, seg, False,
        port_fn=pm.apply_tasks, jax_fn=jm.apply_tasks)
    assert pout.shape == jout.shape == (pulled.shape[0], 2)
    np.testing.assert_allclose(pout, jout, **FWD_TOL)
    _assert_trees(pg, jg, GRAD_TOL)
    # task 1's gate and tower take no part in task 0's logits
    assert np.all(pg["towers"][1][0]["w"] == 0)
    np.testing.assert_allclose(pgx, jgx, **GRAD_TOL)


def test_dlrm_bf16_matches_reference():
    """compute_dtype bf16: x and w cast for each product (the Gram matrix
    included), the bias added in f32, in both packages."""
    jm, pm, jparams = _pair("dlrm", 8, jax=dict(compute_dtype=jnp.bfloat16),
                            port=dict(compute_dtype=torch.bfloat16))
    pulled, mask, dense, ro, seg = _inputs(8, B=32, seed=5)
    jout, _, _, pout, _, _ = _both("dlrm", jm, pm, jparams, pulled, mask,
                                   dense, ro, seg, False)
    assert pout.dtype == np.float32
    np.testing.assert_allclose(pout, jout, **BF16_TOL)
    # bf16 really ran: the f32 forward differs from both
    _, pm32, _ = _pair("dlrm", 8)
    f32 = pm32(torch.from_numpy(pulled), torch.from_numpy(mask),
               torch.from_numpy(dense), seg, S).detach().numpy()
    assert np.abs(f32 - pout).max() > 1e-6


def test_pv_rank_requires_rank_offset():
    _, pm, _ = _pair("pv_rank", 4)
    pulled, mask, dense, _, seg = _inputs(4)
    with pytest.raises(ValueError, match="rank_offset"):
        pm(torch.from_numpy(pulled), torch.from_numpy(mask),
           torch.from_numpy(dense), seg, S)


def test_weights_refuse_a_mismatched_tree():
    _, pm, jparams = _pair("dcn_v2", 4)
    short = dict(jparams, cross=jparams["cross"][:1])
    with pytest.raises(ValueError, match="cross/1"):
        weights.load_model_params(pm, short)
    extra = dict(jparams, stray=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="leaves given"):
        weights.load_model_params(pm, extra)


# ---------------------------------------------------------------------------
# train_pass / eval_pass trajectories against the JAX Trainer
# ---------------------------------------------------------------------------

BATCH, STEPS = 24, 3
LAYOUTS = {"onehot": dict(max_len=1, dim=8),
           "multihot": dict(max_len=3, dim=8)}


def _records(pkg, schema, n, seed, max_len):
    """``n`` examples from a 300-key pool, with page views of 1-3 ads
    (search_id, rank) for PV-rank."""
    cls = SlotRecordBatch if pkg == "port" else JaxRecords
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 50, 300, replace=False).astype(np.int64)
    lens = [rng.integers(1, max_len + 1, n) for _ in range(S)]
    vals = [rng.choice(keys, int(l.sum())) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.3).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)]
    sizes = rng.integers(1, 4, n)
    pv = np.repeat(np.arange(n), sizes)[:n]
    rank = np.concatenate([np.arange(1, (pv == g).sum() + 1)
                           for g in np.unique(pv)]).astype(np.int32)
    z32 = np.zeros(n, np.int32)
    return cls(schema, n, vals, offs, floats, np.arange(n, dtype=np.uint64),
               pv.astype(np.uint64), rank, z32)


def _trainers(name, layout, optimizer="adam"):
    lay = LAYOUTS[layout]
    ecfg = dict(dim=lay["dim"], optimizer="adagrad", learning_rate=0.05)
    tcfg = dict(global_batch_size=BATCH, auc_buckets=1 << 10,
                dense_optimizer=optimizer, dense_lr=3e-3)
    jschema = JaxSchema.ctr(num_sparse=S, num_float=DENSE,
                            batch_size=BATCH, max_len=lay["max_len"])
    jstore = JaxStore(JaxCfg(**ecfg))
    jm = jmodels.MODEL_REGISTRY[name](S, lay["dim"], DENSE, **WIDTHS[name])
    jtr = JaxTrainer(jm, jstore, jschema, make_mesh(1),
                     JaxTrainerConfig(**tcfg))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=BATCH, max_len=lay["max_len"])
    store = HostEmbeddingStore(EmbeddingConfig(**ecfg))
    pm = models.MODEL_REGISTRY[name](S, lay["dim"], DENSE, **WIDTHS[name])
    tr = Trainer(pm, store, schema, TrainerConfig(**tcfg), device="cpu")
    tr.restore_dense(jax.tree.map(np.asarray, jtr.params))
    return (jstore, jtr), (store, tr)


def _datasets(jtr, tr, n, seed, max_len):
    jds = JaxDataset(jtr.schema)
    jds.records = _records("jax", jtr.schema, n, seed, max_len)
    ds = SlotDataset(tr.schema)
    ds.records = _records("port", tr.schema, n, seed, max_len)
    return jds, ds


def _run_trajectory(name, layout, tr_hook=None):
    (jstore, jtr), (store, tr) = _trainers(name, layout)
    if tr_hook is not None:
        tr_hook(tr)
    max_len = LAYOUTS[layout]["max_len"]
    jds, ds = _datasets(jtr, tr, STEPS * BATCH, 7, max_len)
    jout = jtr.train_pass(jds)
    out = tr.train_pass(ds)
    ejds, eds = _datasets(jtr, tr, 2 * BATCH + 5, 8, max_len)
    jev, ev = jtr.eval_pass(ejds), tr.eval_pass(eds)
    keys = np.unique(np.concatenate(ds.records.sparse_values)).astype(
        np.uint64)
    return dict(out=out, jout=jout, ev=ev, jev=jev,
                rows=store.get_rows(keys), jrows=jstore.get_rows(keys),
                params=tr.eval_params(),
                jparams=jax.tree.map(np.asarray, jtr.params),
                pull=tr.pull_engine)


def _assert_trajectory(r):
    assert r["out"]["steps"] == r["jout"]["steps"] == STEPS
    for k in ("loss_first", "loss_last", "loss_mean"):
        np.testing.assert_allclose(r["out"][k], r["jout"][k], **LOSS_TOL)
    np.testing.assert_allclose(r["rows"], r["jrows"], **TABLE_TOL)
    _assert_trees(r["params"], r["jparams"], MLP_TOL)
    assert r["ev"]["examples"] == 2 * BATCH + 5
    assert abs(r["ev"]["auc"] - r["jev"]["auc"]) < 1e-3


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_train_pass_trajectory_matches_reference(name, layout):
    r = _run_trajectory(name, layout)
    _assert_trajectory(r)
    # multi-hot pulls pool inside the pull (gather_pool's plain version)
    want = "fused_gather_pool" if layout == "multihot" else "gather_seqpool"
    assert r["pull"] == want


def _drop_cross_bias(tr):
    """A broken port: DCNv2's cross layers without their bias."""
    from paddlebox_tpu_torch.models.dcn import fused_seqpool_cvm, matmul
    m = tr.model

    def forward(pulled, mask, dense, segment_ids, num_slots=None):
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, m.num_slots)
        x0 = torch.cat([feats, dense], dim=1)
        x = x0
        for layer in m.cross:
            x = x0 * matmul(x, layer.w) + x
        deep = m.deep(x0, final_activation="relu")
        return (torch.cat([x, deep], dim=1) @ m.head.w + m.head.b)[:, 0]

    m.forward = forward


def _shift_rank_pair(tr):
    """A broken port: every example reads the rank-pair block of the next
    own rank (a wrong offset into rank_param)."""
    fn = tr._extras_fn

    def extras(pb, n_shards):
        (ro,) = fn(pb, n_shards)
        ro = ro.copy()
        ro[:, 0] = np.where(ro[:, 0] > 0, ro[:, 0] % 3 + 1, 0)
        return (ro,)

    tr._extras_fn = extras


@pytest.mark.parametrize("name,hook", [("dcn_v2", _drop_cross_bias),
                                       ("pv_rank", _shift_rank_pair)])
def test_detects_a_broken_port(name, hook):
    """A fault injected into the port's side must break the trajectory
    tolerances the parity test accepts."""
    r = _run_trajectory(name, "onehot", tr_hook=hook)
    with pytest.raises(AssertionError):
        _assert_trajectory(r)


def test_rank_offset_builder_matches_reference_package():
    rng = np.random.default_rng(2)
    for B in (0, 1, 17, 200):
        ranks = rng.integers(0, 5, B).astype(np.int32)
        groups = rng.integers(0, max(B // 3, 1), B).astype(np.uint64)
        np.testing.assert_array_equal(
            build_rank_offset(ranks, groups, 3),
            jax_build_rank_offset(ranks, groups, 3))
