"""The port's remaining CTR ops against the JAX package's.

Forward and gradient of ``batch_fc``, ``rank_attention`` (plus both
rank_offset builders against each other and against the JAX package's),
the PCOC and conversion variants of ``fused_seqpool_cvm``,
``fused_gather_seqpool_cvm`` (the port's plain path against the JAX op in
Pallas interpret mode and ``jax.grad`` through its custom VJP, with
need_filter, embed_threshold and quant_ratio), ``data_norm`` /
``summary_update`` / ``cross_norm_hadamard``,
``pull_box_extended_sparse``, ``fused_concat`` and the share-embedding
selection and model wrapper. Forward rtol 1e-5 / atol 1e-6, gradients
rtol 1e-4 / atol 1e-6 (tests/test_torch_zoo.py's tolerances); integer
outputs exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.embedding.config import EmbeddingConfig as JaxCfg
from paddlebox_tpu.ops import cross_norm as jcross
from paddlebox_tpu.ops import extended as jext
from paddlebox_tpu.ops import seqpool_cvm as jseq
from paddlebox_tpu.ops import share_embedding as jshare
from paddlebox_tpu.ops.batch_fc import batch_fc as jax_batch_fc
from paddlebox_tpu.ops.fused_concat import fused_concat as jax_fused_concat
from paddlebox_tpu.ops.rank_attention import (
    build_rank_offset_reference as jax_build_rank_offset_reference)
from paddlebox_tpu.ops.rank_attention import (
    rank_attention as jax_rank_attention)

from paddlebox_tpu_torch import models, weights
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.ops import (cross_norm, extended, seqpool_cvm,
                                     share_embedding)
from paddlebox_tpu_torch.ops.batch_fc import batch_fc
from paddlebox_tpu_torch.ops.fused_concat import fused_concat
from paddlebox_tpu_torch.ops.rank_attention import (
    build_rank_offset, build_rank_offset_reference, rank_attention)

torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _grads(jfn, pfn, arrays, seed=0):
    """Outputs and gradients of Σ out·cot with respect to every array,
    in both packages."""
    jout = np.asarray(jfn(*[jnp.asarray(a) for a in arrays]))
    cot = np.random.default_rng(seed).normal(size=jout.shape).astype(
        np.float32)
    jg = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * cot),
                  argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    pout = pfn(*ts)
    pg = torch.autograd.grad((pout * torch.from_numpy(cot)).sum(), ts)
    return (jout, [np.asarray(g) for g in jg], pout.detach().numpy(),
            [g.numpy() for g in pg])


def _assert_grads(got, tol_f=FWD_TOL, tol_g=GRAD_TOL):
    jout, jg, pout, pg = got
    np.testing.assert_allclose(pout, jout, **tol_f)
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a, b, **tol_g)


# ---------------------------------------------------------------------------
# batch_fc, rank_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias,act", [(True, "relu"), (True, None),
                                      (False, None)])
def test_batch_fc_matches_reference(bias, act):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 10, 5)).astype(np.float32)
    w = rng.normal(size=(3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    arrays = [x, w, b] if bias else [x, w]
    _assert_grads(_grads(
        lambda *a: jax_batch_fc(*a, activation=act),
        lambda *a: batch_fc(*a, activation=act), arrays))
    with pytest.raises(ValueError, match="activation"):
        batch_fc(torch.from_numpy(x), torch.from_numpy(w),
                 activation="gelu")


def _page_views(B, rng, max_rank=3):
    pv = np.repeat(np.arange(B), rng.integers(1, max_rank + 1, B))[:B]
    rank = np.concatenate([np.arange(1, (pv == g).sum() + 1)
                           for g in np.unique(pv)]).astype(np.int32)
    rank[rng.random(B) < 0.1] = 0                 # some invalid ranks
    return rank, pv.astype(np.uint64)


@pytest.mark.parametrize("max_rank", [1, 3])
def test_rank_attention_matches_reference(max_rank):
    rng = np.random.default_rng(max_rank)
    B, I, O = 20, 6, 5
    rank, pv = _page_views(B, rng, max_rank)
    ro = build_rank_offset(rank, pv, max_rank)
    x = rng.normal(size=(B, I)).astype(np.float32)
    param = rng.normal(size=(max_rank * max_rank * I, O)).astype(np.float32)
    _assert_grads(_grads(
        lambda xx, pp: jax_rank_attention(xx, jnp.asarray(ro), pp,
                                          max_rank),
        lambda xx, pp: rank_attention(
            xx, torch.from_numpy(ro), pp, max_rank), [x, param]))


@pytest.mark.parametrize("B", [0, 1, 9, 64, 300])
def test_build_rank_offset_matches_reference_loop(B):
    """The vectorised builder against the per-member loop (duplicate
    ranks in a PV: the last member wins) and the JAX package's."""
    rng = np.random.default_rng(B)
    ranks = rng.integers(0, 5, B).astype(np.int32)
    groups = rng.integers(0, max(B // 3, 1), B).astype(np.uint64)
    got = build_rank_offset(ranks, groups, 3)
    np.testing.assert_array_equal(
        got, build_rank_offset_reference(ranks, groups, 3))
    np.testing.assert_array_equal(
        got, jax_build_rank_offset_reference(ranks, groups, 3))
    assert got.dtype == np.int32 and got.shape == (B, 7)


# ---------------------------------------------------------------------------
# fused_seqpool_cvm variants
# ---------------------------------------------------------------------------

S, L = 3, 2


def _pulled(P, B=6, seed=0, lead=2):
    """Tokens with ``lead`` nonnegative counter columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.6, size=(B, S * L, P)).astype(np.float32)
    x[..., :lead] = rng.integers(0, 9, size=(B, S * L, lead))
    mask = rng.random((B, S * L)) < 0.8
    return x, mask, np.repeat(np.arange(S, dtype=np.int32), L)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_cvm=False), dict(need_filter=True, threshold=1.5),
    dict(quant_ratio=16), dict(cvm_offset=6, max_cvm_offset=7),
    dict(flatten=False)])
def test_seqpool_cvm_with_pcoc_matches_reference(kw):
    x, mask, seg = _pulled(7 + 4, lead=7)
    _assert_grads(_grads(
        lambda p: jseq.fused_seqpool_cvm_with_pcoc(p, jnp.asarray(mask),
                                                   seg, S, **kw),
        lambda p: seqpool_cvm.fused_seqpool_cvm_with_pcoc(
            p, torch.from_numpy(mask), seg, S, **kw), [x]))


def test_seqpool_cvm_with_pcoc_rejects_short_offset():
    x, mask, seg = _pulled(8)
    with pytest.raises(ValueError, match="cvm_offset"):
        seqpool_cvm.fused_seqpool_cvm_with_pcoc(
            torch.from_numpy(x), torch.from_numpy(mask), seg, S,
            cvm_offset=3)


@pytest.mark.parametrize("kw", [
    dict(), dict(use_cvm=False), dict(need_filter=True, threshold=2.0),
    dict(embed_threshold=0.3), dict(quant_ratio=8, flatten=False)])
def test_seqpool_cvm_with_conv_matches_reference(kw):
    x, mask, seg = _pulled(4 + 4, lead=3)
    _assert_grads(_grads(
        lambda p: jseq.fused_seqpool_cvm_with_conv(p, jnp.asarray(mask),
                                                   seg, S, **kw),
        lambda p: seqpool_cvm.fused_seqpool_cvm_with_conv(
            p, torch.from_numpy(mask), seg, S, **kw), [x]))


@pytest.mark.parametrize("fn", ["fused_seqpool_cvm_with_pcoc",
                                "fused_seqpool_cvm_with_conv"])
def test_seqpool_cvm_variants_take_pooled_slots(fn):
    x, mask, seg = _pulled(11, lead=7)
    pooled = np.stack([(x * mask[..., None])[:, seg == s].sum(axis=1)
                       for s in range(S)], axis=1)
    got = getattr(seqpool_cvm, fn)(
        seqpool_cvm.PooledSlots(torch.from_numpy(pooled)), None, seg, S)
    want = getattr(jseq, fn)(jseq.PooledSlots(jnp.asarray(pooled)), None,
                             seg, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    with pytest.raises(ValueError, match="PooledSlots"):
        getattr(seqpool_cvm, fn)(
            seqpool_cvm.PooledSlots(torch.from_numpy(pooled)), None, seg,
            S, need_filter=True)


# ---------------------------------------------------------------------------
# fused_gather_seqpool_cvm
# ---------------------------------------------------------------------------

def _table(B=6, L=3, dim=4, n=48, seed=0, dup=False):
    """A table with counter-like show/clk and the all-zero row 0, ids and
    a mask; ``dup`` draws every id from 8 rows (duplicate-heavy)."""
    cfg = EmbeddingConfig(dim=dim, optimizer="adagrad", learning_rate=0.05)
    jcfg = JaxCfg(dim=dim, optimizer="adagrad", learning_rate=0.05)
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=0.5, size=(n, cfg.row_width)).astype(np.float32)
    table[:, 0] = rng.integers(0, 20, size=n)
    table[:, 1] = rng.integers(0, 5, size=n)
    table[0] = 0.0
    idx = rng.integers(1, 9 if dup else n, size=(B, S * L)).astype(np.int32)
    mask = rng.random((B, S * L)) < 0.75
    return cfg, jcfg, table, idx, mask, np.repeat(np.arange(S), L)


_GATHER_CASES = {
    "plain": dict(),
    "no_cvm": dict(use_cvm=False),
    "need_filter": dict(need_filter=True, threshold=0.5),
    "per_slot_threshold": dict(need_filter=True, show_coeff=0.3,
                               clk_coeff=0.9,
                               threshold=np.array([0.5, -1.0, 3.0],
                                                  np.float32)),
    "embed_threshold": dict(embed_threshold=0.3),
    "quant_ratio": dict(quant_ratio=8),
    "all": dict(need_filter=True, threshold=1.0, embed_threshold=0.2,
                quant_ratio=16, flatten=False),
}


@pytest.mark.parametrize("dup", [False, True], ids=["spread", "dup"])
@pytest.mark.parametrize("case", sorted(_GATHER_CASES))
def test_fused_gather_seqpool_cvm_matches_reference(case, dup):
    """Forward against the JAX op on its Pallas kernel in interpret mode,
    and the table gradient against jax.grad through its custom VJP (the
    keep factor, the per-unique-row merge, straight-through quant)."""
    kw = _GATHER_CASES[case]
    cfg, jcfg, table, idx, mask, seg = _table(seed=len(case), dup=dup)
    _assert_grads(_grads(
        lambda t: jseq.fused_gather_seqpool_cvm(
            t, jnp.asarray(idx), jnp.asarray(mask), seg, S, jcfg,
            interpret=True, **kw),
        lambda t: seqpool_cvm.fused_gather_seqpool_cvm(
            t, torch.from_numpy(idx), torch.from_numpy(mask), seg, S, cfg,
            **kw), [table]))


def test_fused_gather_seqpool_cvm_grad_is_straight_through_quant():
    """With quant_ratio the embedx gradient still flows (jnp.round's
    derivative would be zero almost everywhere)."""
    cfg, _, table, idx, mask, seg = _table(seed=3)
    t = torch.from_numpy(table).requires_grad_()
    out = seqpool_cvm.fused_gather_seqpool_cvm(
        t, torch.from_numpy(idx), torch.from_numpy(mask), seg, S, cfg,
        quant_ratio=4)
    (g,) = torch.autograd.grad(out.sum(), [t])
    assert g[:, 3:cfg.pull_width].abs().sum() > 0
    assert g[0].abs().sum() == 0 and g[:, cfg.pull_width:].abs().sum() == 0


def test_fused_gather_seqpool_cvm_rejects_what_the_reference_rejects():
    cfg, _, table, idx, mask, seg = _table()
    gated = EmbeddingConfig(dim=4, optimizer="adagrad",
                            mf_create_threshold=2.0)
    args = (torch.from_numpy(table), torch.from_numpy(idx),
            torch.from_numpy(mask))
    with pytest.raises(ValueError, match="gate_pull"):
        seqpool_cvm.fused_gather_seqpool_cvm(*args, seg, S, gated)
    with pytest.raises(ValueError, match="multiple of num_slots"):
        seqpool_cvm.fused_gather_seqpool_cvm(*args, seg, 4, cfg)
    ragged = np.array([0, 0, 0, 0, 1, 2, 2, 2, 2], np.int64)
    with pytest.raises(ValueError, match="uniform slot layout"):
        seqpool_cvm.fused_gather_seqpool_cvm(*args, ragged, S, cfg)


# ---------------------------------------------------------------------------
# cross_norm, extended, fused_concat, share_embedding
# ---------------------------------------------------------------------------

def test_data_norm_and_summary_update_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 5)).astype(np.float32)
    summary = np.asarray(jcross.init_summary(5))
    np.testing.assert_array_equal(cross_norm.init_summary(5).numpy(),
                                  summary)
    for _ in range(3):
        want = np.asarray(jcross.summary_update(jnp.asarray(summary),
                                                jnp.asarray(x), decay=0.99))
        got = cross_norm.summary_update(torch.from_numpy(summary),
                                        torch.from_numpy(x), decay=0.99)
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)
        summary = want
    _assert_grads(_grads(
        lambda xx: jcross.data_norm(xx, jnp.asarray(summary)),
        lambda xx: cross_norm.data_norm(xx, torch.from_numpy(summary)),
        [x]))


def test_summary_update_across_replicas_waits_for_multi_gpu():
    """summary_update(axis_name=) is ported: it sums the batch over the
    named axis of the mesh it is given (two ranks in
    tests/test_torch_distributed.py), so without the mesh it refuses."""
    with pytest.raises(ValueError, match="mesh"):
        cross_norm.summary_update(cross_norm.init_summary(2),
                                  torch.zeros(3, 2), axis_name="dp")


def test_cross_norm_hadamard_matches_reference():
    rng = np.random.default_rng(5)
    n, d = 3, 4
    x = rng.normal(size=(8, 2 * d * n)).astype(np.float32)
    raw = np.asarray(jcross.cross_norm_raw(jnp.asarray(x), n, d))
    np.testing.assert_allclose(
        cross_norm.cross_norm_raw(torch.from_numpy(x), n, d).numpy(), raw,
        **FWD_TOL)
    summary = np.asarray(jcross.summary_update(
        jcross.init_summary(raw.shape[1]), jnp.asarray(raw)))
    _assert_grads(_grads(
        lambda xx: jcross.cross_norm_hadamard(xx, jnp.asarray(summary),
                                              n, d),
        lambda xx: cross_norm.cross_norm_hadamard(
            xx, torch.from_numpy(summary), n, d), [x]))


@pytest.mark.parametrize("w_num", [1, 3])
def test_pull_box_extended_sparse_matches_reference(w_num):
    kw = dict(dim=4, expand_dim=6, embed_w_num=w_num)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    x = np.random.default_rng(6).normal(
        size=(5, 2, cfg.pull_width)).astype(np.float32)
    got = extended.pull_box_extended_sparse(torch.from_numpy(x), cfg)
    want = jext.pull_box_extended_sparse(jnp.asarray(x), jcfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1].shape[-1] == 6
    with pytest.raises(ValueError, match="expand_dim"):
        extended.pull_box_extended_sparse(torch.from_numpy(x),
                                          EmbeddingConfig(dim=4))


@pytest.mark.parametrize("kw", [dict(), dict(offset=1, length=2),
                                dict(offset=2), dict(axis=0)])
def test_fused_concat_matches_reference(kw):
    rng = np.random.default_rng(7)
    xs = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(3)]
    got = fused_concat([torch.from_numpy(a) for a in xs], **kw)
    want = jax_fused_concat([jnp.asarray(a) for a in xs], **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_share_embedding_matches_reference():
    cfg = EmbeddingConfig(dim=4, embed_w_num=3)
    jcfg = JaxCfg(dim=4, embed_w_num=3)
    x, _, seg = _pulled(cfg.pull_width, seed=8)
    share = np.array([2, 0, 1])
    _assert_grads(_grads(
        lambda p: jshare.select_share_embedding(p, seg, share, jcfg),
        lambda p: share_embedding.select_share_embedding(p, seg, share, cfg),
        [x]))


def test_share_embedding_model_matches_reference():
    """A zoo model wrapped to read a share-embedding table: same logits,
    same parameter tree (the inner model's)."""
    cfg = EmbeddingConfig(dim=4, embed_w_num=2)
    jcfg = JaxCfg(dim=4, embed_w_num=2)
    share = [1, 0, 1]
    jm = jshare.ShareEmbeddingModel(
        jmodels.DNNCTRModel(S, 4, 2, hidden=(8,)), share, jcfg)
    pm = share_embedding.ShareEmbeddingModel(
        models.DNNCTRModel(S, 4, 2, hidden=(8,)), share, cfg)
    assert pm.emb_dim == 4
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    weights.load_model_params(pm, jparams)
    x, mask, seg = _pulled(cfg.pull_width, seed=9)
    dense = np.random.default_rng(9).normal(size=(6, 2)).astype(np.float32)
    _assert_grads(_grads(
        lambda p: jm.apply(jparams, p, jnp.asarray(mask), jnp.asarray(dense),
                           seg, S),
        lambda p: pm(p, torch.from_numpy(mask), torch.from_numpy(dense),
                     seg, S), [x]))
    assert sorted(weights.model_params(pm)) == ["mlp"]
    with pytest.raises(ValueError, match="slot_share_idx"):
        share_embedding.ShareEmbeddingModel(models.DNNCTRModel(S, 4), [],
                                            cfg)
    with pytest.raises(ValueError, match="slot_share_idx"):
        share_embedding.ShareEmbeddingModel(models.DNNCTRModel(S, 4),
                                            [0, 2, 1], cfg)
