"""The port's single-shard pull/push core against the JAX package's
(embedding/sharded.py): lookup, the fused pooled pull and its backward,
the dedup pre-merge (past one 4096-token cumsum block, so the block
restart is exercised) and push on both engines. Counters (show/clk
columns) must match exactly, float columns at rtol 1e-5 / atol 1e-6
(premerged grads at the reference's premerge tolerance, see below).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.config import flags as jax_flags
from paddlebox_tpu.embedding import sharded as jsh
from paddlebox_tpu.embedding.config import EmbeddingConfig as JaxCfg
from paddlebox_tpu.native.key_index import dedup_plan as jax_dedup_plan

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding import sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native.key_index import dedup_plan

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes, and torch's default pool (a thread per core
# in every worker) would oversubscribe them.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _cfgs(**kw):
    kw.setdefault("dim", 8)
    kw.setdefault("optimizer", "adagrad")
    kw.setdefault("learning_rate", 0.05)
    return EmbeddingConfig(**kw), JaxCfg(**kw)


def _table(cfg, n_rows, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.normal(scale=0.5, size=(n_rows, cfg.row_width)).astype(
        np.float32)
    t[:, 0] = rng.integers(0, 20, size=n_rows)
    t[:, 1] = rng.integers(0, 5, size=n_rows)
    t[:, cfg.opt_cols] = np.abs(t[:, cfg.opt_cols])
    t[0] = 0.0
    return t


def _tokens(cfg, n_rows, n_tok, seed=1, dup_mod=None):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, size=n_tok).astype(np.int32)
    if dup_mod:
        idx = (idx % dup_mod).astype(np.int32)
    grads = rng.normal(scale=0.1, size=(n_tok, cfg.grad_width)).astype(
        np.float32)
    shows = (idx > 0).astype(np.float32)
    clks = (rng.integers(0, 2, n_tok) * shows).astype(np.float32)
    grads[idx == 0] = 0.0
    return idx, grads, shows, clks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("gated", [False, True])
def test_lookup_matches_reference(gated):
    kw = dict(expand_dim=4, mf_create_threshold=8.0,
              expand_create_threshold=12.0) if gated else {}
    cfg, jcfg = _cfgs(**kw)
    table = _table(cfg, 50)
    idx = np.random.default_rng(2).integers(0, 50, (6, 5)).astype(np.int32)
    want = np.asarray(jsh.lookup(jnp.asarray(table), jnp.asarray(idx), jcfg))
    got = sharded.lookup(_t(table), _t(idx), cfg).numpy()
    np.testing.assert_array_equal(got, want)


def test_fused_pull_pool_and_grad_tokens_match_reference():
    cfg, jcfg = _cfgs(dim=32)
    B, S, L = 16, 5, 4
    table = _table(cfg, 300, seed=4)
    rng = np.random.default_rng(5)
    mask = rng.random((B, S * L)) < 0.7
    idx = np.where(mask, rng.integers(1, 300, (B, S * L)), 0).astype(
        np.int32)
    want = np.asarray(jsh.fused_pull_pool(jnp.asarray(table),
                                          jnp.asarray(idx), jcfg, S, L))
    got = sharded.fused_pull_pool(_t(table), _t(idx), cfg, S, L).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    seg = np.repeat(np.arange(S, dtype=np.int32), L)
    gpooled = rng.normal(size=(B, S, cfg.pull_width)).astype(np.float32)
    want_g = np.asarray(jsh.pooled_grad_tokens(
        jnp.asarray(gpooled), jnp.asarray(mask), seg, S))
    got_g = sharded.pooled_grad_tokens(_t(gpooled), _t(mask), seg,
                                       S).numpy()
    np.testing.assert_array_equal(got_g, want_g)


@pytest.mark.parametrize("n_tok,dup_mod", [(9000, 300), (5000, None)])
def test_plan_premerge_matches_reference(n_tok, dup_mod):
    cfg, _ = _cfgs()
    n_rows = 2000
    idx, grads, shows, clks = _tokens(cfg, n_rows, n_tok, dup_mod=dup_mod)
    o, u, s, r, e = jax_dedup_plan(idx, n_rows, n_rows, 1)
    po, pu, ps, _, _ = dedup_plan(idx, n_rows, n_rows, 1)
    for a, b in ((o, po), (u, pu), (s, ps)):
        np.testing.assert_array_equal(a, b)
    z = np.zeros(0, np.int32)
    ju, jg, js, jc, _ = jsh.plan_premerge(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(shows),
        jnp.asarray(clks), tuple(map(jnp.asarray, (o, z, z, u, s))))
    tu, tg, ts, tc = sharded.plan_premerge(
        _t(idx), _t(grads), _t(shows), _t(clks), (_t(po), _t(pu), _t(ps)))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # merged grads are differences of block prefix sums, whose f32
    # summation order differs between the two cumsums: held at the
    # reference's own premerge tolerance (test_binned_push.py)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=5e-4,
                               atol=5e-5)


@pytest.fixture
def engines():
    old = (flags.push_engine, jax_flags.push_engine)
    yield
    flags.push_engine, jax_flags.push_engine = old


@pytest.mark.parametrize("engine", ["xla_scatter", "scatter_accumulate"])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_push_matches_reference(engines, engine, opt):
    flags.push_engine = jax_flags.push_engine = engine
    cfg, jcfg = _cfgs(optimizer=opt, dim=32)
    n_rows = 700
    table = _table(cfg, n_rows, seed=6)
    idx, grads, shows, clks = _tokens(cfg, n_rows, 6000, seed=7,
                                      dup_mod=500)
    jplan = tplan = None
    if engine == "scatter_accumulate":
        o, u, s, r, e = jax_dedup_plan(idx, n_rows, n_rows, 1)
        z = np.zeros(0, np.int32)
        jplan = tuple(map(jnp.asarray, (o, z, z, u, s)))
        tplan = (_t(o), _t(u), _t(s))
    want = np.asarray(jsh.push(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(grads), jnp.asarray(shows),
                               jnp.asarray(clks), jcfg, plan=jplan))
    got_t = _t(table)
    ran = sharded.push(got_t, _t(idx), _t(grads), _t(shows), _t(clks), cfg,
                       plan=tplan)
    assert ran == engine
    got = got_t.numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    untouched = np.setdiff1d(np.arange(n_rows), idx)
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_padded_table_columns_pass_through(monkeypatch):
    """flags.table_pad_width widens the device table; the pad columns
    stay zero through a push on both engines and never reach the host."""
    from paddlebox_tpu_torch.embedding import (HostEmbeddingStore,
                                               PassWorkingSet)
    monkeypatch.setattr(flags, "table_pad_width", 64)
    cfg, _ = _cfgs(dim=8)
    store = HostEmbeddingStore(cfg)
    keys = np.arange(1, 40, dtype=np.uint64)
    ws = PassWorkingSet.begin_pass(store, keys, device="cpu")
    assert ws.table.shape == (40, 64)
    idx = ws.translate(keys[:30])
    rng = np.random.default_rng(3)
    grads = rng.normal(scale=0.1, size=(30, cfg.grad_width)).astype(
        np.float32)
    ones, zeros = np.ones(30, np.float32), np.zeros(30, np.float32)
    for engine in ("xla_scatter", "scatter_accumulate"):
        monkeypatch.setattr(flags, "push_engine", engine)
        plan = None
        if engine == "scatter_accumulate":
            o, u, s, _, _ = dedup_plan(idx, 40, 40, 1)
            plan = (_t(o), _t(u), _t(s))
        assert sharded.push(ws.table, _t(idx), _t(grads), _t(ones),
                            _t(zeros), cfg, plan=plan) == engine
    assert (ws.table[:, cfg.row_width:] == 0).all()
    ws.end_pass(store)
    rows = store.peek_rows(keys)
    assert rows.shape == (39, cfg.row_width)
    np.testing.assert_array_equal(rows[:30, 0], 2.0)   # two pushes
    np.testing.assert_array_equal(rows[30:, 0], 0.0)   # untouched keys


def test_native_and_numpy_key_paths_agree(monkeypatch):
    """The g++-built key index and the NumPy/dict fallbacks (taken when
    no compiler is available) give identical ids and plans."""
    from paddlebox_tpu_torch.native import key_index
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    native, py = key_index.KeyIndex(), key_index.KeyIndex(force_python=True)
    assert native.is_native and not py.is_native
    for ix in (native, py):
        ix.lookup_or_insert(keys[:2000])
    probe = np.concatenate([keys[1000:3000], keys[:10]])
    np.testing.assert_array_equal(native.lookup(probe), py.lookup(probe))
    idx = rng.integers(-3, 520, 9000).astype(np.int32)
    want = key_index.dedup_plan(idx, 500, 500, 1)
    monkeypatch.setattr(key_index, "get_lib", lambda: None)
    got = key_index.dedup_plan(idx, 500, 500, 1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
