"""The port's two kernels: plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU, as tests/test_gather_pool.py and
tests/test_scatter_accumulate.py run them), and the push-engine
resolver.

Tolerances: gather_pool rtol 1e-6 / atol 1e-6 (test_gather_pool.py's);
scatter_accumulate rtol 1e-5 / atol 1e-6 (test_scatter_accumulate.py's
adagrad bound); rows no lane names must keep their exact bits.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.embedding import sharded as jax_sharded
from paddlebox_tpu.embedding.config import EmbeddingConfig as JaxCfg
from paddlebox_tpu.native.key_index import dedup_plan as jax_dedup_plan
from paddlebox_tpu.ops import pallas_kernels as pk

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.ops import kernels

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes, and torch's default pool (a thread per core
# in every worker) would oversubscribe them.
torch.set_num_threads(1)


def _pool_case(B=4, S=3, L=2, dim=4, n=64, seed=0, mask_p=0.7):
    """Counter-like show/clk, NULL row 0 all zeros, masked tokens nulled."""
    kw = dict(dim=dim, optimizer="adagrad", learning_rate=0.05)
    rng = np.random.default_rng(seed)
    cfg = EmbeddingConfig(**kw)
    table = rng.normal(size=(n, cfg.row_width)).astype(np.float32)
    table[:, 0] = rng.integers(0, 20, size=n)
    table[:, 1] = rng.integers(0, 5, size=n)
    table[0] = 0.0
    idx = rng.integers(1, n, size=(B, S * L)).astype(np.int32)
    mask = rng.random((B, S * L)) < mask_p
    idx = np.where(mask, idx, 0).astype(np.int32)
    return cfg, JaxCfg(**kw), table, idx


_POOL_FILTERS = {
    "none": {},
    "need_filter_scalar": dict(need_filter=True, threshold=1.5,
                               show_coeff=0.3, clk_coeff=0.9),
    "need_filter_per_slot": dict(need_filter=True,
                                 threshold=np.array([0.5, -1.0, 3.0],
                                                    np.float32)),
    "embed_threshold": dict(embed_threshold=0.4),
    "quant_ratio": dict(quant_ratio=8),
    "all": dict(need_filter=True, threshold=np.array([0.5, -1.0, 3.0],
                                                     np.float32),
                embed_threshold=0.4, quant_ratio=8),
}


@pytest.mark.parametrize("name", sorted(_POOL_FILTERS))
@pytest.mark.parametrize("B,S,L,dim", [(8, 3, 1, 32), (4, 3, 4, 32)])
def test_gather_pool_plain_matches_pallas(name, B, S, L, dim):
    cfg, jcfg, table, idx = _pool_case(B=B, S=S, L=L, dim=dim,
                                       seed=B + L + dim)
    kw = _POOL_FILTERS[name]
    want = np.asarray(pk.gather_pool(jnp.asarray(table), jnp.asarray(idx),
                                     jcfg, S, L, interpret=True, **kw))
    got = kernels.gather_pool(torch.from_numpy(table),
                              torch.from_numpy(idx), cfg, S, L, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gather_pool_all_pad_rows():
    cfg, jcfg, table, idx = _pool_case(seed=3)
    idx[0, :] = 0                       # an all-pad example
    idx[:, 2:4] = 0                     # slot 1 empty everywhere
    want = np.asarray(pk.gather_pool(jnp.asarray(table), jnp.asarray(idx),
                                     jcfg, 3, 2, interpret=True))
    got = kernels.gather_pool(torch.from_numpy(table),
                              torch.from_numpy(idx), cfg, 3, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(got[:, 1], 0.0)


def _sa_case(opt="adagrad", dim=4, n_rows=64, n_tok=300, seed=1, dup_mod=8):
    kw = dict(dim=dim, optimizer=opt, learning_rate=0.05)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=0.5, size=(n_rows, cfg.row_width)).astype(
        np.float32)
    table[:, 0] = rng.integers(0, 20, size=n_rows)
    table[:, 1] = rng.integers(0, 5, size=n_rows)
    table[:, cfg.opt_cols] = np.abs(table[:, cfg.opt_cols])
    table[0] = 0.0
    idx = (rng.integers(0, n_rows, size=n_tok) % dup_mod).astype(np.int32)
    grads = rng.normal(scale=0.3, size=(n_tok, cfg.grad_width)).astype(
        np.float32)
    shows = (idx > 0).astype(np.float32)
    clks = (rng.integers(0, 2, n_tok) * shows).astype(np.float32)
    grads[idx == 0] = 0.0
    return cfg, jcfg, table, idx, grads, shows, clks


def _jax_premerged(idx, grads, shows, clks, n_rows):
    o, u, s, _, _ = jax_dedup_plan(idx, n_rows, n_rows, 1)
    z = np.zeros(0, np.int32)
    return jax_sharded.plan_premerge(
        jnp.asarray(idx), jnp.asarray(grads), jnp.asarray(shows),
        jnp.asarray(clks), tuple(map(jnp.asarray, (o, z, z, u, s))))


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "ftrl"])
@pytest.mark.parametrize("dim,dup_mod", [(4, 8), (4, 64), (32, 16)])
def test_scatter_accumulate_plain_matches_pallas(opt, dim, dup_mod):
    cfg, jcfg, table, idx, grads, shows, clks = _sa_case(
        opt, dim=dim, dup_mod=dup_mod, seed=dim + dup_mod)
    uniq, mg, ms, mc, _ = _jax_premerged(idx, grads, shows, clks, 64)
    want = np.asarray(pk.scatter_accumulate(
        jnp.asarray(table), uniq, mg, ms, mc, jcfg, interpret=True))
    got = kernels.scatter_accumulate(
        torch.from_numpy(table.copy()), torch.from_numpy(np.array(uniq)),
        torch.from_numpy(np.array(mg)), torch.from_numpy(np.array(ms)),
        torch.from_numpy(np.array(mc)), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    untouched = np.setdiff1d(np.arange(64), idx)
    np.testing.assert_array_equal(got[untouched], table[untouched])


def _clobber_case():
    """A real row-0 lane (zero payload), two real rows, out-of-range pads
    and an in-range zero-touch pad (test_scatter_accumulate.py:140-171)."""
    kw = dict(dim=4, optimizer="sgd", learning_rate=0.0625)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    n = 64
    rng = np.random.default_rng(3)
    table = (rng.integers(-512, 512, size=(n, cfg.row_width))
             / 1024.0).astype(np.float32)
    table[0] = 0.0
    idx = np.array([0, 3, 9, n, n + 1, 0], np.int32)
    tch = np.array([1, 1, 1, 1, 1, 0], np.float32)
    grads = np.zeros((6, cfg.grad_width), np.float32)
    grads[1:3] = 0.25
    shows = np.array([0, 1, 1, 1, 1, 0], np.float32)
    clks = np.zeros(6, np.float32)
    return cfg, jcfg, table, idx, tch, grads, shows, clks


def test_scatter_accumulate_pad_never_clobbers_row0():
    cfg, jcfg, table, idx, tch, grads, shows, clks = _clobber_case()
    want = np.asarray(pk.scatter_accumulate(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(grads),
        jnp.asarray(shows), jnp.asarray(clks), jcfg,
        touched=jnp.asarray(tch), interpret=True))
    got = kernels.scatter_accumulate(
        torch.from_numpy(table.copy()), torch.from_numpy(idx),
        torch.from_numpy(grads), torch.from_numpy(shows),
        torch.from_numpy(clks), cfg, touched=torch.from_numpy(tch)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], 0.0)
    untouched = np.setdiff1d(np.arange(64), [0, 3, 9])
    np.testing.assert_array_equal(got[untouched], table[untouched])


def test_push_engine_resolver(monkeypatch):
    from paddlebox_tpu_torch.config import flags
    cfg = EmbeddingConfig(dim=32)
    r = kernels.resolve_push_engine
    monkeypatch.setattr(flags, "push_engine", "auto")
    assert r(cfg, 100, premerged=True, device_type="cuda") == \
        "scatter_accumulate"
    assert r(cfg, 100, premerged=False, device_type="cuda") == "xla_scatter"
    assert r(cfg, 100, premerged=True, device_type="cpu") == "xla_scatter"
    assert r(cfg, 100, premerged=True, device_type="cuda",
             table_width=600) == "xla_scatter"
    monkeypatch.setattr(flags, "push_engine", "fused")
    assert r(cfg, 100, premerged=True, device_type="cpu") == \
        "scatter_accumulate"
    monkeypatch.setattr(flags, "push_engine", "binned_kernel")
    with pytest.raises(ValueError, match="slice 2"):
        r(cfg, 100, premerged=True, device_type="cuda")
    monkeypatch.setattr(flags, "push_engine", "bogus")
    with pytest.raises(ValueError):
        r(cfg, 100, premerged=True, device_type="cuda")
