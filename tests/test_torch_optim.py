"""The port's row layout and in-table optimizer against the JAX package.

Every derived width and column slice of EmbeddingConfig must equal the
reference's; apply_updates must match the JAX version for every sparse
optimizer, with and without a w block (embed_w_num) and create-threshold
gating, at the reference's own kernel-parity tolerance (rtol 1e-5, atol
1e-6, test_scatter_accumulate.py); the show/clk counters exactly.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.embedding.config import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding.optim import apply_updates as jax_apply

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.optim import apply_updates

# One intra-op thread: several test workers share the cores with the JAX
# tests' 8-device CPU meshes, and torch's default pool (a thread per core
# in every worker) would oversubscribe them.
torch.set_num_threads(1)

_PROPS = ("total_dim", "n_opt_slots", "fixed_cols", "pull_width",
          "grad_width", "row_width", "w_cols", "embedx_cols", "opt_cols")

_GRID = [dict(dim=d, expand_dim=e, optimizer=o, embed_w_num=w)
         for d, e, o, w in itertools.product(
             (0, 4, 32, 280), (0, 8), ("sgd", "adagrad", "adam", "ftrl"),
             (1, 3))
         if not (o == "ftrl" and w > 1)]


@pytest.mark.parametrize("kw", _GRID, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_row_layout_matches_reference(kw):
    got, want = EmbeddingConfig(**kw), JaxCfg(**kw)
    for p in _PROPS:
        assert getattr(got, p) == getattr(want, p), p


def _case(cfg, n=48, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.normal(scale=0.5, size=(n, cfg.row_width)).astype(np.float32)
    rows[:, 0] = rng.integers(0, 12, n)
    rows[:, 1] = rng.integers(0, 4, n)
    rows[:, cfg.opt_cols] = np.abs(rows[:, cfg.opt_cols])  # g2 / v / n >= 0
    grads = rng.normal(scale=0.3, size=(n, cfg.grad_width)).astype(
        np.float32)
    shows = rng.integers(0, 4, n).astype(np.float32)
    clks = np.minimum(shows, rng.integers(0, 2, n)).astype(np.float32)
    return rows, grads, shows, clks


_OPT_CASES = [(o, w, g) for o, w, g in itertools.product(
    ("sgd", "adagrad", "adam", "ftrl"), (1, 2), (False, True))
    if not (o == "ftrl" and w > 1)]


@pytest.mark.parametrize("opt,w_num,gated", _OPT_CASES)
def test_apply_updates_matches_reference(opt, w_num, gated):
    kw = dict(dim=8, optimizer=opt, learning_rate=0.05, embed_w_num=w_num)
    if gated:
        kw.update(expand_dim=4, mf_create_threshold=6.0,
                  expand_create_threshold=9.0)
    cfg, jcfg = EmbeddingConfig(**kw), JaxCfg(**kw)
    rows, grads, shows, clks = _case(cfg, seed=len(opt) + w_num)
    want = np.asarray(jax_apply(jnp.asarray(rows), jnp.asarray(grads),
                                jnp.asarray(shows), jnp.asarray(clks), jcfg))
    got = apply_updates(torch.from_numpy(rows), torch.from_numpy(grads),
                        torch.from_numpy(shows), torch.from_numpy(clks),
                        cfg).numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if gated and opt != "adam":
        # gating really dropped grads for some rows and kept others (adam
        # moves a gated plane through its momentum, so it is left out)
        post = rows[:, 0] + shows
        x = cfg.embedx_cols
        assert (post < 6.0).any() and (post >= 6.0).any()
        np.testing.assert_array_equal(got[post < 6.0, x.start:x.start + 8],
                                      rows[post < 6.0, x.start:x.start + 8])


def test_apply_updates_pad_columns_pass_through():
    cfg = EmbeddingConfig(dim=4, optimizer="adam")
    rows, grads, shows, clks = _case(cfg)
    padded = np.concatenate([rows, np.full((len(rows), 3), 7.5,
                                           np.float32)], axis=1)
    got = apply_updates(torch.from_numpy(padded), torch.from_numpy(grads),
                        torch.from_numpy(shows), torch.from_numpy(clks),
                        cfg).numpy()
    np.testing.assert_array_equal(got[:, cfg.row_width:], 7.5)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_dense_optimizers_follow_optax(name):
    """The port's dense optimizers follow optax's formulas (bias-corrected
    adam with eps outside the sqrt; plain sgd), not torch.optim's."""
    import optax
    from paddlebox_tpu_torch.train import optimizers
    rng = np.random.default_rng(9)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(3,)).astype(np.float32)]
    grads = [[rng.normal(size=a.shape).astype(np.float32) for a in p0]
             for _ in range(6)]
    tx = optax.adam(1e-2) if name == "adam" else optax.sgd(1e-2)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    params = [torch.from_numpy(a.copy()) for a in p0]
    opt = optimizers.make(name, 1e-2, params)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in g])
    for got, want in zip(params, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
