"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips without a CUDA
card and nvcc. The file imports no JAX, so it runs where only the port's
dependencies are installed, without the JAX harness in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: gather_pool rtol 1e-6 / atol 1e-6, scatter_accumulate
rtol 1e-5 / atol 1e-6 (the reference kernel tests'); rows no lane names
keep their exact bits.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.embedding import sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native.key_index import dedup_plan
from paddlebox_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    nvcc = (os.environ.get("NVCC") or shutil.which("nvcc")
            or "/usr/local/cuda/bin/nvcc")
    if not torch.cuda.is_available() or not os.path.exists(nvcc):
        pytest.skip("needs CUDA + nvcc")
    return torch.device("cuda")


_FILTERS = {
    "none": {},
    "need_filter_scalar": dict(need_filter=True, threshold=1.5,
                               show_coeff=0.3, clk_coeff=0.9),
    "need_filter_per_slot": dict(need_filter=True,
                                 threshold=[0.5, -1.0, 3.0]),
    "embed_threshold": dict(embed_threshold=0.4),
    "quant_ratio": dict(quant_ratio=8),
}


@pytest.mark.parametrize("name", sorted(_FILTERS))
@pytest.mark.parametrize("dim", [4, 32, 600])
def test_gather_pool_kernel_matches_plain(card, name, dim):
    B, S, L, n = 64, 3, 4, 500
    cfg = EmbeddingConfig(dim=dim, optimizer="adagrad")
    rng = np.random.default_rng(dim)
    table = rng.normal(size=(n, cfg.row_width)).astype(np.float32)
    table[:, 0] = rng.integers(0, 20, size=n)
    table[:, 1] = rng.integers(0, 5, size=n)
    table[0] = 0.0
    mask = rng.random((B, S * L)) < 0.7
    idx = np.where(mask, rng.integers(1, n, (B, S * L)), 0).astype(np.int32)
    t, i = torch.from_numpy(table).to(card), torch.from_numpy(idx).to(card)
    kw = _FILTERS[name]
    want = kernels.gather_pool_plain(t, i, cfg, S, L, **kw)
    n0 = kernels.gather_pool.launches
    got = kernels.gather_pool(t, i, cfg, S, L, **kw)
    torch.cuda.synchronize()
    assert kernels.gather_pool.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _lanes(cfg, n_rows, n_tok, card, seed):
    """Premerged lanes of a duplicate-heavy token stream."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n_tok).astype(np.int32)
    grads = rng.normal(scale=0.3, size=(n_tok, cfg.grad_width)).astype(
        np.float32)
    shows = (idx > 0).astype(np.float32)
    clks = (rng.integers(0, 2, n_tok) * shows).astype(np.float32)
    grads[idx == 0] = 0.0
    o, u, s, _, _ = dedup_plan(idx, n_rows, n_rows, 1)
    dev = [torch.from_numpy(a).to(card) for a in (idx, grads, shows, clks)]
    plan = tuple(torch.from_numpy(a).to(card) for a in (o, u, s))
    return idx, sharded.plan_premerge(*dev, plan)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "ftrl"])
@pytest.mark.parametrize("w_num,gated", [(1, False), (2, True)])
def test_scatter_accumulate_kernel_matches_plain(card, opt, w_num, gated):
    if opt == "ftrl" and w_num > 1:
        w_num = 1                      # ftrl has no w block
    kw = dict(dim=32, optimizer=opt, embed_w_num=w_num)
    if gated:
        kw.update(expand_dim=8, mf_create_threshold=4.0,
                  expand_create_threshold=7.0)
    cfg = EmbeddingConfig(**kw)
    n_rows = 512
    rng = np.random.default_rng(len(opt))
    table = rng.normal(scale=0.5, size=(n_rows, cfg.row_width)).astype(
        np.float32)
    table[:, 0] = rng.integers(0, 8, size=n_rows)
    table[:, cfg.opt_cols] = np.abs(table[:, cfg.opt_cols])
    table[0] = 0.0
    idx, lanes = _lanes(cfg, n_rows, 3000, card, seed=len(opt) + w_num)
    t0 = torch.from_numpy(table).to(card)
    want = kernels.scatter_accumulate_plain(t0.clone(), *lanes, cfg)
    got = kernels.scatter_accumulate(t0.clone(), *lanes, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    untouched = torch.from_numpy(np.setdiff1d(np.arange(n_rows),
                                              idx)).to(card)
    assert torch.equal(got[untouched], t0[untouched])


def test_scatter_accumulate_kernel_pad_never_clobbers_row0(card):
    cfg = EmbeddingConfig(dim=4, optimizer="sgd", learning_rate=0.0625)
    n = 64
    rng = np.random.default_rng(3)
    table = (rng.integers(-512, 512, size=(n, cfg.row_width))
             / 1024.0).astype(np.float32)
    table[0] = 0.0
    idx = np.array([0, 3, 9, n, n + 1, 0], np.int32)
    tch = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32, device=card)
    grads = np.zeros((6, cfg.grad_width), np.float32)
    grads[1:3] = 0.25
    shows = np.array([0, 1, 1, 1, 1, 0], np.float32)
    clks = np.zeros(6, np.float32)
    args = [torch.from_numpy(a).to(card) for a in (idx, grads, shows, clks)]
    t0 = torch.from_numpy(table).to(card)
    want = kernels.scatter_accumulate_plain(t0.clone(), *args, cfg,
                                            touched=tch)
    got = kernels.scatter_accumulate(t0.clone(), *args, cfg, touched=tch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[0] == 0).all())


def test_wrappers_raise_on_bad_cuda_inputs(card):
    cfg = EmbeddingConfig(dim=4)
    t = torch.zeros((10, cfg.row_width), device=card)
    with pytest.raises(ValueError, match="int32"):
        kernels.gather_pool(t, torch.zeros((2, 3), dtype=torch.int64,
                                           device=card), cfg, 3, 1)
    with pytest.raises(ValueError, match="width"):
        kernels.scatter_accumulate(
            torch.zeros((10, 600), device=card),
            torch.zeros(1, dtype=torch.int32, device=card),
            torch.zeros((1, cfg.grad_width), device=card),
            torch.zeros(1, device=card), torch.zeros(1, device=card), cfg)
