"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips without a CUDA
card and nvcc. The file imports no JAX, so it runs where only the port's
dependencies are installed, without the JAX harness in tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: gather_pool rtol 1e-6 / atol 1e-6, scatter_accumulate
rtol 1e-5 / atol 1e-6, merge_update rtol 1e-6 / atol 1e-6 (the reference
kernel tests'); binned_merge_acc's grad columns atol 2e-5 / rtol 1e-4
(test_binned_push.py's: shared-memory atomics sum in a varying order)
and its show, clk and count columns exactly; rows no lane names keep
their exact bits.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.embedding import sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native.key_index import block_plan, dedup_plan
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


def _raw_tokens(cfg, n_rows, n_tok, card, seed, skew=False, bad=False):
    """A raw token stream on the card; masked tokens (id 0) carry a zero
    payload, as the trainer's do."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n_tok)
    if skew:
        idx[:n_tok // 2] = rng.integers(0, 20, n_tok // 2)
    if bad:
        m = rng.random(n_tok) < 0.1
        idx[m] = rng.choice([-1, -9, n_rows, n_rows + 3], int(m.sum()))
    idx = idx.astype(np.int32)
    grads = rng.normal(scale=0.3, size=(n_tok, cfg.grad_width)).astype(
        np.float32)
    shows = (idx != 0).astype(np.float32)
    clks = (rng.random(n_tok) < 0.3).astype(np.float32) * shows
    grads[idx == 0] = 0.0
    return idx, [torch.from_numpy(a).to(card)
                 for a in (idx, grads, shows, clks)]


def _assert_acc(got, want, gw):
    torch.testing.assert_close(got[:, :gw], want[:, :gw], atol=2e-5,
                               rtol=1e-4)
    assert torch.equal(got[:, gw:], want[:, gw:])


@pytest.mark.parametrize("plan", ["device", "host", "dedup_lanes"])
@pytest.mark.parametrize("dim,case", [(8, "uniform"), (8, "skew"),
                                      (8, "bad"), (32, "bad")])
def test_binned_merge_acc_kernel_matches_plain(card, plan, dim, case):
    cfg = EmbeddingConfig(dim=dim, optimizer="adagrad")
    n_rows = 5003                                # a ragged last block
    idx, args = _raw_tokens(cfg, n_rows, 20000, card, seed=dim,
                            skew=case == "skew", bad=case == "bad")
    SB, NB = kernels.binned_geometry(cfg, n_rows)
    p = None
    if plan == "host":
        p = tuple(torch.from_numpy(a).to(card)
                  for a in block_plan(idx, SB, NB))
    elif plan == "dedup_lanes":
        o, u, s, r, e = dedup_plan(idx, n_rows, SB, NB)
        d = sharded.DedupPlan(*(torch.from_numpy(a).to(card)
                                for a in (o, u, s, r, e)))
        args = list(sharded.plan_premerge(*args, d))
        p = (None, d.rstart, d.end)
    want = kernels.binned_merge_acc_plain(*args, cfg, n_rows)
    n0 = kernels.binned_merge_acc.launches
    got = kernels.binned_merge_acc(*args, cfg, n_rows, plan=p)
    torch.cuda.synchronize()
    assert kernels.binned_merge_acc.launches == n0 + 1
    _assert_acc(got, want, cfg.grad_width)


def test_binned_merge_acc_kernel_all_pad_batch(card):
    cfg = EmbeddingConfig(dim=8)
    n = 4096
    idx = torch.zeros(n, dtype=torch.int32, device=card)
    z = torch.zeros((n, cfg.grad_width), device=card)
    zs = torch.zeros(n, device=card)
    got = kernels.binned_merge_acc(idx, z, zs, zs, cfg, 3000)
    torch.cuda.synchronize()
    want = torch.zeros((3000, cfg.grad_width + 3), device=card)
    want[0, -1] = n
    assert torch.equal(got, want)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "ftrl"])
@pytest.mark.parametrize("w_num,gated", [(1, False), (2, True)])
def test_merge_update_kernel_matches_plain(card, opt, w_num, gated):
    if opt == "ftrl" and w_num > 1:
        w_num = 1                      # ftrl has no w block
    kw = dict(dim=16, optimizer=opt, embed_w_num=w_num)
    if gated:
        kw.update(expand_dim=8, mf_create_threshold=4.0,
                  expand_create_threshold=7.0)
    cfg = EmbeddingConfig(**kw)
    n_rows = 3000
    rng = np.random.default_rng(len(opt) + w_num)
    table = rng.normal(scale=0.5, size=(n_rows, cfg.row_width)).astype(
        np.float32)
    table[:, 0] = rng.integers(0, 8, size=n_rows)
    table[:, cfg.opt_cols] = np.abs(table[:, cfg.opt_cols])
    table[0] = 0.0
    idx, args = _raw_tokens(cfg, n_rows, 2000, card, seed=w_num)
    acc = kernels.binned_merge_acc_plain(*args, cfg, n_rows)
    t0 = torch.from_numpy(table).to(card)
    want = kernels.merge_update_plain(t0.clone(), acc, cfg)
    n0 = kernels.merge_update.launches
    got = kernels.merge_update(t0.clone(), acc, cfg)
    torch.cuda.synchronize()
    assert kernels.merge_update.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    untouched = torch.from_numpy(np.setdiff1d(np.arange(n_rows),
                                              idx)).to(card)
    assert torch.equal(got[untouched], t0[untouched])
    assert bool((got[0] == 0).all())     # touched, zero payload


def test_push_engines_launch_their_kernels(card, monkeypatch):
    """On the card the binned engine runs both kernels once and the
    xla_scatter engine's update runs merge_update."""
    from paddlebox_tpu_torch.config import flags
    cfg = EmbeddingConfig(dim=8)
    n_rows = 2000
    t = torch.zeros((n_rows, cfg.row_width), device=card)
    _, args = _raw_tokens(cfg, n_rows, 3000, card, seed=4)
    for engine, acc_n, mu_n in (("binned_kernel", 1, 1),
                                ("xla_scatter", 0, 1)):
        monkeypatch.setattr(flags, "push_engine", engine)
        a0 = kernels.binned_merge_acc.launches
        m0 = kernels.merge_update.launches
        assert sharded.push(t, *args, cfg) == engine
        assert kernels.binned_merge_acc.launches == a0 + acc_n
        assert kernels.merge_update.launches == m0 + mu_n
    torch.cuda.synchronize()


def test_binned_wrappers_raise_on_bad_cuda_inputs(card):
    cfg = EmbeddingConfig(dim=4)
    idx = torch.zeros(3, dtype=torch.int64, device=card)
    g = torch.zeros((3, cfg.grad_width), device=card)
    s = torch.zeros(3, device=card)
    with pytest.raises(ValueError, match="int32"):
        kernels.binned_merge_acc(idx, g, s, s, cfg, 10)
    with pytest.raises(ValueError, match="acc"):
        kernels.merge_update(torch.zeros((10, cfg.row_width), device=card),
                             torch.zeros((9, cfg.grad_width + 3),
                                         device=card), cfg)
    with pytest.raises(ValueError, match="width"):
        kernels.merge_update(torch.zeros((10, 600), device=card),
                             torch.zeros((10, cfg.grad_width + 3),
                                         device=card), cfg)


# ---------------------------------------------------------------------------
# the lane-group layout of scatter_accumulate and skewed streams through
# binned_merge_acc
# ---------------------------------------------------------------------------

_N_STATE = {"sgd": 0, "adagrad": 2, "adam": 4, "ftrl": 3}
# row widths on each side of every lane-group boundary (8 | 16 | 32 lanes,
# 8 | 16 columns a lane), up to the 512-column cap
_SA_WIDTHS = [13, 37, 64, 65, 128, 129, 256, 257, 512]


def _width_cfg(opt, row_width, **kw):
    cfg = EmbeddingConfig(dim=row_width - 3 - _N_STATE[opt], optimizer=opt,
                          learning_rate=0.05, **kw)
    assert cfg.row_width == row_width
    return cfg


def _sa_table(cfg, n_rows, rng):
    table = rng.normal(scale=0.5, size=(n_rows, cfg.row_width)).astype(
        np.float32)
    table[:, 0] = rng.integers(0, 8, size=n_rows)
    table[:, cfg.opt_cols] = np.abs(table[:, cfg.opt_cols])
    table[0] = 0.0
    return table


@pytest.mark.parametrize("opt", sorted(_N_STATE))
@pytest.mark.parametrize("row_width", _SA_WIDTHS)
def test_scatter_accumulate_kernel_at_group_boundaries(card, opt,
                                                       row_width):
    cfg = _width_cfg(opt, row_width, mf_create_threshold=3.0)
    n_rows = 700
    rng = np.random.default_rng(row_width)
    table = _sa_table(cfg, n_rows, rng)
    idx, lanes = _lanes(cfg, n_rows, 2500, card, seed=row_width + 1)
    t0 = torch.from_numpy(table).to(card)
    want = kernels.scatter_accumulate_plain(t0.clone(), *lanes, cfg)
    n0 = kernels.scatter_accumulate.launches
    got = kernels.scatter_accumulate(t0.clone(), *lanes, cfg)
    torch.cuda.synchronize()
    assert kernels.scatter_accumulate.launches == n0 + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    untouched = torch.from_numpy(np.setdiff1d(np.arange(n_rows),
                                              idx)).to(card)
    assert torch.equal(got[untouched], t0[untouched])


@pytest.mark.parametrize("row_width", [13, 65, 129, 257])
@pytest.mark.parametrize("n_lanes", [1, 3, 5, 31, 33, 257])
def test_scatter_accumulate_kernel_ragged_lane_counts(card, row_width,
                                                      n_lanes):
    """Lane counts that leave the last warp (or block) part full."""
    cfg = _width_cfg("adagrad", row_width)
    n_rows = 400
    rng = np.random.default_rng(n_lanes)
    table = _sa_table(cfg, n_rows, rng)
    idx = np.sort(rng.choice(np.arange(1, n_rows), n_lanes,
                             replace=False)).astype(np.int32)
    args = [torch.from_numpy(a).to(card) for a in (
        idx, rng.normal(scale=0.3, size=(n_lanes, cfg.grad_width)).astype(
            np.float32), np.ones(n_lanes, np.float32),
        rng.integers(0, 2, n_lanes).astype(np.float32))]
    t0 = torch.from_numpy(table).to(card)
    want = kernels.scatter_accumulate_plain(t0.clone(), *args, cfg)
    got = kernels.scatter_accumulate(t0.clone(), *args, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    keep = torch.ones(n_rows, dtype=torch.bool, device=card)
    keep[args[0].long()] = False
    assert torch.equal(got[keep], t0[keep])


@pytest.mark.parametrize("opt", sorted(_N_STATE))
@pytest.mark.parametrize("row_width", [13, 37, 129, 512])
def test_scatter_accumulate_kernel_interleaved_pads(card, opt, row_width):
    """Pads anywhere in the lane list — out-of-range ids on both sides
    and in-range lanes whose touched flag is 0, between valid lanes —
    never read or write; row 0 is a real lane with a zero payload."""
    cfg = _width_cfg(opt, row_width)
    n_rows, n = 600, 450
    rng = np.random.default_rng(row_width + len(opt))
    table = _sa_table(cfg, n_rows, rng)
    idx = np.sort(rng.choice(n_rows, n, replace=False)).astype(np.int32)
    idx[0] = 0
    bad = rng.random(n) < 0.3
    bad[0] = False
    idx[bad] = rng.choice([-1, -50, n_rows, n_rows + 7], int(bad.sum()))
    touched = (rng.random(n) < 0.8).astype(np.float32)
    touched[0] = 1.0
    grads = rng.normal(scale=0.3, size=(n, cfg.grad_width)).astype(
        np.float32)
    grads[0] = 0.0
    shows = np.ones(n, np.float32)
    shows[0] = 0.0
    clks = np.zeros(n, np.float32)
    args = [torch.from_numpy(a).to(card) for a in (idx, grads, shows, clks)]
    tch = torch.from_numpy(touched).to(card)
    t0 = torch.from_numpy(table).to(card)
    want = kernels.scatter_accumulate_plain(t0.clone(), *args, cfg,
                                            touched=tch)
    got = kernels.scatter_accumulate(t0.clone(), *args, cfg, touched=tch)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    written = (idx >= 0) & (idx < n_rows) & (touched > 0)
    keep = np.setdiff1d(np.arange(n_rows), idx[written])
    keep_t = torch.from_numpy(keep).to(card)
    assert torch.equal(got[keep_t], t0[keep_t])
    assert bool((got[0] == 0).all())
    # an all-pad lane list leaves the table bit-identical
    allpad = [torch.full((n,), n_rows + 1, dtype=torch.int32, device=card),
              *args[1:]]
    got0 = kernels.scatter_accumulate(t0.clone(), *allpad, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got0, t0)


def _lattice_grads(rng, n_tok, gw):
    """Multiples of 2^-10 in [-0.5, 0.5): the sums of a hot row's
    thousands of tokens are exact in f32 in any order, so the kernel is
    held to the plain version without summation-order slack."""
    return (rng.integers(-512, 512, size=(n_tok, gw)) / 1024.0).astype(
        np.float32)


def _zipf_tokens(cfg, n_rows, n_tok, card, seed, a=1.1):
    """A Zipf-skewed token stream over a random permutation of the rows
    (Criteo-like hot keys), masked tokens on row 0 with a zero payload."""
    rng = np.random.default_rng(seed)
    rank = np.minimum(rng.zipf(a, n_tok), n_rows - 1)
    perm = rng.permutation(np.arange(1, n_rows))
    idx = perm[rank - 1].astype(np.int32)
    idx[rng.random(n_tok) < 0.05] = 0
    grads = _lattice_grads(rng, n_tok, cfg.grad_width)
    shows = (idx != 0).astype(np.float32)
    clks = (rng.random(n_tok) < 0.3).astype(np.float32) * shows
    grads[idx == 0] = 0.0
    return idx, [torch.from_numpy(a).to(card)
                 for a in (idx, grads, shows, clks)]


def _binned_plan(kind, idx, args, cfg, n_rows, card):
    SB, NB = kernels.binned_geometry(cfg, n_rows)
    if kind == "device":
        return args, None
    if kind == "host":
        return args, tuple(torch.from_numpy(a).to(card)
                           for a in block_plan(idx, SB, NB))
    o, u, s, r, e = dedup_plan(idx, n_rows, SB, NB)
    d = sharded.DedupPlan(*(torch.from_numpy(a).to(card)
                            for a in (o, u, s, r, e)))
    return list(sharded.plan_premerge(*args, d)), (None, d.rstart, d.end)


@pytest.mark.parametrize("plan", ["device", "host", "dedup_lanes"])
@pytest.mark.parametrize("dim", [8, 32])
def test_binned_merge_acc_kernel_zipf_stream(card, plan, dim):
    cfg = EmbeddingConfig(dim=dim, optimizer="adagrad")
    n_rows = 20011
    idx, args = _zipf_tokens(cfg, n_rows, 60000, card, seed=dim)
    args, p = _binned_plan(plan, idx, args, cfg, n_rows, card)
    want = kernels.binned_merge_acc_plain(*args, cfg, n_rows)
    got = kernels.binned_merge_acc(*args, cfg, n_rows, plan=p)
    torch.cuda.synchronize()
    _assert_acc(got, want, cfg.grad_width)
    assert torch.equal(got, want)          # lattice grads: sums are exact


@pytest.mark.parametrize("plan", ["device", "host"])
@pytest.mark.parametrize("hot", ["first_row", "block_edge", "last_row"])
def test_binned_merge_acc_kernel_hot_row(card, plan, hot):
    """One row holds far more tokens than a block has threads, so every
    warp of its block meets it in every batch; the row after it is hot
    too, and at the block edge that one opens the next block's window."""
    cfg = EmbeddingConfig(dim=8, optimizer="adagrad")
    n_rows = 9000
    SB, NB = kernels.binned_geometry(cfg, n_rows)
    row = {"first_row": SB, "block_edge": 2 * SB - 1,
           "last_row": n_rows - 1}[hot]
    rng = np.random.default_rng(len(hot))
    n_tok = 30000
    idx = rng.integers(0, n_rows, n_tok)
    idx[rng.random(n_tok) < 0.4] = row
    idx[rng.random(n_tok) < 0.05] = min(row + 1, n_rows - 1)
    idx = idx.astype(np.int32)
    grads = _lattice_grads(rng, n_tok, cfg.grad_width)
    shows = np.ones(n_tok, np.float32)
    clks = (rng.random(n_tok) < 0.3).astype(np.float32)
    args = [torch.from_numpy(a).to(card) for a in (idx, grads, shows, clks)]
    args, p = _binned_plan(plan, idx, args, cfg, n_rows, card)
    want = kernels.binned_merge_acc_plain(*args, cfg, n_rows)
    got = kernels.binned_merge_acc(*args, cfg, n_rows, plan=p)
    torch.cuda.synchronize()
    _assert_acc(got, want, cfg.grad_width)
    assert torch.equal(got, want)          # lattice grads: sums are exact
    assert int(got[row, -1]) == int((idx == row).sum())
