"""The launch arithmetic and kernel inputs the port's CUDA kernels take
from Python, on the CPU: scatter_accumulate's lane group per row width,
and the token windows binned_merge_acc walks (one block per super-block)
under every plan, on uniform, hot-row, Zipf and clipped streams.

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py); these tests hold the numbers and plans the wrappers hand
them, and the plain accumulator the card is held to.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native import key_index
from paddlebox_tpu_torch.ops import kernels

torch.set_num_threads(1)


@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 128), (129, 256),
                                   (257, 512)])
def test_sa_lane_group_covers_every_width(lo, hi):
    """Every width up to the cap gets a group whose lanes hold the whole
    row, with the group and per-lane column count the kernel is
    instantiated for; each band takes the smallest such group."""
    want = {64: (8, 8), 128: (16, 8), 256: (32, 8), 512: (32, 16)}[hi]
    for w in range(lo, hi + 1):
        g, cpl = kernels.sa_lane_group(w)
        assert (g, cpl) == want, w
        assert g * cpl >= w and 32 % g == 0


@pytest.mark.parametrize("w", [0, -1, kernels.SA_MAX_WIDTH + 1, 600])
def test_sa_lane_group_refuses_widths_outside_the_cap(w):
    with pytest.raises(ValueError):
        kernels.sa_lane_group(w)


def _stream(kind, n_rows, n_tok, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, n_tok)
    if kind == "hot":
        idx[rng.random(n_tok) < 0.6] = n_rows // 3
    elif kind == "zipf":
        idx = np.minimum(rng.zipf(1.2, n_tok), n_rows) - 1
    elif kind == "clipped":
        bad = rng.random(n_tok) < 0.2
        idx[bad] = rng.choice([-1, -70000, n_rows, n_rows + 5],
                              int(bad.sum()))
    return idx.astype(np.int32)


def _windows(plan, idx, n_rows, sb, nb):
    """(stream, order or None, rstart, end): the token stream the kernel
    reads under ``plan`` and the windows it walks."""
    if plan == "host":
        return (idx, *key_index.block_plan(idx, sb, nb))
    if plan == "device":
        o, r, e = kernels.device_block_plan(torch.from_numpy(idx), sb, nb)
        return idx, o.numpy(), r.numpy(), e.numpy()
    _, uniq, _, r, e = key_index.dedup_plan(idx, n_rows, sb, nb)
    return uniq, None, r, e


@pytest.mark.parametrize("plan", ["host", "device", "dedup_lanes"])
@pytest.mark.parametrize("kind", ["uniform", "hot", "zipf", "clipped"])
@pytest.mark.parametrize("dim,n_rows,n_tok", [(8, 5003, 20000),
                                              (8, 301, 50), (32, 9000, 3)])
def test_binned_windows_cover_every_valid_token_once(plan, kind, dim, n_rows,
                                                     n_tok):
    """Block b walks window positions [rstart[b], end[b]) and adds the
    tokens whose id lies in its rows: over all blocks each in-range token
    is added exactly once, whatever the skew, and other blocks' tokens
    sit only in a window's first 8 positions (the plans' rounding)."""
    cfg = EmbeddingConfig(dim=dim)
    sb, nb = kernels.binned_geometry(cfg, n_rows)
    idx = _stream(kind, n_rows, n_tok, seed=n_tok + len(kind))
    tokens, order, rstart, end = _windows(plan, idx, n_rows, sb, nb)
    added = []
    for b in range(nb):
        pos = np.arange(int(rstart[b]), int(end[b]))
        tok = pos if order is None else order[pos]
        mine = (tokens[tok] >= b * sb) & (tokens[tok] < min((b + 1) * sb,
                                                            n_rows))
        added.append(tok[mine])
        # past its first 8 positions a window holds only its own block's
        # tokens and ids the plans clip into it from outside the table
        other = ~mine & (tokens[tok] >= 0) & (tokens[tok] < n_rows)
        assert not other[8:].any(), b
    added = np.sort(np.concatenate(added))
    valid = np.flatnonzero((tokens >= 0) & (tokens < n_rows))
    np.testing.assert_array_equal(added, valid)


def _lattice_grads(rng, n_tok, gw):
    """Multiples of 2^-10 in [-0.5, 0.5): sums of thousands of them are
    exact in f32 in any order."""
    return (rng.integers(-512, 512, size=(n_tok, gw)) / 1024.0).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["uniform", "hot", "zipf", "clipped"])
@pytest.mark.parametrize("dim", [4, 8, 32])
def test_binned_merge_acc_cpu_matches_numpy(kind, dim):
    """The accumulator the card is held to (the wrapper on CPU tensors),
    against np.add.at on skewed streams: [grads, show, clk, count] per
    row, out-of-range ids dropped, exact on lattice grads."""
    cfg = EmbeddingConfig(dim=dim)
    n_rows, n_tok = 3001, 12000
    rng = np.random.default_rng(dim)
    idx = _stream(kind, n_rows, n_tok, seed=dim + 1)
    grads = _lattice_grads(rng, n_tok, cfg.grad_width)
    shows = np.ones(n_tok, np.float32)
    clks = (rng.random(n_tok) < 0.3).astype(np.float32)
    want = np.zeros((n_rows, cfg.grad_width + 3), np.float32)
    ok = (idx >= 0) & (idx < n_rows)
    payload = np.concatenate([grads, shows[:, None], clks[:, None],
                              np.ones((n_tok, 1), np.float32)], axis=1)
    np.add.at(want, idx[ok], payload[ok])
    sb, nb = kernels.binned_geometry(cfg, n_rows)
    plan = tuple(torch.from_numpy(a) for a in key_index.block_plan(idx, sb,
                                                                   nb))
    got = kernels.binned_merge_acc(
        *(torch.from_numpy(a) for a in (idx, grads, shows, clks)), cfg,
        n_rows, plan=plan)
    np.testing.assert_array_equal(got.numpy(), want)
