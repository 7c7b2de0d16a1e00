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


# ---------------------------------------------------------------------------
# merge_update's lane group and its run-and-ballot walk; gather_pool's
# lane group and column chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(1, 16), (17, 64), (65, 128), (129, 256),
                                   (257, 512)])
def test_mu_lane_group_covers_every_width(lo, hi):
    """Every width merge_update takes gets a group of a power of two
    lanes in the shared header's range (4 to 32, dividing the warp) that
    holds the whole row, from the instantiations csrc/merge_update.cu
    has."""
    built = {(4, 4), (8, 8), (16, 8), (32, 8), (32, 16)}
    for w in range(lo, hi + 1):
        g, cpl = kernels.mu_lane_group(w)
        assert (g, cpl) in built, w
        assert g in (4, 8, 16, 32) and g * cpl >= w, w
    # the narrowest rows (the one-hot headline's 13) get the 4-lane group
    assert kernels.mu_lane_group(13) == (4, 4)


@pytest.mark.parametrize("w", [0, -3, kernels.SA_MAX_WIDTH + 1, 600])
def test_mu_lane_group_refuses_widths_past_the_cap(w):
    with pytest.raises(ValueError):
        kernels.mu_lane_group(w)


def _mu_walk(count: np.ndarray, group: int) -> list[int]:
    """The rows merge_update's kernel updates, in the order it takes
    them: each warp owns a run of 32 rows, a lane loads one row's count,
    the ballot of count > 0 names the touched rows, and each round gives
    the next 32 / group of them to the groups in turn (a group whose
    share of the round is empty passes valid = false)."""
    rows = []
    for r0 in range(0, len(count), 32):
        rest = 0
        for lane in range(32):
            r = r0 + lane
            if r < len(count) and count[r] > 0:
                rest |= 1 << lane
        while rest:
            for grp in range(32 // group):
                m = rest
                for j in range(32 // group - 1):
                    if j < grp:
                        m &= m - 1
                if m:
                    rows.append(r0 + (m & -m).bit_length() - 1)
            for _ in range(32 // group):
                rest &= rest - 1
    return rows


def _touch_pattern(kind: str, n_rows: int) -> np.ndarray:
    count = np.zeros(n_rows, np.float32)
    if kind == "all":
        count[:] = 1
    elif kind == "every_other":
        count[::2] = 3
    elif kind == "last":
        count[-1] = 1
    elif kind == "row0":
        count[0] = 1
    return count


@pytest.mark.parametrize("width", [13, 37, 100, 300])
@pytest.mark.parametrize("kind", ["none", "all", "every_other", "last",
                                  "row0"])
@pytest.mark.parametrize("n_rows", [1, 31, 33, 32 * 3 + 5, 32 * 40 + 5])
def test_mu_walk_visits_each_touched_row_once(width, kind, n_rows):
    """Over ragged runs and every touched pattern, the walk updates each
    touched row exactly once and no other row."""
    group, _ = kernels.mu_lane_group(width)
    count = _touch_pattern(kind, n_rows)
    rows = _mu_walk(count, group)
    assert len(rows) == len(set(rows))
    np.testing.assert_array_equal(np.sort(rows), np.flatnonzero(count > 0))


def test_mu_walk_on_random_counts():
    """Random touch counts (zero, fractional, negative) over several
    runs: only counts > 0 are updated, each once."""
    rng = np.random.default_rng(4)
    count = rng.choice([0.0, 0.0, 1.0, 2.5, -1.0], 32 * 17 + 9).astype(
        np.float32)
    for width in (13, 37, 100, 300):
        rows = _mu_walk(count, kernels.mu_lane_group(width)[0])
        assert sorted(rows) == list(np.flatnonzero(count > 0))


def test_gp_lane_group_covers_every_pull_width():
    """For P = 1..600: 8 lanes up to 64 columns, 16 up to 128, 32
    beyond; columns a lane from the instantiations csrc/gather_pool.cu
    has, with at most one column of a lane past P in a chunk (the column
    loop stops at P); chunks of GP_CHUNK columns past that."""
    built = ({(8, c) for c in range(1, 9)} | {(16, c) for c in range(5, 9)}
             | {(32, c) for c in range(5, 17)})
    for p in range(1, 601):
        g, cpl = kernels.gp_lane_group(p)
        assert (g, cpl) in built, p
        assert g == (8 if p <= 64 else 16 if p <= 128 else 32), p
        width = g * cpl
        assert width >= min(p, kernels.GP_CHUNK) and width - g < p, p
        if p > kernels.GP_CHUNK:
            assert width == kernels.GP_CHUNK, p


@pytest.mark.parametrize("p", [1, 3, 35, 64, 65, 128, 129, 256, 257, 511,
                               512, 513, 600, 1100])
def test_gp_chunks_cover_each_column_once(p):
    """The kernel's column walk — chunks c0 = 0, G*CPL, ... below P, lane
    l's columns c0 + l + k*G for k < CPL, kept where < P — covers every
    pooled column exactly once."""
    g, cpl = kernels.gp_lane_group(p)
    cols = [c0 + lane + k * g
            for c0 in range(0, p, g * cpl)
            for lane in range(g) for k in range(cpl)
            if c0 + lane + k * g < p]
    assert sorted(cols) == list(range(p))


@pytest.mark.parametrize("p", [0, -1])
def test_gp_lane_group_refuses_empty_rows(p):
    with pytest.raises(ValueError):
        kernels.gp_lane_group(p)
