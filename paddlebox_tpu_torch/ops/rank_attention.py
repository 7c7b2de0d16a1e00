"""Rank attention — the port of ``ops/rank_attention.py``: each example
(an ad impression) attends over the other ads of its page view (PV) with
a parameter block per (own rank, peer rank) pair.

``rank_offset`` (B, 2*max_rank+1) int: col 0 = the example's own rank
(1-based, 0 = invalid); for k in [0, max_rank): col 2k+1 = the rank of
the k-th PV peer (0 = absent), col 2k+2 = that peer's row in the batch.
``rank_param`` (max_rank*max_rank*in_dim, out_dim) holds one (in_dim,
out_dim) block per rank pair.

``build_rank_offset`` (vectorised, the trainer's pack stage) and
``build_rank_offset_reference`` (a literal per-member loop) build the
matrix on the host from per-example ranks and PV group ids; they are
the port's own copies of the JAX package's NumPy builders.
"""

from __future__ import annotations

import numpy as np
import torch


def rank_attention(x: torch.Tensor, rank_offset: torch.Tensor,
                   rank_param: torch.Tensor, max_rank: int) -> torch.Tensor:
    """x (B, in_dim), rank_offset (B, 2*max_rank+1) int,
    rank_param (max_rank*max_rank*in_dim, out_dim) → (B, out_dim).

    Each valid peer's row meets every rank-pair block in one product,
    (B, K, I) x (R², I, O) → (B, K, R², O), and the pair's block is
    picked after it: the same sum as gathering a (B, K, I, O) block per
    peer, without materialising it."""
    B, in_dim = x.shape
    out_dim = rank_param.shape[1]
    n_blk = max_rank * max_rank
    ro = rank_offset.long()
    ins_rank = ro[:, 0]                                  # (B,)
    peer_rank = ro[:, 1::2]                              # (B, K)
    peer_idx = ro[:, 2::2]                               # (B, K)
    valid = (ins_rank > 0)[:, None] & (peer_rank > 0)
    xg = x.index_select(0, peer_idx.clamp(0, B - 1).reshape(-1)).reshape(
        B, -1, in_dim)                                   # (B, K, I)
    xg = torch.where(valid[..., None], xg, xg.new_zeros(()))
    blk = ((ins_rank[:, None] - 1) * max_rank + (peer_rank - 1)).clamp(
        0, n_blk - 1)                                    # (B, K)
    params = rank_param.reshape(n_blk, in_dim, out_dim)
    every = torch.einsum("bki,nio->bkno", xg, params)    # (B, K, R², O)
    picked = torch.gather(
        every, 2, blk[:, :, None, None].expand(B, blk.shape[1], 1, out_dim))
    return picked[:, :, 0].sum(dim=1)


def build_rank_offset(ranks: np.ndarray, pv_groups: np.ndarray,
                      max_rank: int) -> np.ndarray:
    """The rank_offset matrix from per-example rank + PV group ids.

    ranks     : (B,) int 1-based ad rank within its PV (0 = invalid)
    pv_groups : (B,) int group id, equal for examples of the same PV
    Returns (B, 2*max_rank+1) int32. Vectorised — it runs on the pack
    thread per batch; when several members of a PV share a rank, the
    last (highest index) wins, like the reference kernel's last-writer
    scatter."""
    ranks = np.asarray(ranks)
    pv_groups = np.asarray(pv_groups)
    B = len(ranks)
    out = np.zeros((B, 2 * max_rank + 1), dtype=np.int32)
    out[:, 0] = ranks
    if B == 0:
        return out
    sel = np.flatnonzero((ranks >= 1) & (ranks <= max_rank))
    if len(sel):
        # last member per (group, rank): lexsort by (group, rank, idx)
        order = np.lexsort((sel, ranks[sel], pv_groups[sel]))
        s = sel[order]
        gg, rr = pv_groups[s], ranks[s]
        is_last = np.ones(len(s), bool)
        is_last[:-1] = (gg[1:] != gg[:-1]) | (rr[1:] != rr[:-1])
        lg, lr, lj = gg[is_last], rr[is_last], s[is_last]
        ug, gpos = np.unique(lg, return_inverse=True)
        peer_r = np.zeros((len(ug), max_rank), np.int32)
        peer_j = np.zeros((len(ug), max_rank), np.int32)
        peer_r[gpos, lr - 1] = lr
        peer_j[gpos, lr - 1] = lj
        gi = np.searchsorted(ug, pv_groups)
        gi_c = np.minimum(gi, len(ug) - 1)
        want = (ranks > 0) & (ug[gi_c] == pv_groups)
        out[:, 1::2] = np.where(want[:, None], peer_r[gi_c], 0)
        out[:, 2::2] = np.where(want[:, None], peer_j[gi_c], 0)
    return out


def build_rank_offset_reference(ranks: np.ndarray, pv_groups: np.ndarray,
                                max_rank: int) -> np.ndarray:
    """A straightforward per-member loop — the ground truth the
    vectorised builder is tested against."""
    B = len(ranks)
    out = np.zeros((B, 2 * max_rank + 1), dtype=np.int32)
    out[:, 0] = ranks
    by_group: dict[int, list[int]] = {}
    for i, g in enumerate(np.asarray(pv_groups).tolist()):
        by_group.setdefault(g, []).append(i)
    for members in by_group.values():
        for i in members:
            if ranks[i] <= 0:
                continue
            for j in members:
                r = int(ranks[j])
                if 1 <= r <= max_rank:
                    out[i, 2 * (r - 1) + 1] = r
                    out[i, 2 * (r - 1) + 2] = j
    return out
