"""PV (page-view) ad model — the port of ``models/pv_rank.py``: rank
attention over the other ads of the same page view.

- a per-slot unshared projection of the CVM slot features (``batch_fc``
  with the slot axis as the group axis);
- ``rank_attention`` over same-PV peers;
- an MLP head over [slot features, attention output, dense].

The model declares ``batch_extras``: the trainer calls it on its pack
thread per batch, beside translate and the push plan, to build
``rank_offset`` from the batch's (rank, search_id) columns, and passes
the result to the model after the standard arguments. Peer indices are
built per contiguous batch shard (one shard on one card), so a PV's
peers always lie in the same shard.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP
from paddlebox_tpu_torch.ops.batch_fc import batch_fc
from paddlebox_tpu_torch.ops.rank_attention import (build_rank_offset,
                                                    rank_attention)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class PVRankModel(nn.Module):
    name = "pv_rank"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True
    num_extras = 1      # rank_offset, staged by the trainer per batch

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int = 0,
                 hidden: tuple[int, ...] = (64, 32), max_rank: int = 3,
                 slot_proj: int = 8, att_dim: int = 8, use_cvm: bool = True):
        super().__init__()
        self.num_slots = num_slots
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.hidden = tuple(hidden)
        self.max_rank = max_rank
        self.slot_proj = slot_proj
        self.att_dim = att_dim
        self.use_cvm = use_cvm
        self.slot_feat = (3 + emb_dim) if use_cvm else (1 + emb_dim)
        self.x_dim = num_slots * slot_proj
        self.dims = (self.x_dim + att_dim + dense_dim, *self.hidden, 1)
        S, C, d, K = num_slots, self.slot_feat, slot_proj, max_rank
        self.slot_w = nn.Parameter(torch.zeros(S, C, d))
        self.slot_b = nn.Parameter(torch.zeros(S, d))
        self.rank_param = nn.Parameter(torch.zeros(K * K * self.x_dim,
                                                   att_dim))
        self.mlp = MLP(self.dims)
        self.bias = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        S, C, d = self.slot_w.shape
        self.slot_w.copy_(torch.randn(S, C, d, generator=generator)
                          * (2.0 / (C + d)) ** 0.5)
        self.slot_b.zero_()
        self.rank_param.copy_(torch.randn(*self.rank_param.shape,
                                          generator=generator) * 0.02)
        self.mlp.init(generator)
        self.bias.zero_()

    def batch_extras(self, pb, n_shards: int = 1) -> tuple[np.ndarray]:
        """Pack stage: rank_offset with shard-local peer indices, one
        build per contiguous batch shard."""
        B = len(pb.rank)
        groups = (pb.search_id if pb.search_id is not None
                  else np.zeros(B, np.uint64))
        bl = B // n_shards
        parts = [build_rank_offset(pb.rank[s * bl:(s + 1) * bl],
                                   groups[s * bl:(s + 1) * bl],
                                   self.max_rank)
                 for s in range(n_shards)]
        return (np.concatenate(parts, axis=0),)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None,
                rank_offset: torch.Tensor | None = None) -> torch.Tensor:
        if rank_offset is None:
            raise ValueError("PVRankModel needs the rank_offset extra (the "
                             "trainer stages it through batch_extras)")
        B = pulled.shape[0]
        feats = fused_seqpool_cvm(pulled, mask, segment_ids,
                                  self.num_slots, use_cvm=self.use_cvm,
                                  flatten=False)          # (B, S, C)
        # per-slot unshared projection: slots are the batch_fc group axis
        proj = batch_fc(feats.transpose(0, 1), self.slot_w, self.slot_b,
                        activation="relu")                # (S, B, d)
        x = proj.transpose(0, 1).reshape(B, self.x_dim)
        att = rank_attention(x, rank_offset, self.rank_param,
                             self.max_rank)               # (B, att_dim)
        parts = [x, att, dense] if self.dense_dim else [x, att]
        return self.mlp(torch.cat(parts, dim=1))[:, 0] + self.bias[0]
