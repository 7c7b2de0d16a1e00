"""DLRM — the port of ``models/dlrm.py``: a bottom MLP maps the dense
floats onto ``emb_dim``, the interaction is the upper triangle of the
(S+1)×(S+1) Gram matrix of [dense vector, pooled slot vectors], and a top
MLP runs over [dense vector, interactions, per-slot first-order w].
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class DLRMModel(nn.Module):
    name = "dlrm"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int,
                 bottom_hidden: tuple[int, ...] = (64,),
                 top_hidden: tuple[int, ...] = (256, 128),
                 use_cvm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_slots = num_slots
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.bottom_hidden = tuple(bottom_hidden)
        self.top_hidden = tuple(top_hidden)
        self.compute_dtype = compute_dtype
        self.bottom_dims = (max(dense_dim, 1), *bottom_hidden, emb_dim)
        n_vec = num_slots + 1
        n_pairs = n_vec * (n_vec - 1) // 2
        # the top input carries the per-slot first-order w column too
        self.top_in = emb_dim + n_pairs + num_slots
        self.top_dims = (self.top_in, *top_hidden, 1)
        self.bottom = MLP(self.bottom_dims)
        self.top = MLP(self.top_dims)
        # the upper triangle's flat positions in the (S+1)² Gram matrix:
        # one index_select (its backward an index_add_)
        iu = torch.triu_indices(n_vec, n_vec, offset=1)
        self.register_buffer("_pairs", iu[0] * n_vec + iu[1],
                             persistent=False)

    def init(self, generator: torch.Generator) -> None:
        self.bottom.init(generator)
        self.top.init(generator)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        cd = self.compute_dtype
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm, flatten=False)
        off = 3 if self.use_cvm else 1
        w = feats[..., off - 1]                           # (B, S)
        v = feats[..., off:]                              # (B, S, E)
        d_in = (dense if self.dense_dim
                else torch.zeros(v.shape[0], 1, device=v.device))
        d_vec = self.bottom(d_in, final_activation="relu", compute_dtype=cd)
        allv = torch.cat([d_vec[:, None, :], v], dim=1)   # (B, S+1, E)
        a = allv.to(cd)
        gram = torch.bmm(a, a.transpose(1, 2)).float()
        inter = gram.flatten(1).index_select(1, self._pairs)  # (B, n_pairs)
        x = torch.cat([d_vec, inter, w], dim=1)
        return self.top(x, compute_dtype=cd)[:, 0]
