"""DCN-v2 — the port of ``models/dcn.py``: deep & cross network with
full-matrix cross layers, x_{l+1} = x0 ⊙ (x_l W_l + b_l) + x_l, beside a
deep tower over x0; both concatenate into the logit layer.
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP, Dense, matmul
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class DCNv2Model(nn.Module):
    name = "dcn_v2"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int = 0,
                 hidden: tuple[int, ...] = (256, 128),
                 num_cross_layers: int = 3, use_cvm: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_slots = num_slots
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.hidden = tuple(hidden)
        self.num_cross_layers = num_cross_layers
        self.compute_dtype = compute_dtype
        slot_feat = (3 + emb_dim) if use_cvm else (1 + emb_dim)
        self.in_dim = num_slots * slot_feat + dense_dim
        self.deep_dims = (self.in_dim, *hidden)
        self.head_in = self.in_dim + hidden[-1]
        self.cross = nn.ModuleList(Dense(self.in_dim, self.in_dim)
                                   for _ in range(num_cross_layers))
        self.deep = MLP(self.deep_dims)
        self.head = Dense(self.head_in, 1)

    def init(self, generator: torch.Generator) -> None:
        for layer in self.cross:
            layer.init(generator)
        self.deep.init(generator)
        self.head.init(generator)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm)
        x0 = torch.cat([feats, dense], dim=1) if self.dense_dim else feats
        cd = self.compute_dtype
        x = x0
        for layer in self.cross:
            x = x0 * (matmul(x, layer.w, cd) + layer.b) + x
        deep = self.deep(x0, final_activation="relu", compute_dtype=cd)
        h = torch.cat([x, deep], dim=1)
        return (matmul(h, self.head.w, cd) + self.head.b)[:, 0]
