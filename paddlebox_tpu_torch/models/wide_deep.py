"""Wide&Deep — the port of ``models/wide_deep.py``: a linear wide part
over the per-slot scalar weights (the pulled ``w`` column, scaled per
slot) and dense floats, plus a deep MLP over seqpool+CVM features and
dense floats.
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class WideDeepModel(nn.Module):
    name = "wide_deep"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int = 0,
                 hidden: tuple[int, ...] = (256, 128, 64),
                 use_cvm: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_slots = num_slots
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.hidden = tuple(hidden)
        self.compute_dtype = compute_dtype
        slot_feat = (3 + emb_dim) if use_cvm else (1 + emb_dim)
        self.deep_in = num_slots * slot_feat + dense_dim
        self.dims = (self.deep_in, *hidden, 1)
        self.mlp = MLP(self.dims)
        # per-slot scale on the summed w column — the wide weights
        self.wide_slot = nn.Parameter(torch.ones(num_slots))
        self.bias = nn.Parameter(torch.zeros(1))
        self.wide_dense = (nn.Parameter(torch.zeros(dense_dim))
                           if dense_dim else None)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Glorot-normal MLP, unit slot scales, zero bias, N(0, 0.01²)
        wide dense weights."""
        self.mlp.init(generator)
        self.wide_slot.fill_(1.0)
        self.bias.zero_()
        if self.wide_dense is not None:
            self.wide_dense.copy_(
                torch.randn(self.dense_dim, generator=generator) * 0.01)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm, flatten=False)
        off = 2 if self.use_cvm else 0
        wide = feats[..., off] @ self.wide_slot
        x = feats.reshape(feats.shape[0], -1)
        if self.dense_dim:
            x = torch.cat([x, dense], dim=1)
            wide = wide + dense @ self.wide_dense
        deep = self.mlp(x, compute_dtype=self.compute_dtype)[:, 0]
        return wide + deep + self.bias[0]
