"""DeepFM — the port of ``models/deepfm.py``.

wide: the per-feature scalar weight w summed per example;
FM second order: 0.5 * ((Σ_s v_s)² - Σ_s v_s²) over slot vectors;
deep: MLP over [CVM features, dense].
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class DeepFMModel(nn.Module):
    name = "deepfm"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int = 0,
                 hidden: tuple[int, ...] = (400, 400, 400),
                 use_cvm: bool = True):
        super().__init__()
        self.num_slots = num_slots
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.use_cvm = use_cvm
        self.hidden = tuple(hidden)
        slot_feat = (3 + emb_dim) if use_cvm else (1 + emb_dim)
        self.deep_in = num_slots * slot_feat + dense_dim
        self.dims = (self.deep_in, *hidden, 1)
        self.mlp = MLP(self.dims)
        self.bias = nn.Parameter(torch.zeros(1))
        self.wide_dense = (nn.Parameter(torch.zeros(dense_dim))
                           if dense_dim else None)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Fresh parameters: glorot-normal MLP, zero bias, N(0, 0.01²)
        wide dense weights."""
        self.mlp.init(generator)
        self.bias.zero_()
        if self.wide_dense is not None:
            self.wide_dense.copy_(
                torch.randn(self.dense_dim, generator=generator) * 0.01)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm, flatten=False)
        # feats (B, S, slot_feat): [log show, log ctr, w, embedx] if cvm
        off = 2 if self.use_cvm else 0
        w = feats[..., off]
        v = feats[..., off + 1:]
        wide = torch.sum(w, dim=1)
        sum_v = torch.sum(v, dim=1)
        fm = 0.5 * torch.sum(sum_v * sum_v - torch.sum(v * v, dim=1), dim=1)
        x = feats.reshape(feats.shape[0], -1)
        if self.dense_dim:
            x = torch.cat([x, dense], dim=1)
            wide = wide + dense @ self.wide_dense
        deep = self.mlp(x)[:, 0]
        return wide + fm + deep + self.bias[0]
