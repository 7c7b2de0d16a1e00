"""DNN-CTR — the port of ``models/dnn_ctr.py``: the Criteo-Kaggle
baseline tower. Per-slot embeddings are seqpool+CVM'd, concatenated with
the dense features and fed through a ReLU MLP to a sigmoid CTR head.
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class DNNCTRModel(nn.Module):
    name = "dnn_ctr"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int = 0,
                 hidden: tuple[int, ...] = (512, 256, 128),
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
        self.in_dim = num_slots * slot_feat + dense_dim
        self.dims = (self.in_dim, *hidden, 1)
        self.mlp = MLP(self.dims)

    def init(self, generator: torch.Generator) -> None:
        self.mlp.init(generator)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm)
        x = torch.cat([feats, dense], dim=1) if self.dense_dim else feats
        return self.mlp(x, compute_dtype=self.compute_dtype)[:, 0]
