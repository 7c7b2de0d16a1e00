"""ShareEmbedding feature type — the port of ``ops/share_embedding.py``.

Several slots share one key space and one embedx vector, but the row
carries a scalar embed weight per sharing slot: with
``EmbeddingConfig(embed_w_num=N)`` pulls return ``[show, clk,
w_0..w_{N-1}, embedx]``, and ``select_share_embedding`` maps that to the
standard ``[show, clk, w, embedx]`` view with each slot reading its own
plane. Its autograd sends each slot's w gradient back to that plane only,
while embedx gradients of all sharing slots merge on the common row.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig


def select_share_embedding(pulled: torch.Tensor, segment_ids,
                           slot_share_idx, cfg: EmbeddingConfig
                           ) -> torch.Tensor:
    """(B, T, pull_width) → (B, T, 3 + total_dim) standard pull view.

    segment_ids    : (T,) slot id per token position (SparseLayout)
    slot_share_idx : (num_slots,) which w plane each slot reads, in
                     [0, embed_w_num)"""
    n = cfg.embed_w_num
    share = torch.as_tensor(
        np.asarray(slot_share_idx, np.int64)[np.asarray(segment_ids,
                                                        np.int64)],
        device=pulled.device)                                  # (T,)
    w_block = pulled[..., 2:2 + n]                             # (B, T, n)
    w_sel = torch.gather(
        w_block, 2, share[None, :, None].expand(*w_block.shape[:2], 1))
    return torch.cat([pulled[..., :2], w_sel, pulled[..., 2 + n:]], dim=-1)


class ShareEmbeddingModel(nn.Module):
    """Wrap any zoo model to consume a share-embedding table: the pulled
    block is narrowed to the standard layout (each slot reading its
    shared-w plane) before the inner model runs. The parameters are the
    inner model's, under the same JAX paths (``weights.py`` reads them
    through ``param_root``)."""

    def __init__(self, inner: nn.Module, slot_share_idx,
                 cfg: EmbeddingConfig):
        super().__init__()
        if len(slot_share_idx) == 0:
            raise ValueError("slot_share_idx must name every slot")
        idx = np.asarray(slot_share_idx, np.int32)
        if idx.min() < 0 or idx.max() >= cfg.embed_w_num:
            raise ValueError(
                f"slot_share_idx entries must be in [0, {cfg.embed_w_num})")
        self.inner = inner
        self.slot_share_idx = idx
        self.cfg = cfg
        self.emb_dim = getattr(inner, "emb_dim", None)

    @property
    def param_root(self) -> nn.Module:
        return self.inner

    def init(self, generator: torch.Generator) -> None:
        self.inner.init(generator)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None,
                *extras) -> torch.Tensor:
        narrowed = select_share_embedding(pulled, segment_ids,
                                          self.slot_share_idx, self.cfg)
        return self.inner(narrowed, mask, dense, segment_ids, num_slots,
                          *extras)
