"""DLRM — the port of ``models/dlrm.py``: a bottom MLP maps the dense
floats onto ``emb_dim``, the interaction is the upper triangle of the
(S+1)×(S+1) Gram matrix of [dense vector, pooled slot vectors], and a top
MLP runs over [dense vector, interactions, per-slot first-order w].

``DLRMDCNv2Model`` is MLPerf Training's DLRM-DCNv2 (torchrec's
``DLRM_DCN``), which the JAX package does not have: the same bottom net
and pooled slots, with a low-rank DCN-v2 cross network
(``models/dcn.py``'s ``LowRankCrossNet``) over the flat [dense vector,
pooled slot vectors] in place of the dot interaction.
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.models.dcn import LowRankCrossNet
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
        self.top_in = self._build_interaction()
        self.top_dims = (self.top_in, *top_hidden, 1)
        self.bottom = MLP(self.bottom_dims)
        self.top = MLP(self.top_dims)

    def _build_interaction(self) -> int:
        """The interaction's own state; returns the top net's input
        width."""
        n_vec = self.num_slots + 1
        # the upper triangle's flat positions in the (S+1)² Gram matrix:
        # one index_select (its backward an index_add_)
        iu = torch.triu_indices(n_vec, n_vec, offset=1)
        self.register_buffer("_pairs", iu[0] * n_vec + iu[1],
                             persistent=False)
        # the top input carries the per-slot first-order w column too
        return self.emb_dim + n_vec * (n_vec - 1) // 2 + self.num_slots

    def init(self, generator: torch.Generator) -> None:
        self.bottom.init(generator)
        self.top.init(generator)

    def embed(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
              segment_ids):
        """The bottom net's output (B, E), the pooled slot vectors (B, S,
        E) and the slots' pooled first-order w (B, S)."""
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm, flatten=False)
        off = 3 if self.use_cvm else 1
        w = feats[..., off - 1]                           # (B, S)
        v = feats[..., off:]                              # (B, S, E)
        d_in = (dense if self.dense_dim
                else torch.zeros(v.shape[0], 1, device=v.device))
        d_vec = self.bottom(d_in, final_activation="relu",
                            compute_dtype=self.compute_dtype)
        return d_vec, v, w

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        cd = self.compute_dtype
        d_vec, v, w = self.embed(pulled, mask, dense, segment_ids)
        allv = torch.cat([d_vec[:, None, :], v], dim=1)   # (B, S+1, E)
        a = allv.to(cd)
        gram = torch.bmm(a, a.transpose(1, 2)).float()
        inter = gram.flatten(1).index_select(1, self._pairs)  # (B, n_pairs)
        x = torch.cat([d_vec, inter, w], dim=1)
        return self.top(x, compute_dtype=cd)[:, 0]


class DLRMDCNv2Model(DLRMModel):
    """x0 = [bottom output, the S pooled slot vectors] flat, (S+1)·E wide;
    ``num_cross_layers`` low-rank cross layers of rank ``low_rank_dim``
    over it; the top net reads the cross output alone.

    As in the published model, each slot's first-order w is pulled and
    pooled but never read: the table's w column takes zero gradients, so
    the sparse optimizer leaves it where it was initialised."""

    name = "dlrm_dcnv2"

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int,
                 bottom_hidden: tuple[int, ...] = (64,),
                 top_hidden: tuple[int, ...] = (256, 128),
                 num_cross_layers: int = 3, low_rank_dim: int = 512,
                 use_cvm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_slots, emb_dim, dense_dim, bottom_hidden,
                         top_hidden, use_cvm, compute_dtype)
        self.num_cross_layers = num_cross_layers
        self.low_rank_dim = low_rank_dim
        self.cross = LowRankCrossNet(self.top_in, low_rank_dim,
                                     num_cross_layers)

    def _build_interaction(self) -> int:
        # the cross network keeps its input's width
        return (self.num_slots + 1) * self.emb_dim

    def init(self, generator: torch.Generator) -> None:
        super().init(generator)
        self.cross.init(generator)

    def interaction_input(self, pulled, mask: torch.Tensor,
                          dense: torch.Tensor, segment_ids) -> torch.Tensor:
        """x0, (B, (S+1)·E): [bottom output, pooled slot vectors] flat."""
        d_vec, v, _ = self.embed(pulled, mask, dense, segment_ids)
        return torch.cat([d_vec[:, None, :], v], dim=1).flatten(1)

    def interaction(self, x0: torch.Tensor) -> torch.Tensor:
        """The cross network over x0 (the ``interaction`` span)."""
        # pblint: disable=event-registry -- the registry is the JAX
        # package's, closed and equal in both, and has no interaction: the
        # port's DLRM-DCNv2 alone opens this span (pbt/interaction)
        with monitor.span("interaction"):
            return self.cross(x0, self.compute_dtype)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        x = self.interaction(self.interaction_input(pulled, mask, dense,
                                                    segment_ids))
        return self.top(x, compute_dtype=self.compute_dtype)[:, 0]
