"""MMoE — the port of ``models/mmoe.py``: multi-gate mixture of experts.
Every expert (an MLP) runs on every example; each task mixes the experts
with its own softmax gate and scores the mixture with its own tower.

``forward`` returns the primary task's logits (what the trainer
trains); ``apply_tasks`` returns all of them, (B, num_tasks).
"""

from __future__ import annotations

import torch
from torch import nn

from paddlebox_tpu_torch.models.nn import MLP, Dense, matmul
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm


class MMoEModel(nn.Module):
    name = "mmoe"
    # pulled is consumed only through fused_seqpool_cvm, so the trainer
    # may substitute the fused gather-pool pull (PooledSlots)
    pooled_pull_ok = True

    def __init__(self, num_slots: int, emb_dim: int, dense_dim: int = 0,
                 num_experts: int = 4, num_tasks: int = 2,
                 expert_hidden: tuple[int, ...] = (64,),
                 expert_out: int = 32,
                 tower_hidden: tuple[int, ...] = (32,),
                 use_cvm: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_slots = num_slots
        self.emb_dim = emb_dim
        self.dense_dim = dense_dim
        self.num_experts = num_experts
        self.num_tasks = num_tasks
        self.expert_hidden = tuple(expert_hidden)
        self.expert_out = expert_out
        self.tower_hidden = tuple(tower_hidden)
        self.use_cvm = use_cvm
        self.compute_dtype = compute_dtype
        slot_feat = (3 + emb_dim) if use_cvm else (1 + emb_dim)
        self.in_dim = num_slots * slot_feat + dense_dim
        self.expert_dims = (self.in_dim, *expert_hidden, expert_out)
        self.tower_dims = (expert_out, *tower_hidden, 1)
        self.experts = nn.ModuleList(MLP(self.expert_dims)
                                     for _ in range(num_experts))
        self.gates = nn.ModuleList(Dense(self.in_dim, num_experts)
                                   for _ in range(num_tasks))
        self.towers = nn.ModuleList(MLP(self.tower_dims)
                                    for _ in range(num_tasks))

    def init(self, generator: torch.Generator) -> None:
        for m in (*self.experts, *self.gates, *self.towers):
            m.init(generator)

    def apply_tasks(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                      segment_ids, num_slots: int | None = None
                      ) -> torch.Tensor:
        cd = self.compute_dtype
        feats = fused_seqpool_cvm(pulled, mask, segment_ids, self.num_slots,
                                  use_cvm=self.use_cvm)
        x = torch.cat([feats, dense], dim=1) if self.dense_dim else feats
        expert_out = torch.stack(
            [e(x, final_activation="relu", compute_dtype=cd)
             for e in self.experts], dim=1)              # (B, E, O)
        logits = []
        for gate, tower in zip(self.gates, self.towers):
            g = torch.softmax(matmul(x, gate.w, cd) + gate.b, dim=-1)
            mixed = torch.einsum("be,beo->bo", g, expert_out)
            logits.append(tower(mixed, compute_dtype=cd)[:, 0])
        return torch.stack(logits, dim=1)                # (B, T)

    def forward(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                segment_ids, num_slots: int | None = None) -> torch.Tensor:
        return self.apply_tasks(pulled, mask, dense, segment_ids,
                                  num_slots)[:, 0]
