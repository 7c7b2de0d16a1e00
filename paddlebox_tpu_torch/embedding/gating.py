"""Variable/NNCross presence gating — the port of ``embedding/gating.py``.

A key's embedx (and expand) plane exists only once its show count reaches
the plane's create threshold: absent planes pull as zeros and take no
grads. Pulls gate on the row's current show; the push gate passes the
post-increment show (a key crossing the threshold this step trains at
once).

``GateSpec`` carries the four numbers gating needs, so the serving
table, which has no EmbeddingConfig after a load, gates its host
lookups (``gate_pull_np``) with the same arithmetic as the device pull.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig


class GateSpec(NamedTuple):
    """The four numbers gating needs (reference ``gating.py:25-57``)."""
    fixed_cols: int
    dim: int
    mf_create_threshold: float
    expand_create_threshold: float

    @classmethod
    def from_cfg(cls, cfg: EmbeddingConfig) -> "GateSpec":
        return cls(cfg.fixed_cols, cfg.dim, cfg.mf_create_threshold,
                   cfg.expand_create_threshold)


def needs_gating(cfg: EmbeddingConfig | GateSpec) -> bool:
    return cfg.mf_create_threshold > 0 or cfg.expand_create_threshold > 0


def gate_planes(mf: torch.Tensor, ex: torch.Tensor, show: torch.Tensor,
                cfg: EmbeddingConfig | GateSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask the embedx (..., dim) / expand (..., expand_dim) planes by
    their create thresholds; ``show`` broadcasts as (..., 1)."""
    if cfg.mf_create_threshold > 0:
        mf = torch.where(show >= cfg.mf_create_threshold, mf,
                         torch.zeros((), dtype=mf.dtype, device=mf.device))
    if cfg.expand_create_threshold > 0:
        ex = torch.where(show >= cfg.expand_create_threshold, ex,
                         torch.zeros((), dtype=ex.dtype, device=ex.device))
    return mf, ex


def gate_pull(pulled: torch.Tensor, cfg: EmbeddingConfig | GateSpec
              ) -> torch.Tensor:
    """Gate a pull-layout block (..., pull_width); no-op at thresholds 0."""
    if not needs_gating(cfg):
        return pulled
    fc = cfg.fixed_cols
    mf, ex = gate_planes(pulled[..., fc:fc + cfg.dim],
                         pulled[..., fc + cfg.dim:],
                         pulled[..., 0:1], cfg)
    return torch.cat([pulled[..., :fc], mf, ex], dim=-1)


def gate_pull_np(pulled: np.ndarray, cfg: EmbeddingConfig | GateSpec
                 ) -> np.ndarray:
    """``gate_pull`` on a host block (..., pull_width), through the same
    function as the device pull (the reference's ``gate_pull_xp(..., np)``)."""
    return gate_pull(torch.from_numpy(pulled), cfg).numpy()
