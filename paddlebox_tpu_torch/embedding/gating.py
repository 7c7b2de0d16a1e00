"""Variable/NNCross presence gating — the port of ``embedding/gating.py``.

A key's embedx (and expand) plane exists only once its show count reaches
the plane's create threshold: absent planes pull as zeros and take no
grads. Pulls gate on the row's current show; the push gate passes the
post-increment show (a key crossing the threshold this step trains at
once).
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig


def needs_gating(cfg: EmbeddingConfig) -> bool:
    return cfg.mf_create_threshold > 0 or cfg.expand_create_threshold > 0


def gate_planes(mf: torch.Tensor, ex: torch.Tensor, show: torch.Tensor,
                cfg: EmbeddingConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask the embedx (..., dim) / expand (..., expand_dim) planes by
    their create thresholds; ``show`` broadcasts as (..., 1)."""
    if cfg.mf_create_threshold > 0:
        mf = torch.where(show >= cfg.mf_create_threshold, mf,
                         torch.zeros((), dtype=mf.dtype, device=mf.device))
    if cfg.expand_create_threshold > 0:
        ex = torch.where(show >= cfg.expand_create_threshold, ex,
                         torch.zeros((), dtype=ex.dtype, device=ex.device))
    return mf, ex


def gate_pull(pulled: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Gate a pull-layout block (..., pull_width); no-op at thresholds 0."""
    if not needs_gating(cfg):
        return pulled
    fc = cfg.fixed_cols
    mf, ex = gate_planes(pulled[..., fc:fc + cfg.dim],
                         pulled[..., fc + cfg.dim:],
                         pulled[..., 0:1], cfg)
    return torch.cat([pulled[..., :fc], mf, ex], dim=-1)
