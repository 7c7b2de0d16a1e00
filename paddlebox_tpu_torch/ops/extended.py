"""Extended (expand) embedding pull — the port of ``ops/extended.py``
(pull_box_extended_sparse): one lookup returns the base embedding and an
expand embedding of a second width, both stored in the same row. The
row already carries dim + expand_dim trained columns
(``EmbeddingConfig.total_dim``); this op is the view split after the
lookup.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig


def pull_box_extended_sparse(pulled: torch.Tensor, cfg: EmbeddingConfig
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """pulled (..., pull_width) → (base, expand (..., expand_dim)).

    Base keeps the [show, clk, w-block, embedx] layout every downstream
    op expects; expand is the trailing expand_dim columns."""
    if cfg.expand_dim == 0:
        raise ValueError("pull_box_extended_sparse needs expand_dim > 0")
    split = cfg.fixed_cols + cfg.dim
    return pulled[..., :split], pulled[..., split:]
