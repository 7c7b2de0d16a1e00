"""Fused concat — the port of ``ops/fused_concat.py``: concatenate
column ranges of many inputs (``offset`` / ``length``)."""

from __future__ import annotations

from typing import Sequence

import torch


def fused_concat(xs: Sequence[torch.Tensor], offset: int = 0,
                 length: int = -1, axis: int = -1) -> torch.Tensor:
    """Concatenate [x[..., offset:offset+length] for x in xs] along
    ``axis``."""
    if length >= 0:
        xs = [x[..., offset:offset + length] for x in xs]
    elif offset:
        xs = [x[..., offset:] for x in xs]
    return torch.cat(list(xs), dim=axis)
