"""Batch FC — the port of ``ops/batch_fc.py``: per-group fully connected
layers in one grouped product (``torch.bmm``), as the reference's
``batch_fc`` op runs ``slot_pairs_num`` independent FCs.
"""

from __future__ import annotations

import torch


def batch_fc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
             activation: str | None = None) -> torch.Tensor:
    """x (G, N, I) @ w (G, I, O) [+ b (G, O)] → (G, N, O)."""
    out = torch.bmm(x, w)
    if b is not None:
        out = out + b[:, None, :]
    if activation == "relu":
        out = torch.relu(out)
    elif activation is not None:
        raise ValueError(f"unsupported activation {activation!r}")
    return out
