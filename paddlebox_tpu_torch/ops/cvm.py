"""Standalone CVM op — the port of ``ops/cvm.py``.

Given rows whose leading two columns are show/click, either apply the log
transform (use_cvm=True) or strip the two columns (use_cvm=False).
"""

from __future__ import annotations

import torch


def cvm(x: torch.Tensor, use_cvm: bool = True) -> torch.Tensor:
    """x (..., D) with x[..., 0] = show, x[..., 1] = click."""
    if not use_cvm:
        return x[..., 2:]
    log_show = torch.log(x[..., 0:1] + 1.0)
    log_ctr = torch.log(x[..., 1:2] + 1.0) - log_show
    return torch.cat([log_show, log_ctr, x[..., 2:]], dim=-1)
