"""FTRL-proximal update step — the port of ``ops/ftrl.py``.

Same rule as the reference's ``ftrl_op`` (lr_power=-0.5):

    new_n = n + g^2
    sigma = (sqrt(new_n) - sqrt(n)) / alpha
    new_z = z + g - sigma * w
    new_w = -shrink(new_z, l1) / ((beta + sqrt(new_n)) / alpha + l2)
"""

from __future__ import annotations

import torch


def ftrl_step(g, z, n, w, lr: float, l1: float, l2: float, beta: float):
    """Return (new_w, new_z, new_n); all tensors broadcast elementwise."""
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * w
    shrink = torch.clamp(torch.abs(new_z) - l1, min=0.0)
    new_w = -torch.sign(new_z) * shrink / ((beta + torch.sqrt(new_n)) / lr
                                           + l2)
    return new_w, new_z, new_n
