"""FTRL-proximal update step — the port of ``ops/ftrl.py``.

Same rule as the reference's ``ftrl_op`` (lr_power=-0.5):

    new_n = n + g^2
    sigma = (sqrt(new_n) - sqrt(n)) / alpha
    new_z = z + g - sigma * w
    new_w = -shrink(new_z, l1) / ((beta + sqrt(new_n)) / alpha + l2)

The square roots are taken in f64 and rounded back, which is the
correctly rounded f32 square root: the vectorised f32 ``torch.sqrt`` of
the CPU build is not always, and z's ``g - sigma * w`` cancels enough to
turn its last-place error into a visible one.
"""

from __future__ import annotations

import torch


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def ftrl_step(g, z, n, w, lr: float, l1: float, l2: float, beta: float):
    """Return (new_w, new_z, new_n); all tensors broadcast elementwise."""
    new_n = n + g * g
    sq_new = _sqrt(new_n)
    sigma = (sq_new - _sqrt(n)) / lr
    new_z = z + g - sigma * w
    shrink = torch.clamp(torch.abs(new_z) - l1, min=0.0)
    new_w = -torch.sign(new_z) * shrink / ((beta + sq_new) / lr + l2)
    return new_w, new_z, new_n
