"""Dense optimizers — the port of ``train/optimizers.py`` (adam, sgd).

The JAX package builds them with optax, so these follow optax's
formulas, not ``torch.optim``'s:

adam (optax.adam, eps_root = 0):
    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g² + b2 nu;  t += 1
    p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
sgd (optax.sgd):
    p += -lr * g

``state_leaves`` / ``load_state_leaves`` expose each optimizer's state
in optax's order, which ``weights.py`` lays out as optax's state tree:
adam ``(ScaleByAdamState(count, mu, nu), EmptyState())``, sgd
``(EmptyState(), EmptyState())`` (no leaves).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class Adam:
    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        self.count += 1
        # optax's bias corrections: 1 - decay**count in f32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.lr * upd)

    def state_leaves(self) -> dict:
        """{"count": int, "mu": [tensor], "nu": [tensor]}, the moments
        aligned with ``params``."""
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_leaves(self, count, mu, nu) -> None:
        self.count = int(count)
        for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
            dst.copy_(torch.as_tensor(np.asarray(src, np.float32)))


class Sgd:
    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.params = list(params)
        self.lr = lr

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g in zip(self.params, grads):
            p.add_(-self.lr * g)

    def state_leaves(self) -> None:
        return None

    def load_state_leaves(self) -> None:
        pass


def make(name: str, lr: float, params: Sequence[torch.Tensor]):
    """Build a dense optimizer by name over ``params``."""
    if name == "adam":
        return Adam(params, lr)
    if name == "sgd":
        return Sgd(params, lr)
    raise ValueError(f"dense optimizer {name!r} is not ported yet; "
                     f"expected adam|sgd")
