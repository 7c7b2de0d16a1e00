"""Dense building blocks — the port of ``models/nn.py``.

Weights keep the JAX package's layout, ``w`` (in, out) and ``b`` (out,),
and apply as ``x @ w + b``, so parameters carry across unchanged
(``weights.py``). Products are plain ``torch.matmul``, in f32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Glorot-normal weights, zero bias."""
        in_dim, out_dim = self.w.shape
        std = (2.0 / (in_dim + out_dim)) ** 0.5
        self.w.copy_(torch.randn(in_dim, out_dim, generator=generator) * std)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLP(nn.Module):
    """Dense layers with ReLU between them, none after the last."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1]) for i in range(len(dims) - 1))

    def init(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
