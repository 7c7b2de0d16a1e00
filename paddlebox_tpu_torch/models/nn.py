"""Dense building blocks — the port of ``models/nn.py``.

Weights keep the JAX package's layout, ``w`` (in, out) and ``b`` (out,),
and apply as ``x @ w + b``; an ``MLP`` is a list of them, so a parameter
is named by its JAX path with dots (``mlp.0.w`` for ``mlp/0/w``) and
carries across unchanged (``weights.py``).

``compute_dtype`` follows ``dense_apply``: x and w are cast to it for
the product, whose result is cast to f32 before the bias is added. With
bf16 that is an explicit cast, not autocast; in f32 the products are
plain ``torch.matmul`` (the trainer turns TF32 off).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def matmul(x: torch.Tensor, w: torch.Tensor,
           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w`` in ``compute_dtype``, returned as f32."""
    if compute_dtype == torch.float32:
        return x @ w
    return (x.to(compute_dtype) @ w.to(compute_dtype)).float()


def activate(y: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "tanh":
        return torch.tanh(y)
    if activation is not None:
        raise ValueError(activation)
    return y


class Dense(nn.Module):
    """``x @ w + b``; with ``bias=False`` a plain projection, ``x @ w``
    (no ``b`` parameter)."""

    def __init__(self, in_dim: int, out_dim: int, scale: str = "glorot",
                 bias: bool = True):
        super().__init__()
        self.scale = scale
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim)) if bias else None

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """``dense_init``: normal weights with glorot std (or 0.01 for
        any other ``scale``), zero bias."""
        in_dim, out_dim = self.w.shape
        std = ((2.0 / (in_dim + out_dim)) ** 0.5 if self.scale == "glorot"
               else 0.01)
        self.w.copy_(torch.randn(in_dim, out_dim, generator=generator) * std)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor, activation: str | None = None,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        y = matmul(x, self.w, compute_dtype)
        return activate(y if self.b is None else y + self.b, activation)


class MLP(nn.ModuleList):
    """Dense layers with ReLU between them and ``final_activation`` (none
    by default) after the last."""

    def __init__(self, dims: Sequence[int]):
        super().__init__(Dense(dims[i], dims[i + 1])
                         for i in range(len(dims) - 1))

    @property
    def layers(self) -> "MLP":
        """The Dense layers in order (the MLP is their list)."""
        return self

    def init(self, generator: torch.Generator) -> None:
        for layer in self:
            layer.init(generator)

    def forward(self, x: torch.Tensor, final_activation: str | None = None,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        for i, layer in enumerate(self):
            act = final_activation if i == len(self) - 1 else "relu"
            x = layer(x, act, compute_dtype)
        return x
