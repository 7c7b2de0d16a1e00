"""DLRM (Naumov et al., 2019; facebookresearch/dlrm's dot interaction),
plain PyTorch, float32.

The bottom net maps the dense floats to one embedding-wide vector
(ReLU after every layer); the interaction is the upper triangle,
diagonal left out, of the Gram matrix of [that vector, the slots'
embeddings]; the top net (ReLU between layers, one output) reads [the
bottom vector, the interaction]. As the program does, the top net's
input also carries each slot's first-order weight w, which the published
model lacks.
"""

from __future__ import annotations

import torch

from portbench.reference.ctr import mlp


def _dims(cfg: dict):
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    n = s + 1
    bottom = [cfg["num_dense"], *cfg["bottom_hidden"], d]
    top = [d + n * (n - 1) // 2 + s, *cfg["top_hidden"], 1]
    return bottom, top


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    out = []
    for name, dims in zip(("bottom", "top"), _dims(cfg)):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out += [(f"{name}.{i}.w", (a, b)), (f"{name}.{i}.b", (b,))]
    return out


def forward(cfg: dict, p: dict, w: torch.Tensor, x: torch.Tensor,
            dense: torch.Tensor, precision: str) -> torch.Tensor:
    """w (B, S), x (B, S, dim), dense (B, F) -> logits (B,)."""
    bottom, top = _dims(cfg)
    d_vec = mlp(p, "bottom", len(bottom) - 1, dense, precision,
                final_relu=True)
    allv = torch.cat([d_vec[:, None, :], x], dim=1)
    n = allv.shape[1]
    a = allv.bfloat16() if precision == "bfloat16" else allv
    gram = torch.bmm(a, a.transpose(1, 2)).float()
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    inter = gram[:, iu[0], iu[1]]
    return mlp(p, "top", len(top) - 1,
               torch.cat([d_vec, inter, w], dim=1), precision)[:, 0]
