"""DeepFM (Guo et al., IJCAI 2017, section 2.1), plain PyTorch, float32.

logit = the FM's first order (the sum of every slot's scalar weight w,
plus a linear term of the dense floats) + its second order (the pairwise
inner products of the slots' embeddings, 0.5 * ((sum v)^2 - sum v^2)
summed over the embedding) + the deep net over every slot's [w,
embedding] and the dense floats (ReLU, one output) + a bias. As the
paper shares each field's embedding between the FM and the deep part,
so does this; it feeds w to the deep net too and has no dropout, as the
program does.
"""

from __future__ import annotations

import torch

from portbench.reference.ctr import mlp, mm


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    s, d, f = cfg["num_sparse"], cfg["embedding_dim"], cfg["num_dense"]
    dims = [s * (1 + d) + f, *cfg["hidden"], 1]
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"mlp.{i}.w", (a, b)), (f"mlp.{i}.b", (b,))]
    return out + [("bias", (1,)), ("wide_dense", (f,))]


def forward(cfg: dict, p: dict, w: torch.Tensor, x: torch.Tensor,
            dense: torch.Tensor, precision: str) -> torch.Tensor:
    """w (B, S), x (B, S, dim), dense (B, F) -> logits (B,)."""
    first = w.sum(dim=1) + mm(dense, p["wide_dense"][:, None],
                              precision)[:, 0]
    sum_v = x.sum(dim=1)
    second = 0.5 * (sum_v * sum_v - (x * x).sum(dim=1)).sum(dim=1)
    feats = torch.cat([w[..., None], x], dim=2).reshape(w.shape[0], -1)
    deep = mlp(p, "mlp", len(cfg["hidden"]) + 1,
               torch.cat([feats, dense], dim=1), precision)[:, 0]
    return first + second + deep + p["bias"][0]
