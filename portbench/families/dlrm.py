"""DLRM (Naumov et al., 2019): the program's model and the model FLOPs
of one training example."""

from __future__ import annotations

from portbench.counts.flops import _mlp


def model(cfg: dict):
    from paddlebox_tpu_torch.models import DLRMModel
    return DLRMModel(cfg["num_sparse"], cfg["embedding_dim"],
                     cfg["num_dense"],
                     bottom_hidden=tuple(cfg["bottom_hidden"]),
                     top_hidden=tuple(cfg["top_hidden"]),
                     use_cvm=cfg["use_cvm"])


def train_flops_per_example(cfg: dict) -> float:
    """The bottom net over the dense floats (no input gradient), the
    (S+1) x (S+1) Gram matrix of [bottom output, slot embeddings] as one
    batched product (its backward two more), and the top net over
    [bottom output, the upper triangle, the slots' w column]."""
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    bottom = [cfg["num_dense"], *cfg["bottom_hidden"], d]
    n = s + 1
    top = [d + n * (n - 1) // 2 + s, *cfg["top_hidden"], 1]
    gram = 3.0 * 2.0 * n * n * d
    return (_mlp(bottom, first_needs_grad=False) + gram
            + _mlp(top, first_needs_grad=True))
