"""DeepFM (Guo et al., IJCAI 2017): the program's model and the model
FLOPs of one training example."""

from __future__ import annotations

from portbench.counts.flops import _mlp


def model(cfg: dict):
    from paddlebox_tpu_torch.models import DeepFMModel
    return DeepFMModel(cfg["num_sparse"], cfg["embedding_dim"],
                       cfg["num_dense"], hidden=tuple(cfg["hidden"]),
                       use_cvm=cfg["use_cvm"])


def train_flops_per_example(cfg: dict) -> float:
    """The deep net over [w, embedding] of every slot and the dense
    floats; its input carries the pulled rows, so its first layer takes
    an input gradient too."""
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    dims = [s * (1 + d) + cfg["num_dense"], *cfg["hidden"], 1]
    return _mlp(dims, first_needs_grad=True)
