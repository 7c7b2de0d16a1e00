"""DLRM-DCNv2 (MLPerf Training's recommendation benchmark: torchrec's
``DLRM_DCN``): the program's model and the model FLOPs of one training
example."""

from __future__ import annotations

from portbench.counts.flops import _mlp


def model(cfg: dict):
    from paddlebox_tpu_torch.models import DLRMDCNv2Model
    return DLRMDCNv2Model(cfg["num_sparse"], cfg["embedding_dim"],
                          cfg["num_dense"],
                          bottom_hidden=tuple(cfg["bottom_hidden"]),
                          top_hidden=tuple(cfg["top_hidden"]),
                          num_cross_layers=cfg["dcn_num_layers"],
                          low_rank_dim=cfg["dcn_low_rank_dim"],
                          use_cvm=cfg["use_cvm"])


def interaction_flops_per_example(cfg: dict) -> float:
    """The cross network: a layer's two products, V (d -> r) and W (r ->
    d), 2 d r FLOPs each forward; the backward computes both the
    weights' and the input's gradient (x0 is fed by the bottom net and
    the table), 6 x 2 d r a layer in all, d = (S+1) x E."""
    d = (cfg["num_sparse"] + 1) * cfg["embedding_dim"]
    return cfg["dcn_num_layers"] * 6.0 * 2.0 * d * cfg["dcn_low_rank_dim"]


def train_flops_per_example(cfg: dict) -> float:
    """The bottom net over the dense floats (no input gradient), the
    cross network, and the top net over its (S+1) x E output."""
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    bottom = [cfg["num_dense"], *cfg["bottom_hidden"], d]
    top = [(s + 1) * d, *cfg["top_hidden"], 1]
    return (_mlp(bottom, first_needs_grad=False)
            + interaction_flops_per_example(cfg)
            + _mlp(top, first_needs_grad=True))
