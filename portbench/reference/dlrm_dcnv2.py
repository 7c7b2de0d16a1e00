"""DLRM-DCNv2 (MLPerf Training's recommendation benchmark,
mlcommons/training recommendation_v2/torchrec_dlrm: torchrec's
``DLRM_DCN`` with its ``LowRankCrossNet``), plain PyTorch, float32.

With E the embedding width and S the slots:

- the bottom net maps the dense floats to one E-wide vector d, ReLU
  after every layer;
- x0 = [d, e_1, ..., e_S] flat, (S+1)·E wide, e_s slot s's sum-pooled
  embedding;
- L low-rank cross layers, x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l,
  V_l (S+1)·E -> r without a bias, W_l r -> (S+1)·E with a bias b_l
  (parameters ``cross.<l>.v.w`` (in, r), ``cross.<l>.w.w`` (r, in),
  ``cross.<l>.w.b``; ``x @ w`` as the other families);
- the top net (ReLU between layers, one output) reads x_L.

Departures from the source: rows and dense weights come from the
benchmark's own draws (``ctr.make_params``: Glorot-normal kernels, zero
biases; ``ctr.init_rows``), not torchrec's initialisers; the pooled
first-order w, which the benchmark's row layout carries and the source
lacks, is taken and not read (it enters the logits times zero), so its
gradient is zero. The optimizers
and the cardinalities depart too: the configuration's ``assumed``.
"""

from __future__ import annotations

import torch

from portbench.reference.ctr import mlp, mm


def _dims(cfg: dict):
    s, d = cfg["num_sparse"], cfg["embedding_dim"]
    width = (s + 1) * d
    bottom = [cfg["num_dense"], *cfg["bottom_hidden"], d]
    top = [width, *cfg["top_hidden"], 1]
    return bottom, width, top


def param_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    bottom, width, top = _dims(cfg)
    r = cfg["dcn_low_rank_dim"]
    out = []
    for name, dims in (("bottom", bottom), ("top", top)):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out += [(f"{name}.{i}.w", (a, b)), (f"{name}.{i}.b", (b,))]
    for i in range(cfg["dcn_num_layers"]):
        out += [(f"cross.{i}.v.w", (width, r)), (f"cross.{i}.w.w", (r, width)),
                (f"cross.{i}.w.b", (width,))]
    return out


def forward(cfg: dict, p: dict, w: torch.Tensor, x: torch.Tensor,
            dense: torch.Tensor, precision: str) -> torch.Tensor:
    """w (B, S) (times zero), x (B, S, dim), dense (B, F) -> logits
    (B,)."""
    bottom, _, top = _dims(cfg)
    d_vec = mlp(p, "bottom", len(bottom) - 1, dense, precision,
                final_relu=True)
    x0 = torch.cat([d_vec[:, None, :], x], dim=1).flatten(1)
    xl = x0
    for i in range(cfg["dcn_num_layers"]):
        low = mm(xl, p[f"cross.{i}.v.w"], precision)
        xl = x0 * (mm(low, p[f"cross.{i}.w.w"], precision)
                   + p[f"cross.{i}.w.b"]) + xl
    logit = mlp(p, "top", len(top) - 1, xl, precision)[:, 0]
    # w is not read; ``ctr.train`` asks for its gradient, so it enters
    # times zero: the logits are unchanged and its gradient is zero
    return logit + 0.0 * w.sum(dim=1)
