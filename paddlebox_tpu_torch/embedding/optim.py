"""In-table sparse optimizers — the port of ``embedding/optim.py``.

The optimizer applies inside the table at push time, with a handful of
per-feature scalar state columns per row (see ``embedding/config.py`` for
the row layout). ``apply_updates`` is the plain PyTorch statement of the
math that ``csrc/apply_updates.cuh`` runs inside both push kernels; the
two must agree (the kernel tests hold one against the other).

- ShareEmbedding (``embed_w_num > 1``): the scalar w becomes a w block
  whose per-feature accumulator aggregates over the block.
- Variable/NNCross (create thresholds): grads to a plane that does not
  exist yet for a key (post-increment show below the threshold) are
  dropped.
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.embedding import gating
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.ops.ftrl import ftrl_step


def _gate_grads(g_x: torch.Tensor, show: torch.Tensor,
                cfg: EmbeddingConfig) -> torch.Tensor:
    """Zero embedx/expand grads of keys whose plane is not yet created
    (``show`` is the post-increment count)."""
    gx_mf, gx_ex = gating.gate_planes(g_x[:, :cfg.dim], g_x[:, cfg.dim:],
                                      show[:, None], cfg)
    return torch.cat([gx_mf, gx_ex], dim=1)


def _g2_ratio(g0: float, acc: torch.Tensor) -> torch.Tensor:
    """g0 / (g0 + acc) as one f32 division. (``float / tensor`` in torch
    is reciprocal-then-multiply, two roundings.)"""
    g0t = acc.new_tensor(g0)
    return g0t / (g0t + acc)


def apply_updates(rows: torch.Tensor, grads: torch.Tensor,
                  show_inc: torch.Tensor, clk_inc: torch.Tensor,
                  cfg: EmbeddingConfig) -> torch.Tensor:
    """Apply one sparse update to a block of rows; returns new rows.

    rows     : (n, W) current rows, W >= row_width (pad columns pass
               through unchanged)
    grads    : (n, grad_width) summed d_w-block, d_embedx per row
    show/clk : (n,) impression / click count increments
    """
    d = cfg.total_dim
    nw = cfg.embed_w_num
    ob = cfg.fixed_cols + d                  # first optimizer-state column
    show = rows[:, 0] + show_inc
    clk = rows[:, 1] + clk_inc
    w = rows[:, cfg.w_cols]
    x = rows[:, cfg.embedx_cols]
    g_w = grads[:, :nw]
    g_x = grads[:, nw:]
    if gating.needs_gating(cfg):
        g_x = _gate_grads(g_x, show, cfg)
    lr = cfg.learning_rate
    zero = torch.zeros_like(show)

    mean_gw = torch.mean(g_w, dim=1)
    mean_gw2 = torch.mean(g_w * g_w, dim=1)

    if cfg.optimizer == "sgd":
        new_w = w - lr * g_w
        new_x = x - lr * g_x
        opt = rows[:, cfg.opt_cols]
    elif cfg.optimizer == "adagrad":
        w_g2, x_g2 = rows[:, ob], rows[:, ob + 1]
        new_wg2 = w_g2 + mean_gw2
        mean_gx2 = torch.mean(g_x * g_x, dim=1) if d else zero
        new_xg2 = x_g2 + mean_gx2
        scale_w = lr * torch.sqrt(_g2_ratio(cfg.initial_g2sum, new_wg2))
        scale_x = lr * torch.sqrt(_g2_ratio(cfg.initial_g2sum, new_xg2))
        new_w = w - scale_w[:, None] * g_w
        new_x = x - scale_x[:, None] * g_x
        opt = torch.stack([new_wg2, new_xg2], dim=1)
    elif cfg.optimizer == "adam":
        b1, b2 = cfg.beta1, cfg.beta2
        w_m, w_v = rows[:, ob], rows[:, ob + 1]
        x_m, x_v = rows[:, ob + 2], rows[:, ob + 3]
        mean_gx = torch.mean(g_x, dim=1) if d else zero
        mean_gx2 = torch.mean(g_x * g_x, dim=1) if d else zero
        nw_m = b1 * w_m + (1 - b1) * mean_gw
        nw_v = b2 * w_v + (1 - b2) * mean_gw2
        nx_m = b1 * x_m + (1 - b1) * mean_gx
        nx_v = b2 * x_v + (1 - b2) * mean_gx2
        eps = 1e-8
        # nw == 1 keeps the scalar-w direction (nw_m); a w block blends a
        # per-element direction like embedx below
        if nw == 1:
            w_dir = nw_m[:, None]
        else:
            w_dir = b1 * nw_m[:, None] + (1 - b1) * g_w
        new_w = w - lr * w_dir / (torch.sqrt(nw_v)[:, None] + eps)
        new_x = x - lr * (b1 * nx_m[:, None] + (1 - b1) * g_x) / (
            torch.sqrt(nx_v)[:, None] + eps)
        opt = torch.stack([nw_m, nw_v, nx_m, nx_v], dim=1)
    elif cfg.optimizer == "ftrl":
        # FTRL-proximal on the scalar w, adagrad on embedx (config forbids
        # embed_w_num > 1 here)
        z, n = rows[:, ob], rows[:, ob + 1]
        new_w1, new_z, new_n = ftrl_step(
            g_w[:, 0], z, n, w[:, 0], lr, cfg.ftrl_l1, cfg.ftrl_l2,
            cfg.ftrl_beta)
        new_w = new_w1[:, None]
        x_g2 = rows[:, ob + 2]
        mean_gx2 = torch.mean(g_x * g_x, dim=1) if d else zero
        new_xg2 = x_g2 + mean_gx2
        scale_x = lr * torch.sqrt(_g2_ratio(cfg.initial_g2sum, new_xg2))
        new_x = x - scale_x[:, None] * g_x
        opt = torch.stack([new_z, new_n, new_xg2], dim=1)
    else:  # pragma: no cover - config validates
        raise ValueError(cfg.optimizer)

    out = torch.cat([show[:, None], clk[:, None], new_w, new_x, opt], dim=1)
    if rows.shape[1] > out.shape[1]:
        out = torch.cat([out, rows[:, out.shape[1]:]], dim=1)
    return out
