"""Quantized device storage — the port of ``paddlebox_tpu/embedding/
quant.py``.

With ``EmbeddingConfig(storage="int8" | "int16")`` the pass working set
on the device is a two-plane ``QuantTable``:

    fp : f32 (N, fixed_cols + n_opt_slots + 1)   show, clk, the w block,
                                                 optimizer state and the
                                                 row's dequant scale
    qx : int8|int16 (N, total_dim)               quantized embedx

Compute stays f32: a lookup dequantizes at the gather (``x = qx *
scale``), and a push rebuilds the touched rows in f32, applies the
optimizer exactly as an f32 table does, and requantizes them with a
fresh per-row scale (``embedding/sharded.py``). The HOST store stays f32
under every storage, so checkpoints and serving artifacts are full
precision and the storage may change between runs.

The row codec is the reference's: ``scale = max(|x|) / qmax`` floored at
1e-12, ``q = round(x / scale)`` with ties to even (``np.round``,
``torch.round`` and ``jnp.round`` all round so), in that order, so the
two packages write bit-equal planes. Serving artifacts carry their cold
rows' embedx planes through the same host codec (``serving/artifact.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig

_QINFO = {"int8": (np.int8, 127.0), "int16": (np.int16, 32767.0)}
_TORCH_QDTYPE = {"int8": torch.int8, "int16": torch.int16}


class QuantTable(NamedTuple):
    """The quantized working-set table: both planes on one device."""
    fp: torch.Tensor    # f32 (N, fixed + n_opt + 1): show, clk, w*, opt, scale
    qx: torch.Tensor    # int8/int16 (N, total_dim)


def is_quant(table) -> bool:
    return isinstance(table, QuantTable)


def table_rows(table) -> int:
    return int(table.fp.shape[0] if is_quant(table) else table.shape[0])


def qdtype(cfg: EmbeddingConfig):
    return _QINFO[cfg.storage][0]


def qmax(cfg: EmbeddingConfig) -> float:
    return _QINFO[cfg.storage][1]


def fp_width(cfg: EmbeddingConfig) -> int:
    return cfg.fixed_cols + cfg.n_opt_slots + 1


# ---------------------------------------------------------------------------
# per-row quantization of an f32 matrix: host and device forms of one rule
# ---------------------------------------------------------------------------

def quantize_rows_np(x: np.ndarray, storage: str
                     ) -> tuple[np.ndarray, np.ndarray]:
    """f32 (N, D) → (q int8/int16 (N, D), scale f32 (N,)) with per-row
    dynamic scaling. D == 0 gives empty codes and the floor scale."""
    dt, qm = _QINFO[storage]
    x = np.asarray(x, np.float32)
    scale = (np.abs(x).max(axis=1) / qm if x.shape[1]
             else np.zeros(len(x), np.float32))
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.round(x / scale[:, None]).astype(dt)
    return q, scale


def dequantize_rows_np(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(q, scale) planes → f32 rows (quantize_rows_np's inverse, up to
    its rounding)."""
    return q.astype(np.float32) * np.asarray(scale, np.float32)[:, None]


def quantize_lanes(x: torch.Tensor, storage: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """quantize_rows_np on tensors over the LAST axis: (..., D) f32 →
    (q int8/int16 (..., D), scale f32 (...,)). D must be > 0."""
    qm = _QINFO[storage][1]
    scale = torch.clamp_min(x.abs().amax(dim=-1) / qm, 1e-12)
    q = torch.round(x / scale[..., None]).to(_TORCH_QDTYPE[storage])
    return q, scale


def dequantize_lanes(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """quantize_lanes's inverse (up to its rounding)."""
    return q.to(torch.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# planes <-> full f32 rows
# ---------------------------------------------------------------------------

def encode_rows_np(rows: np.ndarray, cfg: EmbeddingConfig
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Host f32 rows → (fp, qx) planes."""
    qx, scale = quantize_rows_np(rows[:, cfg.embedx_cols], cfg.storage)
    fp = np.concatenate(
        [rows[:, :cfg.fixed_cols], rows[:, cfg.opt_cols], scale[:, None]],
        axis=1).astype(np.float32)
    return fp, qx


def decode_rows_np(fp: np.ndarray, qx: np.ndarray,
                   cfg: EmbeddingConfig) -> np.ndarray:
    """Host (fp, qx) planes → f32 rows."""
    fc = cfg.fixed_cols
    rows = np.empty((len(fp), cfg.row_width), np.float32)
    rows[:, :fc] = fp[:, :fc]
    rows[:, cfg.embedx_cols] = qx.astype(np.float32) * fp[:, -1:]
    rows[:, cfg.opt_cols] = fp[:, fc:fc + cfg.n_opt_slots]
    return rows


def assemble_rows(fp: torch.Tensor, qx: torch.Tensor,
                  cfg: EmbeddingConfig) -> torch.Tensor:
    """Device planes → full f32 rows."""
    fc = cfg.fixed_cols
    x = qx.to(torch.float32) * fp[:, -1:]
    return torch.cat([fp[:, :fc], x, fp[:, fc:fc + cfg.n_opt_slots]], dim=1)


def split_rows(rows: torch.Tensor, cfg: EmbeddingConfig) -> QuantTable:
    """Full f32 rows → requantized planes (a fresh per-row scale):
    ``max(|x|) / qmax``, then the 1e-12 floor, then ``round(x / scale)``,
    the reference's order. A row of no embedx gets the floor scale."""
    x = rows[:, cfg.embedx_cols]
    if cfg.total_dim:
        scale = torch.clamp_min(x.abs().amax(dim=1) / qmax(cfg), 1e-12)
    else:
        scale = rows.new_full((rows.shape[0],), 1e-12)
    qx = torch.round(x / scale[:, None]).to(_TORCH_QDTYPE[cfg.storage])
    fp = torch.cat([rows[:, :cfg.fixed_cols], rows[:, cfg.opt_cols],
                    scale[:, None]], dim=1)
    return QuantTable(fp=fp, qx=qx)


def device_table(host_rows: np.ndarray, cfg: EmbeddingConfig,
                 device: torch.device):
    """The device table for f32 ``host_rows`` under cfg.storage."""
    if cfg.storage == "f32":
        return torch.from_numpy(np.ascontiguousarray(host_rows)).to(device)
    fp, qx = encode_rows_np(host_rows, cfg)
    return QuantTable(fp=torch.from_numpy(fp).to(device),
                      qx=torch.from_numpy(qx).to(device))
