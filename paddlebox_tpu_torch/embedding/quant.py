"""Per-row quantization of f32 matrices — the host row codec of
``paddlebox_tpu/embedding/quant.py`` (``quantize_rows_np`` /
``dequantize_rows_np`` :73-92, with ``qdtype`` / ``qmax``).

Serving artifacts carry their cold rows' embedx planes through it
(``serving/artifact.py``): int8 or int16 codes with one f32 scale a
row, ``scale = max(|x|) / qmax`` floored at 1e-12, ``q = round(x /
scale)``. The arithmetic is the reference's, so the two packages write
bit-equal planes. The quantized device table (``QuantTable``,
``quantize_lanes``) is not ported yet (ROADMAP, queue 1 item 9).
"""

from __future__ import annotations

import numpy as np

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig

_QINFO = {"int8": (np.int8, 127.0), "int16": (np.int16, 32767.0)}


def qdtype(cfg: EmbeddingConfig):
    return _QINFO[cfg.storage][0]


def qmax(cfg: EmbeddingConfig) -> float:
    return _QINFO[cfg.storage][1]


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
