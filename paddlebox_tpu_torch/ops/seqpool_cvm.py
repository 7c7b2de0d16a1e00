"""Fused sequence-pool + CVM transform — the port of
``ops/seqpool_cvm.py::fused_seqpool_cvm``.

For every sparse slot, sum-pool the slot's pulled rows per example, then
apply the CVM (click-value-model) transform to the leading show/click
columns:

- use_cvm=True: out[0] = log(show+1); out[1] = log(click+1) - log(show+1);
  the rest unchanged;
- use_cvm=False: drop the cvm_offset leading columns.

Optional per-token filters run before pooling: need_filter drops tokens
with (show-click)*show_coeff + click*clk_coeff < threshold (scalar or
per slot); embed_threshold drops tokens whose |embed_w| < embed_threshold
once show > embed_threshold; quant_ratio rounds the embedx values.

``PooledSlots`` marks input that is already pooled per (example, slot) —
the output of the fused gather-pool pull — for which only the post-pool
CVM transform applies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paddlebox_tpu_torch.ops.cvm import cvm


@dataclasses.dataclass
class PooledSlots:
    """(B, S, P) per-slot sums that are already pooled."""
    pooled: torch.Tensor

    @property
    def shape(self):
        return self.pooled.shape


def _filter_and_quant(pulled, mask, seg_np, cvm_offset, need_filter,
                      show_coeff, clk_coeff, threshold, embed_threshold,
                      quant_ratio):
    """Per-token filter + quantization; cvm_offset is embed_w's column."""
    keep = mask
    if need_filter:
        show, clk = pulled[..., 0], pulled[..., 1]
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=pulled.device)
        if thr.ndim == 1:
            thr = thr[torch.as_tensor(seg_np, device=pulled.device)]
        keep = keep & ((show - clk) * show_coeff + clk * clk_coeff >= thr)
    if embed_threshold > 0.0:
        show, w = pulled[..., 0], pulled[..., cvm_offset]
        keep = keep & ~((show > embed_threshold)
                        & (torch.abs(w) < embed_threshold))
    x = pulled
    if quant_ratio > 0:
        q = torch.round(x[..., cvm_offset + 1:] * quant_ratio) / quant_ratio
        x = torch.cat([x[..., :cvm_offset + 1], q], dim=-1)
    return x * keep[..., None].to(x.dtype)


def _pool(x, seg_np, num_slots):
    """Sum-pool tokens into slots: a reshape + sum when every slot owns an
    equal contiguous run of tokens, else a one-hot (T, S) product."""
    B, T, P = x.shape
    uniform = (num_slots > 0 and T % num_slots == 0
               and np.array_equal(
                   seg_np, np.repeat(np.arange(num_slots), T // num_slots)))
    if uniform:
        return x.reshape(B, num_slots, T // num_slots, P).sum(dim=2)
    pool_mat = torch.as_tensor(np.eye(num_slots, dtype=np.float32)[seg_np],
                               device=x.device)
    return torch.einsum("btp,ts->bsp", x, pool_mat)


def fused_seqpool_cvm(pulled, mask: torch.Tensor, segment_ids,
                      num_slots: int, use_cvm: bool = True,
                      cvm_offset: int = 2, need_filter: bool = False,
                      show_coeff: float = 0.2, clk_coeff: float = 1.0,
                      threshold=0.96, embed_threshold: float = 0.0,
                      quant_ratio: int = 0,
                      flatten: bool = True) -> torch.Tensor:
    """pulled (B, T, P) × mask (B, T) → pooled+CVM features, (B, S*out)
    if flatten else (B, S, out), out = P if use_cvm else P - cvm_offset.

    ``pulled`` may be a PooledSlots (the fused gather-pool pull): the
    per-token filter/pool stages are then already done, and per-token
    filters must stay at their defaults."""
    if isinstance(pulled, PooledSlots):
        if need_filter or embed_threshold > 0.0 or quant_ratio > 0:
            raise ValueError(
                "per-token filters/quant cannot apply to a PooledSlots "
                "input; pass them to the fused gather-pool pull "
                "(ops.kernels.gather_pool) instead")
        pooled = pulled.pooled
    else:
        seg_np = np.asarray(segment_ids, dtype=np.int64)
        x = _filter_and_quant(pulled, mask, seg_np, cvm_offset, need_filter,
                              show_coeff, clk_coeff, threshold,
                              embed_threshold, quant_ratio)
        pooled = _pool(x, seg_np, num_slots)
    if use_cvm:
        out = torch.cat([cvm(pooled[..., :2]), pooled[..., cvm_offset:]],
                        dim=-1)
    else:
        out = pooled[..., cvm_offset:]
    if flatten:
        out = out.reshape(out.shape[0], -1)
    return out
