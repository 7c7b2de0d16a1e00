"""Fused sequence-pool + CVM transform — the port of
``ops/seqpool_cvm.py``: ``fused_seqpool_cvm``, its PCOC and conversion
variants, and the one-call ``fused_gather_seqpool_cvm`` over the table.

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

``fused_gather_seqpool_cvm`` pulls, filters and pools in one call over
the device table (the gather_pool kernel on the card, its plain version
on the CPU) and differentiates back to the table through a
``torch.autograd.Function``: each token's cotangent is its pooled row
times its keep factor, duplicates merge per unique row, and one scatter
writes the table cotangent. Quantization is straight-through there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.ops.cvm import cvm


@dataclasses.dataclass
class PooledSlots:
    """(B, S, P) per-slot sums that are already pooled."""
    pooled: torch.Tensor

    @property
    def shape(self):
        return self.pooled.shape


def _check_pooled_kwargs(need_filter, embed_threshold, quant_ratio):
    if need_filter or embed_threshold > 0.0 or quant_ratio > 0:
        raise ValueError(
            "per-token filters/quant cannot apply to a PooledSlots input; "
            "pass them to the fused gather-pool pull "
            "(ops.kernels.gather_pool) instead")


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
        _check_pooled_kwargs(need_filter, embed_threshold, quant_ratio)
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


def fused_seqpool_cvm_with_pcoc(pulled, mask: torch.Tensor, segment_ids,
                                num_slots: int, use_cvm: bool = True,
                                cvm_offset: int = 7, max_cvm_offset: int = 7,
                                need_filter: bool = False,
                                show_coeff: float = 0.2,
                                clk_coeff: float = 1.0,
                                threshold: float = 0.96,
                                quant_ratio: int = 0,
                                flatten: bool = True) -> torch.Tensor:
    """PCOC (predicted-click calibration) variant.

    Pull layout per token: [show, clk, show2, clk2, pclk_1..pclk_P,
    embedx] with P = cvm_offset - 4 and max_cvm_offset leading columns
    before embedx. Join phase per slot: [log(show+1), log(clk+1) -
    log(show+1), log(pclk_i+1) - log(show2+1) for each i, log(pclk_i+1)
    - log(clk2+1) for each i, pooled embedx]; update phase drops the
    max_cvm_offset leading columns."""
    pclk_num = cvm_offset - 4
    if pclk_num < 0:
        raise ValueError("cvm_offset must be >= 4 (show/clk/show2/clk2)")
    if isinstance(pulled, PooledSlots):
        _check_pooled_kwargs(need_filter, 0.0, quant_ratio)
        pooled = pulled.pooled
    else:
        seg_np = np.asarray(segment_ids, dtype=np.int64)
        keep = mask
        if need_filter:
            show, clk = pulled[..., 0], pulled[..., 1]
            keep = keep & ((show - clk) * show_coeff + clk * clk_coeff
                           >= threshold)
        x = pulled
        if quant_ratio > 0:
            q = (torch.round(x[..., max_cvm_offset:] * quant_ratio)
                 / quant_ratio)
            x = torch.cat([x[..., :max_cvm_offset], q], dim=-1)
        x = x * keep[..., None].to(x.dtype)
        pooled = _pool(x, seg_np, num_slots)
    if not use_cvm:
        out = pooled[..., max_cvm_offset:]
    else:
        def lg(c):
            return torch.log(pooled[..., c:c + 1] + 1.0)
        cols = [lg(0), lg(1) - lg(0)]
        cols += [lg(4 + i) - lg(2) for i in range(pclk_num)]
        cols += [lg(4 + i) - lg(3) for i in range(pclk_num)]
        cols.append(pooled[..., max_cvm_offset:])
        out = torch.cat(cols, dim=-1)
    if flatten:
        out = out.reshape(out.shape[0], -1)
    return out


def fused_seqpool_cvm_with_conv(pulled, mask: torch.Tensor, segment_ids,
                                num_slots: int, use_cvm: bool = True,
                                need_filter: bool = False,
                                show_coeff: float = 0.2,
                                clk_coeff: float = 1.0, threshold=0.96,
                                embed_threshold: float = 0.0,
                                quant_ratio: int = 0,
                                flatten: bool = True) -> torch.Tensor:
    """Conversion-aware variant: the pull layout carries a conv counter
    after show/clk, so embed_w sits at column 3 ([show, clk, conv, w,
    embedx]). Join phase emits [log(show+1), log(clk+1)-log(show+1),
    log(conv+1)-log(clk+1)] before the rest; update phase drops all
    three counters."""
    off = 3
    if isinstance(pulled, PooledSlots):
        _check_pooled_kwargs(need_filter, embed_threshold, quant_ratio)
        pooled = pulled.pooled
    else:
        seg_np = np.asarray(segment_ids, dtype=np.int64)
        x = _filter_and_quant(pulled, mask, seg_np, off, need_filter,
                              show_coeff, clk_coeff, threshold,
                              embed_threshold, quant_ratio)
        pooled = _pool(x, seg_np, num_slots)
    if use_cvm:
        log_show = torch.log(pooled[..., 0:1] + 1.0)
        log_clk = torch.log(pooled[..., 1:2] + 1.0)
        log_cvr = torch.log(pooled[..., 2:3] + 1.0) - log_clk
        out = torch.cat([log_show, log_clk - log_show, log_cvr,
                         pooled[..., off:]], dim=-1)
    else:
        out = pooled[..., off:]
    if flatten:
        out = out.reshape(out.shape[0], -1)
    return out


# ---------------------------------------------------------------------------
# fused gather-pool form: pull + filter + pool in one call over the table
# ---------------------------------------------------------------------------

def _keep_tokens(table, idx0, mask, thr, seg, need_filter, show_coeff,
                 clk_coeff, embed_threshold, cvm_offset) -> torch.Tensor:
    """(B*T,) keep factor of each token, as the forward's filters drop
    them: masked tokens, then need_filter and embed_threshold on the
    token's row."""
    keep = mask.reshape(-1)
    if need_filter or embed_threshold > 0.0:
        rows = table.index_select(0, idx0.reshape(-1).long())
        show, clk = rows[:, 0], rows[:, 1]
        if need_filter:
            t_flat = thr[seg].expand(idx0.shape).reshape(-1)
            keep = keep & ((show - clk) * show_coeff + clk * clk_coeff
                           >= t_flat)
        if embed_threshold > 0.0:
            w = rows[:, cvm_offset]
            keep = keep & ~((show > embed_threshold)
                            & (torch.abs(w) < embed_threshold))
    return keep


class _GatherPool(torch.autograd.Function):
    """Pooled (B, S, P) rows of the table, differentiable in the table."""

    @staticmethod
    def forward(ctx, table, idx0, mask, thr, cfg, S, L, kw):
        ctx.save_for_backward(table, idx0, mask, thr)
        ctx.cfg, ctx.S, ctx.L, ctx.kw = cfg, S, L, kw
        return kernels.gather_pool(table, idx0, cfg, S, L, threshold=thr,
                                   **kw)

    @staticmethod
    def backward(ctx, d_pooled):
        table, idx0, mask, thr = ctx.saved_tensors
        kw = ctx.kw
        S, P = ctx.S, ctx.cfg.pull_width
        B, T = idx0.shape
        dev = table.device
        seg = torch.arange(S, device=dev).repeat_interleave(ctx.L)
        bs = (torch.arange(B, device=dev)[:, None] * S
              + seg[None, :]).reshape(-1)
        d_tok = d_pooled.reshape(B * S, P).index_select(0, bs)
        keep = _keep_tokens(table, idx0, mask, thr, seg, kw["need_filter"],
                            kw["show_coeff"], kw["clk_coeff"],
                            kw["embed_threshold"], kw["cvm_offset"])
        d_tok = d_tok * keep.to(d_tok.dtype)[:, None]
        uniq, inverse = torch.unique(idx0.reshape(-1).long(),
                                     return_inverse=True)
        merged = torch.zeros(uniq.shape[0], P, dtype=d_tok.dtype,
                             device=dev).index_add_(0, inverse, d_tok)
        d_table = torch.zeros_like(table)
        d_table[uniq, :P] = merged
        return d_table, None, None, None, None, None, None, None


def fused_gather_seqpool_cvm(table: torch.Tensor, idx: torch.Tensor,
                             mask: torch.Tensor, segment_ids, num_slots: int,
                             cfg, use_cvm: bool = True, cvm_offset: int = 2,
                             need_filter: bool = False,
                             show_coeff: float = 0.2, clk_coeff: float = 1.0,
                             threshold=0.96, embed_threshold: float = 0.0,
                             quant_ratio: int = 0,
                             flatten: bool = True) -> torch.Tensor:
    """table (n_rows, W) × idx/mask (B, T) → pooled+CVM features, fused.

    Same contract as ``fused_seqpool_cvm(lookup(table, idx), mask, ...)``
    for f32 tables whose row 0 (NULL_INDEX) is all zeros, but the
    per-token pulled matrix never materialises: the forward gathers and
    pools in the gather_pool kernel (its plain version for CPU tensors),
    and the backward merges the pooled cotangent per unique row before
    the one scatter into the table's gradient. Needs the uniform slot
    layout (equal max_len per slot); ``cfg`` is the table's
    EmbeddingConfig."""
    if cfg.mf_create_threshold > 0 or cfg.expand_create_threshold > 0:
        # the pooled pull gathers raw rows: lookup()'s create-threshold
        # gating would be silently skipped
        raise ValueError(
            "fused_gather_seqpool_cvm skips gate_pull; create-threshold "
            "configs (mf/expand_create_threshold > 0) must use the "
            "unfused lookup + fused_seqpool_cvm path")
    seg_np = np.asarray(segment_ids, dtype=np.int64)
    S = num_slots
    if S <= 0 or idx.shape[1] % S:
        raise ValueError(f"token axis {idx.shape[1]} must be a multiple "
                         f"of num_slots {S}")
    L = idx.shape[1] // S
    if not np.array_equal(seg_np, np.repeat(np.arange(S), L)):
        raise ValueError(
            "fused gather-pool requires the uniform slot layout "
            "(equal max_len per slot); use the unfused path")
    mask = torch.as_tensor(mask, device=table.device)
    idx0 = torch.where(mask, torch.as_tensor(idx, device=table.device),
                       0).to(torch.int32).contiguous()
    thr = kernels.slot_thresholds(threshold, S, table.device)
    kw = dict(need_filter=bool(need_filter), show_coeff=float(show_coeff),
              clk_coeff=float(clk_coeff),
              embed_threshold=float(embed_threshold),
              quant_ratio=int(quant_ratio), cvm_offset=int(cvm_offset))
    pooled = _GatherPool.apply(table, idx0, mask, thr, cfg, S, L, kw)
    return fused_seqpool_cvm(PooledSlots(pooled), mask, segment_ids,
                             num_slots, use_cvm=use_cvm,
                             cvm_offset=cvm_offset, flatten=flatten)
