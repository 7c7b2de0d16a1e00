"""Single-shard embedding pull and push — the port of the single-shard
core of ``embedding/sharded.py`` (lines 46-406).

The pass working set is one dense (n_rows, W) float32 table on the
device; batches carry int32 indices (0 = the all-zero null/padding row).

- ``lookup`` — gather pull values for any index shape;
- ``fused_pull_pool`` — the multi-hot pull: gather + per-(example, slot)
  sum pool in one kernel (ops.kernels.gather_pool), and
  ``pooled_grad_tokens`` — its backward, the pooled cotangent expanded
  per token;
- ``plan_premerge`` — segment-sum per-token push payloads onto one lane
  per unique row, over the host dedup plan;
- ``push`` — merge duplicates and apply the in-table optimizer through
  the engine ``ops.kernels.resolve_push_engine`` picks.

The routed multi-shard path is not ported yet (ROADMAP, multi-GPU).
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.embedding import gating
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.optim import apply_updates
from paddlebox_tpu_torch.ops import kernels

NULL_INDEX = 0  # reserved all-zero row; padding tokens point here


def lookup(table: torch.Tensor, idx: torch.Tensor,
           cfg: EmbeddingConfig) -> torch.Tensor:
    """Gather pull values (show, clk, w, embedx) for int indices of any
    shape; returns idx.shape + (pull_width,). Null/padding indices return
    the zero row; create-threshold gating applies."""
    rows = table.index_select(0, idx.reshape(-1).long())[:, :cfg.pull_width]
    return gating.gate_pull(rows, cfg).reshape(*idx.shape, cfg.pull_width)


def fused_pull_supported(cfg: EmbeddingConfig) -> bool:
    """The pooled pull skips create-threshold gating, so it must not
    engage where gating matters."""
    return (cfg.mf_create_threshold == 0
            and cfg.expand_create_threshold == 0)


def fused_pull_pool(table: torch.Tensor, idx: torch.Tensor,
                    cfg: EmbeddingConfig, num_slots: int,
                    slot_len: int) -> torch.Tensor:
    """(B, S*L) translated indices → (B, S, pull_width) sum-pooled rows
    through the gather_pool kernel (its plain version on the CPU). Masked
    tokens must already point at NULL_INDEX (translate does); the null
    row is all zeros, so padding contributes nothing."""
    return kernels.gather_pool(table, idx, cfg, num_slots, slot_len)


def pooled_grad_tokens(gpooled: torch.Tensor, mask: torch.Tensor,
                       segment_ids, num_slots: int) -> torch.Tensor:
    """Per-token sparse grads from the pooled cotangent.

    Pooling is a per-segment sum, so each token's pull cotangent is its
    (example, slot) pooled row: gpooled (B, S, pull_width) → (B*T,
    grad_width) rows ``gpooled[b, seg[t], 2:] * mask[b, t]`` (the show/clk
    cotangents drop; the mask keeps null-row grads zero)."""
    B, S, P = gpooled.shape
    seg = torch.as_tensor(segment_ids, dtype=torch.int64,
                          device=gpooled.device)
    bs = (torch.arange(B, device=gpooled.device)[:, None] * S
          + seg[None, :]).reshape(-1)
    tok = gpooled.reshape(B * S, P)[:, 2:].index_select(0, bs)
    return tok * mask.reshape(-1).to(tok.dtype)[:, None]


# Cumsum restart granularity of the premerge segment sums: bounds the
# f32 prefix magnitude each segment difference cancels against to one
# block's payload sum instead of the whole token stream's.
_CS_BLOCK = 4096


def plan_premerge(idx: torch.Tensor, grads: torch.Tensor,
                  shows: torch.Tensor, clks: torch.Tensor, plan):
    """Device half of the host dedup plan: segment-sum per-token payloads
    onto one lane per unique row.

    plan = (order, uniq, segend) from ``native.key_index.dedup_plan``:
    tokens sorted by row, the ascending unique rows (padded with
    ascending out-of-range ids) and each unique row's segment end. The
    sum is a prefix sum over the sorted payload differenced at the
    segment ends; it restarts every _CS_BLOCK tokens (block-local cumsum
    plus per-block bases), so a segment's rounding error scales with its
    block's payload, not the whole stream's. Pad lanes get zero-width
    segments.

    Returns (uniq, merged_grads, merged_shows, merged_clks); the merged
    tensors are column views of one (n, grad_width + 2) payload."""
    order, uniq, segend = plan
    pay = torch.cat([grads, shows[:, None], clks[:, None]], dim=1)
    s_pay = pay.index_select(0, order.long())
    n, Wp = s_pay.shape
    C = _CS_BLOCK
    nc = max(1, -(-n // C))
    pad = nc * C - n
    if pad:
        s_pay = torch.cat([s_pay, s_pay.new_zeros((pad, Wp))], dim=0)
    blocks = s_pay.reshape(nc, C, Wp)
    # lcs0[c, j] = sum of block c's first j tokens; base[c] = sum of all
    # tokens before block c. prefix(p) = base[p // C] + lcs0[p // C, p % C]
    lcs0 = torch.cat([s_pay.new_zeros((nc, 1, Wp)),
                      torch.cumsum(blocks, dim=1)], dim=1)
    base = torch.cat([s_pay.new_zeros((1, Wp)),
                      torch.cumsum(lcs0[:, -1, :], dim=0)], dim=0)[:-1]
    flat_lcs = lcs0.reshape(nc * (C + 1), Wp)
    seg_end = segend.long()
    starts = torch.cat([seg_end.new_zeros(1), seg_end[:-1]])

    def prefix_parts(p):
        # p == nc*C (the stream end) clips to the (nc-1, C) cell, its base
        # to nc-1 — exactly the stream total
        c = p // C
        li = c * (C + 1) + p % C
        b = base.index_select(0, c.clamp(max=nc - 1))
        loc = flat_lcs.index_select(0, li.clamp(max=nc * (C + 1) - 1))
        return b, loc

    b_hi, l_hi = prefix_parts(seg_end)
    b_lo, l_lo = prefix_parts(starts)
    # local differences first: same-block segments see their bases
    # cancel exactly in (b_hi - b_lo)
    m = (l_hi - l_lo) + (b_hi - b_lo)
    gw = grads.shape[1]
    return uniq, m[:, :gw], m[:, gw], m[:, gw + 1]


def push(table: torch.Tensor, idx: torch.Tensor, grads: torch.Tensor,
         shows: torch.Tensor, clks: torch.Tensor, cfg: EmbeddingConfig,
         plan=None) -> str:
    """Merge-and-update: apply summed grads + show/clk increments to the
    table IN PLACE; returns the engine that ran.

    idx   : (n,) int32 row indices (duplicates fine; 0 = null, must carry
            zero grads/increments; ids >= n_rows are dropped)
    grads : (n, grad_width) per-token d_w, d_embedx
    shows, clks : (n,) per-token counter increments
    plan  : the host dedup plan (order, uniq, segend) or None. With a
            plan the tokens premerge onto unique lanes first, and the
            resolver may pick the fused ``scatter_accumulate`` kernel.

    Untouched rows keep their exact bits (stateful optimizers would
    otherwise decay state on every row); the null row only ever receives
    zero grads and increments, a fixed point of every optimizer."""
    premerged = plan is not None
    if premerged:
        idx, grads, shows, clks = plan_premerge(idx, grads, shows, clks,
                                                plan)
    n_rows, W = table.shape
    engine = kernels.resolve_push_engine(
        cfg, n_rows, premerged=premerged, device_type=table.device.type,
        table_width=W)
    if engine == "scatter_accumulate":
        kernels.scatter_accumulate(table, idx, grads, shows, clks, cfg)
        return engine
    # xla_scatter: one index_add_ of the token payload into a per-row
    # accumulator (out-of-range ids land in a spare last row, dropped),
    # then the optimizer over the table masked to touched rows
    gw = cfg.grad_width
    n = idx.shape[0]
    payload = torch.cat([grads, shows[:, None], clks[:, None],
                         grads.new_ones((n, 1))], dim=1)
    safe = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows).long()
    acc = table.new_zeros((n_rows + 1, gw + 3)).index_add_(0, safe, payload)
    acc = acc[:n_rows]
    touched = acc[:, gw + 2] > 0
    new_rows = apply_updates(table, acc[:, :gw], acc[:, gw], acc[:, gw + 1],
                             cfg)
    table.copy_(torch.where(touched[:, None], new_rows, table))
    return engine
