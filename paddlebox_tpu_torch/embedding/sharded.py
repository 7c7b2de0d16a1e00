"""Single-shard embedding pull and push — the port of the single-shard
core of ``embedding/sharded.py`` (lines 46-406).

The pass working set is one dense (n_rows, W) float32 table on the
device, or for int8/int16 storage a two-plane ``quant.QuantTable``;
batches carry int32 indices (0 = the all-zero null/padding row).

- ``lookup`` — gather pull values for any index shape;
- ``fused_pull_pool`` — the multi-hot pull: gather + per-(example, slot)
  sum pool in one kernel (ops.kernels.gather_pool), and
  ``pooled_grad_tokens`` — its backward, the pooled cotangent expanded
  per token;
- ``BlockPlan`` / ``DedupPlan`` — the two host plans a batch may carry
  to the push;
- ``plan_premerge`` — segment-sum per-token push payloads onto one lane
  per unique row, over the host dedup plan;
- ``push`` — merge duplicates and apply the in-table optimizer through
  the engine ``ops.kernels.resolve_push_engine`` picks;
  ``deferred_push_operands`` / ``apply_deferred`` split the same push
  across a step and its deferred apply (``flags.push_overlap``). A quantized
  table takes the accumulator alone from the engine (``binned_merge_acc``
  on the card for narrow rows) and then the dequant -> f32 update ->
  requant pass over its touched rows, which the reference runs in XLA
  with no Pallas kernel and the port in plain PyTorch.

- ``routed_lookup`` / ``routed_push`` — the routed multi-shard core
  (the token-level "single" table layout) over a ``parallel.mesh.Mesh``,
  with ``dedup_tokens``, ``merge_sorted_runs`` and the capacity rule the
  sharded exchange (``embedding/exchange.py``) shares.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from paddlebox_tpu_torch.embedding import gating, quant
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.optim import apply_updates
from paddlebox_tpu_torch.ops import kernels

NULL_INDEX = 0  # reserved all-zero row; padding tokens point here


class BlockPlan(NamedTuple):
    """The binned push's host plan (``native.key_index.block_plan``):
    token positions grouped by the kernel's table super-blocks, and each
    block's window [rstart, end) into ``order``."""
    order: Any
    rstart: Any
    end: Any


class DedupPlan(NamedTuple):
    """The host dedup plan (``native.key_index.dedup_plan``): tokens
    sorted by row, the ascending unique rows padded with ascending
    out-of-range ids, and each unique row's segment end. ``rstart`` /
    ``end`` are per-super-block windows over the unique lanes when the
    binned engine consumes them, else None."""
    order: Any
    uniq: Any
    segend: Any
    rstart: Any = None
    end: Any = None


def map_plan(plan, fn: Callable):
    """``fn`` over a plan's arrays (None fields and a None plan pass
    through): numpy → torch, pinning, staging to the device."""
    if plan is None:
        return None
    return type(plan)(*(None if a is None else fn(a) for a in plan))


def lookup(table, idx: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Gather pull values (show, clk, w, embedx) for int indices of any
    shape; returns idx.shape + (pull_width,). Null/padding indices return
    the zero row; create-threshold gating applies. A quantized table
    gathers both planes and dequantizes at the gather."""
    flat = idx.reshape(-1).long()
    if quant.is_quant(table):
        fp = table.fp.index_select(0, flat)
        x = table.qx.index_select(0, flat).to(torch.float32) * fp[:, -1:]
        rows = torch.cat([fp[:, :cfg.fixed_cols], x], dim=1)
    else:
        rows = table.index_select(0, flat)[:, :cfg.pull_width]
    return gating.gate_pull(rows, cfg).reshape(*idx.shape, cfg.pull_width)


def fused_pull_supported(cfg: EmbeddingConfig) -> bool:
    """The pooled pull skips create-threshold gating, so it must not
    engage where gating matters."""
    return (cfg.mf_create_threshold == 0
            and cfg.expand_create_threshold == 0)


def fused_pull_pool(table, idx: torch.Tensor, cfg: EmbeddingConfig,
                    num_slots: int, slot_len: int) -> torch.Tensor:
    """(B, S*L) translated indices → (B, S, pull_width) sum-pooled rows
    through the gather_pool kernel (its plain version on the CPU). Masked
    tokens must already point at NULL_INDEX (translate does); the null
    row is all zeros, so padding contributes nothing. The kernel reads
    f32 tables only (``pallas_kernels.py:846``): a quantized table pools
    ``lookup``'s dequantized rows."""
    if quant.is_quant(table):
        B = idx.shape[0]
        return lookup(table, idx.reshape(-1), cfg).reshape(
            B, num_slots, slot_len, cfg.pull_width).sum(dim=2)
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

    plan : a DedupPlan (its first three fields are read). The
    sum is a prefix sum over the sorted payload differenced at the
    segment ends; it restarts every _CS_BLOCK tokens (block-local cumsum
    plus per-block bases), so a segment's rounding error scales with its
    block's payload, not the whole stream's. Pad lanes get zero-width
    segments.

    Returns (uniq, merged_grads, merged_shows, merged_clks); the merged
    tensors are column views of one (n, grad_width + 2) payload."""
    order, uniq, segend = plan[:3]
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


def quant_update(table: quant.QuantTable, acc: torch.Tensor,
                 cfg: EmbeddingConfig) -> None:
    """The quantized table's update, in place: dequantize every row,
    apply the optimizer in f32 exactly as an f32 table does, requantize
    with a fresh per-row scale, and keep the result where the touch
    count ``acc[:, grad_width + 2]`` is > 0. Untouched rows keep the
    bits of both planes (a row must not round twice unless it changed).
    One pass over the planes, as the reference's XLA fusion."""
    gw = cfg.grad_width
    rows = quant.assemble_rows(table.fp, table.qx, cfg)
    new = quant.split_rows(apply_updates(rows, acc[:, :gw], acc[:, gw],
                                         acc[:, gw + 1], cfg), cfg)
    touched = (acc[:, gw + 2] > 0)[:, None]
    table.fp.copy_(torch.where(touched, new.fp, table.fp))
    table.qx.copy_(torch.where(touched, new.qx, table.qx))


def _lane_windows(plan: DedupPlan):
    """The binned engine's windows over a dedup plan's unique lanes (the
    lanes are sorted by row, so the windows index them directly), or
    None."""
    return None if plan.rstart is None else (None, plan.rstart, plan.end)


def push(table, idx: torch.Tensor, grads: torch.Tensor,
         shows: torch.Tensor, clks: torch.Tensor, cfg: EmbeddingConfig,
         plan: BlockPlan | DedupPlan | None = None) -> str:
    """Merge-and-update: apply summed grads + show/clk increments to the
    table IN PLACE; returns the engine that ran.

    idx   : (n,) int32 row indices (duplicates fine; 0 = null, must carry
            zero grads/increments; ids >= n_rows are dropped)
    grads : (n, grad_width) per-token d_w, d_embedx
    shows, clks : (n,) per-token counter increments
    plan  : None, a BlockPlan (the binned engine's token grouping), or a
            DedupPlan: the tokens premerge onto unique lanes first, the
            resolver may pick the fused ``scatter_accumulate`` kernel,
            and the plan's lane windows (if any) feed the binned engine.

    Untouched rows keep their exact bits (stateful optimizers would
    otherwise decay state on every row); the null row only ever receives
    zero grads and increments, a fixed point of every optimizer."""
    if isinstance(plan, DedupPlan):
        idx, grads, shows, clks = plan_premerge(idx, grads, shows, clks,
                                                plan)
        return _merge_update(table, idx, grads, shows, clks, cfg,
                             premerged=True, windows=_lane_windows(plan))
    return _merge_update(table, idx, grads, shows, clks, cfg,
                         premerged=False,
                         windows=plan if isinstance(plan, BlockPlan)
                         else None)


def deferred_push_operands(idx: torch.Tensor, grads: torch.Tensor,
                           shows: torch.Tensor, clks: torch.Tensor, plan
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """A step's push operands for a deferred apply (JAX
    ``sharded.py:254``), in place of the push. A dedup plan premerges
    here, where backward produced the cotangent (off the loss path), and
    the operands are the unique lanes' (merged grads, shows, clks);
    otherwise they are (per-token grads, empty, empty) and the apply
    recomputes the increments from the staged mask and labels. Either
    way :func:`apply_deferred` then runs the very push the inline step
    runs."""
    if isinstance(plan, DedupPlan):
        _, mg, ms, mc = plan_premerge(idx, grads, shows, clks, plan)
        return mg, ms, mc
    empty = grads.new_zeros(0)
    return grads, empty, empty


def apply_deferred(table, idx: torch.Tensor, mask: torch.Tensor,
                   labels: torch.Tensor, plan, ops: tuple,
                   cfg: EmbeddingConfig) -> str:
    """The deferred push: ``deferred_push_operands``' output replayed
    through the same engine ``push`` picks (the quantized table's
    accumulator and requant pass included), on the staged batch tensors
    of the step that made it. Returns the engine that ran."""
    g0, g1, g2 = ops
    if isinstance(plan, DedupPlan):
        return _merge_update(table, plan.uniq, g0, g1, g2, cfg,
                             premerged=True, windows=_lane_windows(plan))
    maskf = mask.to(torch.float32)
    return push(table, idx.reshape(-1), g0, maskf.reshape(-1),
                (maskf * labels[:, None]).reshape(-1), cfg, plan=plan)


def _merge_update(table, idx: torch.Tensor, grads: torch.Tensor,
                  shows: torch.Tensor, clks: torch.Tensor,
                  cfg: EmbeddingConfig, premerged: bool, windows) -> str:
    """The engine half of ``push``: premerged lanes or raw tokens into
    the table through the resolved engine."""
    if quant.is_quant(table):
        n_rows = quant.table_rows(table)
        engine = kernels.resolve_push_engine(
            cfg, n_rows, premerged=premerged,
            device_type=table.fp.device.type)
        if engine == "binned_kernel":
            acc = kernels.binned_merge_acc(idx, grads, shows, clks, cfg,
                                           n_rows, plan=windows)
        else:
            acc = kernels.binned_merge_acc_plain(idx, grads, shows, clks,
                                                 cfg, n_rows)
        quant_update(table, acc, cfg)
        return engine
    n_rows, W = table.shape
    engine = kernels.resolve_push_engine(
        cfg, n_rows, premerged=premerged, device_type=table.device.type,
        table_width=W)
    if engine == "scatter_accumulate":
        kernels.scatter_accumulate(table, idx, grads, shows, clks, cfg)
    elif engine == "binned_kernel":
        kernels.binned_push(table, idx, grads, shows, clks, cfg,
                            plan=windows)
    else:
        # xla_scatter: one index_add_ of the token payload into a per-row
        # accumulator, then the optimizer over the rows it touched
        acc = kernels.binned_merge_acc_plain(idx, grads, shows, clks, cfg,
                                             n_rows)
        kernels.merge_update(table, acc, cfg)
    return engine


# ---------------------------------------------------------------------------
# the routed (multi-shard) path: the "single" table layout
# ---------------------------------------------------------------------------
#
# Each rank holds one contiguous shard of the working-set table (rows
# [rank * rps, (rank + 1) * rps), ``parallel.mesh.Mesh.table_rows``) and
# routes its tokens to the owning shards with a fixed-capacity tiled
# all-to-all over the mesh (JAX ``sharded.py:413-663``; there the same
# functions run inside ``shard_map``, here on every rank's process).

def _capacity(n: int, n_shards: int, factor: float) -> int:
    """Lanes per destination for ``n`` routed tokens: ``ceil(n * factor
    / n_shards)`` on Python floats, clipped to [1, n] — the JAX
    package's formula to the bit, so preplanned factors and drop counts
    agree."""
    return max(1, min(n, int(-(-n * factor // n_shards))))


def _route(idx: torch.Tensor, rows_per_shard: int, n_shards: int,
           cap: int):
    """The fixed-capacity routing plan of a flat token vector: (order,
    sorted_owner, pos, valid, send_idx), ``send_idx`` the (n_shards, cap)
    per-destination index buffer (-1 = empty lane). Tokens past a
    destination's capacity are dropped (``routed_dropped`` counts them).
    NULL_INDEX tokens are never routed: every consumer synthesizes the
    zero row locally, and on row 0's shard they would crowd out real
    tokens."""
    owner = torch.where(idx == NULL_INDEX, n_shards,
                        torch.div(idx, rows_per_shard, rounding_mode="floor"))
    return _route_owner(idx, owner.long(), n_shards, cap)


def _route_owner(idx: torch.Tensor, owner: torch.Tensor, n_groups: int,
                 cap: int):
    """The routing-plan core with the destination group given; group
    ``n_groups`` (and any above it) is the drop group. The sort is
    stable, so within a group tokens keep their input order — ascending
    input gives ascending per-destination runs, which the receive side's
    D-way merge rests on."""
    n = idx.shape[0]
    dev = idx.device
    sowner, order = torch.sort(owner, stable=True)
    sidx = idx.index_select(0, order)
    counts = torch.bincount(owner, minlength=n_groups + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts.index_select(0, sowner)
    valid = (pos < cap) & (sowner < n_groups)
    send_idx = torch.full((n_groups * cap,), -1, dtype=idx.dtype,
                          device=dev)
    lane = sowner * cap + pos
    send_idx[lane[valid]] = sidx[valid]
    return order, sowner, pos, valid, send_idx.reshape(n_groups, cap)


def _scatter_lanes(payload: torch.Tensor, sowner: torch.Tensor,
                   pos: torch.Tensor, valid: torch.Tensor, n_groups: int,
                   cap: int) -> torch.Tensor:
    """(n, w) payload in routed order → the (n_groups, cap, w) send
    buffer (zeros in empty lanes)."""
    out = payload.new_zeros((n_groups * cap, payload.shape[1]))
    out[(sowner * cap + pos)[valid]] = payload[valid]
    return out.reshape(n_groups, cap, payload.shape[1])


def routed_lookup(table_shard, idx: torch.Tensor, cfg: EmbeddingConfig,
                  mesh, axes, capacity_factor: float = 2.0,
                  dedup: bool = False, return_dropped: bool = False):
    """Distributed gather over the mesh (JAX ``routed_lookup``).

    table_shard : this rank's (rows_per_shard, W) shard (or QuantTable)
    idx         : (n,) int32 *global* working-set indices of this rank's
                  tokens
    dedup       : route each unique token once and re-expand after the
                  gather (FLAGS_enable_pullpush_dedup_keys)
    return_dropped : also return this rank's count of real tokens that
                  overflowed a destination's capacity (exact, from the
                  plan's valid mask; a device scalar, no host sync)
    The owner gathers with ``lookup`` (gating and the quantized table's
    dequantization there), so the received rows are final. Returns (n,
    pull_width), or (out, dropped)."""
    n = idx.shape[0]
    D = mesh.axis_size(axes)
    if D == 1:
        out = lookup(table_shard, idx, cfg)
        zero = torch.zeros((), dtype=torch.int64, device=idx.device)
        return (out, zero) if return_dropped else out
    if dedup:
        uniq, inverse = dedup_tokens(idx)
        res = routed_lookup(table_shard, uniq, cfg, mesh, axes,
                            capacity_factor, return_dropped=return_dropped)
        if return_dropped:
            return res[0].index_select(0, inverse), res[1]
        return res.index_select(0, inverse)
    rps = quant.table_rows(table_shard)
    cap = _capacity(n, D, capacity_factor)
    P = cfg.pull_width
    order, sowner, pos, valid, send_idx = _route(idx, rps, D, cap)
    recv_idx = mesh.all_to_all(send_idx, axes)
    lane_ok = recv_idx >= 0
    local_row = torch.where(lane_ok, recv_idx % rps, 0)
    vals = lookup(table_shard, local_row.reshape(-1), cfg).reshape(D, cap, P)
    vals = torch.where(lane_ok[:, :, None], vals, 0.0)
    back = mesh.all_to_all(vals, axes).reshape(D * cap, P)
    # the drop group's tokens read a clamped lane, then zero by `valid`
    lane = sowner.clamp(max=D - 1) * cap + pos.clamp(max=cap - 1)
    gathered = torch.where(valid[:, None], back.index_select(0, lane), 0.0)
    out = gathered.new_zeros((n, P))
    out[order] = gathered
    if return_dropped:
        return out, ((~valid) & (sowner < D)).sum()
    return out


def routed_push(table_shard, idx: torch.Tensor, grads: torch.Tensor,
                shows: torch.Tensor, clks: torch.Tensor,
                cfg: EmbeddingConfig, mesh, axes,
                capacity_factor: float = 2.0, dedup: bool = False,
                plan=None) -> str:
    """Distributed merge-update (the reverse of ``routed_lookup``), in
    place on this rank's shard; returns the engine the owner ran.

    ``dedup`` merges per-token payloads onto unique tokens before
    routing (masked tokens carry zero payloads, so their merge onto the
    null lane is a no-op). ``plan`` applies on one shard only: tokens
    after the all-to-all have no host plan. Received empty lanes go to
    the out-of-range local row ``rps`` and are dropped by the push — on
    row 0 (a real row on every shard but the first) adam would decay an
    untouched row's moments."""
    n = idx.shape[0]
    D = mesh.axis_size(axes)
    if D == 1:
        return push(table_shard, idx, grads, shows, clks, cfg, plan=plan)
    gw = cfg.grad_width
    if dedup:
        uniq, inverse = dedup_tokens(idx)
        payload = torch.cat([grads, shows[:, None], clks[:, None]], dim=1)
        merged = payload.new_zeros((n, gw + 2)).index_add_(0, inverse,
                                                           payload)
        return routed_push(table_shard, uniq, merged[:, :gw],
                           merged[:, gw], merged[:, gw + 1], cfg, mesh,
                           axes, capacity_factor)
    rps = quant.table_rows(table_shard)
    cap = _capacity(n, D, capacity_factor)
    order, sowner, pos, valid, send_idx = _route(idx, rps, D, cap)
    payload = torch.cat([grads, shows[:, None], clks[:, None]],
                        dim=1).index_select(0, order)
    send_pay = _scatter_lanes(payload, sowner, pos, valid, D, cap)
    flat_idx = mesh.all_to_all(send_idx, axes).reshape(-1)
    flat_pay = mesh.all_to_all(send_pay, axes).reshape(-1, gw + 2)
    empty = flat_idx < 0
    local_row = torch.where(empty, rps, flat_idx % rps).to(torch.int32)
    flat_pay = torch.where(empty[:, None], 0.0, flat_pay)
    return push(table_shard, local_row, flat_pay[:, :gw], flat_pay[:, gw],
                flat_pay[:, gw + 1], cfg)


def routed_dropped(idx: torch.Tensor, rows_per_shard: int, n_shards: int,
                   capacity_factor: float = 2.0) -> torch.Tensor:
    """Tokens that exceed per-destination capacity (monitoring); null
    tokens are not routed and do not count."""
    n = idx.shape[0]
    cap = _capacity(n, n_shards, capacity_factor)
    owner = torch.where(idx == NULL_INDEX, n_shards,
                        torch.div(idx, rows_per_shard, rounding_mode="floor"))
    counts = torch.bincount(owner.long(), minlength=n_shards + 1)[:n_shards]
    return (counts - cap).clamp(min=0).sum()


# ---------------------------------------------------------------------------
# dedup (FLAGS_enable_pullpush_dedup_keys, flags.cc:603)
# ---------------------------------------------------------------------------

def _segments(sorted_vals: torch.Tensor) -> torch.Tensor:
    """Segment id per position of an ascending vector."""
    is_start = torch.ones_like(sorted_vals, dtype=torch.bool)
    is_start[1:] = sorted_vals[1:] != sorted_vals[:-1]
    return torch.cumsum(is_start.to(torch.int64), 0) - 1


def dedup_tokens(idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-capacity unique: (unique_idx, inverse), the unused tail of
    unique_idx NULL_INDEX — ``lookup(t, unique_idx)[inverse] ==
    lookup(t, idx)`` (the reference's DedupKeysAndFillIdx,
    box_wrapper_impl.h:103). The sort is stable, as JAX's argsort."""
    n = idx.shape[0]
    sidx, order = torch.sort(idx, stable=True)
    seg = _segments(sidx)
    unique_idx = idx.new_zeros(n)
    unique_idx[seg] = sidx
    inverse = torch.empty(n, dtype=torch.int64, device=idx.device)
    inverse[order] = seg
    return unique_idx, inverse


def merge_sorted_runs(runs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``dedup_tokens(runs.reshape(-1))`` — the same outputs, bit for
    bit — for a (D, L) batch of row-wise ascending runs, without the
    global sort: each element's sorted rank is its position in its run
    plus, per other run, a binary search (right side for earlier runs,
    left for later ones, so equal values count only from earlier runs —
    the stable sort's order)."""
    D, L = runs.shape
    n = D * L
    ranks = []
    for r in range(D):
        acc = torch.arange(L, device=runs.device)
        for r2 in range(D):
            if r2 != r:
                acc = acc + torch.searchsorted(runs[r2], runs[r],
                                               right=r2 < r)
        ranks.append(acc)
    rank = torch.stack(ranks).reshape(-1)
    flat = runs.reshape(-1)
    sorted_vals = torch.empty_like(flat)
    sorted_vals[rank] = flat
    seg = _segments(sorted_vals)
    unique_idx = flat.new_zeros(n)
    unique_idx[seg] = sorted_vals
    return unique_idx, seg.index_select(0, rank)
