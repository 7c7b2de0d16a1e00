"""The sparsity-aware exchange over the mesh-partitioned table — the
port of ``embedding/exchange.py`` (the ``"sharded"`` table layout).

The reference shards its embedding table across devices inside libbox_ps
and moves batches through hand-built all-to-all pull/push over NCCL
(box_wrapper_impl.h:44-103). This module is that exchange, grown from the
``sharded.routed_lookup`` / ``routed_push`` cores with two ideas:

- **Route only the deduped unique rows.** The pack thread's dedup plan
  (``native.key_index.dedup_plan``, one per rank over its batch slice)
  already orders tokens by row: the push premerges per-token payloads
  onto one lane per unique row *before* the all-to-all
  (``sharded.plan_premerge``) and the pull routes each unique row once,
  re-expanding after the gather (``plan_dedup_indices``).
- **Compress the push wire** (``flags.exchange_wire``): the grad plane
  crosses as bf16 or int8 with a per-lane scale; show/clk increments and
  the scale ride an f32 side plane, so counters never round. f32 keeps
  the wire exact (the parity baseline).

The pooled pull runs **per shard after routing**: ``routed_pull_pooled``
routes the unique rows, lands them in a local (lanes, pull_width) table
and pools per (example, slot) from that table through the
``gather_pool`` kernel (its plain version on the CPU), so the (B*T,
pull_width) token matrix never exists. The push's apply tail on the
owner shard, when ``resolve_push_engine`` picks ``scatter_accumulate``,
merges the received lanes (one per (source, row), ascending per source)
with ``sharded.merge_sorted_runs`` and updates exactly those rows with
the ``scatter_accumulate`` kernel; otherwise it runs ``sharded.push``
(``merge_update`` behind it). ``_routed_push_hier`` is the two-stage
push on a (node, dp) mesh: an intra-node shuffle, a node-level merge,
then the wire-compressed inter-node exchange.

Capacity overflow is never silent: every pull reports its exact dropped
count and the trainer feeds it to the ``exchange.overflow_dropped``
counter, the ``exchange_overflow`` event and the grow-retry policy
(``Trainer._check_dropped``).
"""

from __future__ import annotations

import torch

from paddlebox_tpu_torch.config import flags as config_flags
from paddlebox_tpu_torch.embedding import quant, sharded
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.sharded import (_capacity, _route,
                                                   _route_owner,
                                                   _scatter_lanes,
                                                   dedup_tokens,
                                                   merge_sorted_runs)
from paddlebox_tpu_torch.ops import kernels

# push-payload wire formats (the pull's embedx plane already crosses
# quantized for quantized tables — sharded.routed_lookup)
WIRES = ("f32", "bf16", "int8")

# all_to_all decompositions for the push exchange
TOPOLOGIES = ("flat", "hier")


def select_wire(cfg: EmbeddingConfig) -> str:
    """Resolve flags.exchange_wire for this table (read when the Trainer
    is built, recorded in the flight record as ``exchange_wire``). "auto" =
    bf16 — the sparse grads reaching the wire already carry bf16-level
    rounding from the backward matmuls (the same argument as
    binned_push_splits=2), so the wire halves for free; int8 tables get
    int8 (their pull payload already crosses at that precision, and the
    push should not be the wider leg)."""
    w = config_flags.exchange_wire
    if w == "auto":
        return "int8" if cfg.storage == "int8" else "bf16"
    if w not in WIRES:
        raise ValueError(
            f"flags.exchange_wire={w!r} (want auto|f32|bf16|int8)")
    return w


def select_topology(axis_sizes) -> str:
    """Resolve flags.exchange_topology against the mesh shape (read when
    the Trainer is built, recorded in the flight record).

    "hier" decomposes the push all_to_all into an intra-host shuffle
    over the trailing (dp) axis followed by a host-merged inter-host
    exchange over the leading (node) axis — it needs a real 2-axis
    mesh. "auto" picks hier exactly when such a (node, dp) shape
    exists (both axes > 1: a degenerate axis has nothing to merge
    across or nothing to exchange between), flat elsewhere."""
    t = config_flags.exchange_topology
    if t not in ("auto",) + TOPOLOGIES:
        raise ValueError(
            f"flags.exchange_topology={t!r} (want auto|flat|hier)")
    sizes = tuple(int(s) for s in axis_sizes)
    if t == "hier":
        if len(sizes) < 2:
            raise ValueError(
                "flags.exchange_topology='hier' needs a (node, dp) mesh; "
                f"got axis sizes {sizes}")
        return "hier"
    if t == "auto" and len(sizes) >= 2 and all(s > 1 for s in sizes):
        return "hier"
    return "flat"


# ---------------------------------------------------------------------------
# per-pass wire selection (the adaptive controller)
# ---------------------------------------------------------------------------

# Modeled precision-exposure surcharge per merged token contribution, in
# byte units per grad column: each duplicate of a row adds one ROUNDED
# contribution to the cross-device sum (bf16: 8-bit mantissa on each
# value; int8: 7-bit resolution of the per-lane max, worse when a lane's
# columns spread in magnitude). f32 is exact — the parity baseline.
_WIRE_EXPOSURE = {"f32": 0.0, "bf16": 0.25, "int8": 1.0}


def wire_cost(cfg: EmbeddingConfig, tokens: int, unique_lanes: int,
              wire: str) -> float:
    """Modeled per-pass cost of a push wire, in byte units: the real
    a2a bytes for the pass's unique lanes plus the precision-exposure
    surcharge scaled by the token count (the number of rounded
    contributions that merge). The dedup depth d = tokens/unique is the
    regime knob: duplication-heavy passes amortize the wide exact wire
    over many merged contributions (f32 wins past d ≈ 8), unique-heavy
    passes are bytes-bound (bf16, then int8 once the grad plane dwarfs
    the fixed index/side/scale columns)."""
    u = max(1, int(unique_lanes))
    t = max(int(tokens), u)
    if wire not in WIRES:
        raise ValueError(f"wire={wire!r} (want f32|bf16|int8)")
    base = float(push_wire_bytes(cfg, u, wire))
    return base + _WIRE_EXPOSURE[wire] * t * cfg.grad_width


class WireController:
    """Per-pass exchange_wire selection from the evidence the exchange
    already emits (flags.exchange_adaptive, ROADMAP "self-adapting
    exchange") — the collective-selection loop of the adaptive sparse
    collectives line (arXiv:2607.04676) run at pass grain, the way
    spill_cache_autotune adapts the cache budget.

    ``observe`` is called once per pass with the pass's own counter
    deltas (exchange.tokens / exchange.unique_lanes / overflow retries)
    and, where a caller has one, a flow-edge attribution (the JAX
    package's world trace makes it; the port has none yet). It returns
    a decision dict; the caller applies ``decision["wire"]`` to the
    next pass, as the adaptive capacity doubling is applied.

    Stability rules (the no-flap guarantee):
      - a challenger wire must win ``hysteresis`` CONSECUTIVE passes
        before the switch; a different challenger resets the streak;
      - overflow retries hold the wire (the capacity histogram is
        shifting — the evidence is stale);
      - a flow attribution that shows the exchange edge under
        ``min_share`` of the wall holds the wire (not the limiter:
        switching buys nothing);
      - cost ties break toward the ACTIVE wire, then the wider one.

    The parity guard is structural, not a controller rule: show/clk
    counter increments (and the int8 scale) ride the f32 side plane on
    EVERY wire (``_compress_push``), so no decision can round a counter.
    """

    def __init__(self, cfg: EmbeddingConfig, wire: str,
                 hysteresis: int = 2, min_share: float = 0.02):
        self.cfg = cfg
        self.wire = wire
        self.hysteresis = max(1, int(hysteresis))
        self.min_share = float(min_share)
        self.switches = 0
        self._challenger = None
        self._streak = 0

    def _hold(self, reason: str, costs=None) -> dict:
        self._challenger, self._streak = None, 0
        return {"wire": self.wire, "prev_wire": self.wire,
                "switched": False, "candidate": None, "streak": 0,
                "costs": costs or {}, "reason": reason}

    def observe(self, tokens: int, unique_lanes: int,
                overflow_retries: int = 0, flow: dict | None = None,
                wall_seconds: float | None = None) -> dict:
        if int(tokens) <= 0:
            return self._hold("no-traffic")
        if int(overflow_retries) > 0:
            return self._hold("overflow-hold")
        if flow and wall_seconds and flow.get("edges", 0) > 0:
            ex = (flow.get("by_kind") or {}).get("exchange")
            share = (float(ex["max_latency_s"]) / float(wall_seconds)
                     if ex else 0.0)
            if share < self.min_share:
                return self._hold("not-limiter")
        costs = {w: wire_cost(self.cfg, tokens, unique_lanes, w)
                 for w in WIRES}
        # tie-break: active wire first, then wider (WIRES is widest-first)
        best = min(WIRES, key=lambda w: (costs[w], 0 if w == self.wire
                                         else 1, WIRES.index(w)))
        if best == self.wire:
            self._challenger, self._streak = None, 0
            return {"wire": self.wire, "prev_wire": self.wire,
                    "switched": False, "candidate": None, "streak": 0,
                    "costs": costs, "reason": "optimal"}
        if best == self._challenger:
            self._streak += 1
        else:
            self._challenger, self._streak = best, 1
        if self._streak >= self.hysteresis:
            prev, self.wire = self.wire, best
            self._challenger, self._streak = None, 0
            self.switches += 1
            return {"wire": best, "prev_wire": prev, "switched": True,
                    "candidate": best, "streak": self.hysteresis,
                    "costs": costs, "reason": "switched"}
        return {"wire": self.wire, "prev_wire": self.wire,
                "switched": False, "candidate": best,
                "streak": self._streak, "costs": costs,
                "reason": "challenger"}


def push_wire_bytes(cfg: EmbeddingConfig, lanes: int, wire: str) -> int:
    """Per-direction a2a bytes for `lanes` push lanes under `wire`
    (index plane + grad plane + f32 side plane) — the host-side
    accounting behind the ``exchange.push_bytes`` counter."""
    gw = cfg.grad_width
    gbytes = {"f32": 4 * gw, "bf16": 2 * gw, "int8": gw}[wire]
    side = 4 * (3 if wire == "int8" else 2)   # show, clk (+ scale)
    return lanes * (4 + gbytes + side)


def flow_fields(cfg: EmbeddingConfig, wire: str, tokens: int) -> dict:
    """Edge-label fields of a world-trace ``exchange`` flow point (JAX
    exchange.py:241): the wire format and an upper bound on the bytes
    this step's all-to-all crosses (lanes <= tokens — the dedup plan can
    only shrink it; the exact per-pass totals are the ``exchange.*``
    counter deltas). Host arithmetic only — a flow point never reads the
    device."""
    return {"wire": str(wire), "tokens": int(tokens),
            "bytes_bound": pull_wire_bytes(cfg, int(tokens))
            + push_wire_bytes(cfg, int(tokens), wire)}


def pull_wire_bytes(cfg: EmbeddingConfig, lanes: int) -> int:
    """A2a bytes for `lanes` pull lanes: the index plane out plus the
    value payload back (quantized tables cross embedx at their storage
    width plus the fixed f32 head — the routed_lookup quant path)."""
    if cfg.storage != "f32":
        qbytes = 1 if cfg.storage == "int8" else 2
        return lanes * (4 + 4 * (cfg.fixed_cols + 1)
                        + qbytes * cfg.total_dim)
    return lanes * (4 + 4 * cfg.pull_width)


# ---------------------------------------------------------------------------
# plan-keyed dedup: the host counting sort replaces the device sort
# ---------------------------------------------------------------------------

def plan_dedup_indices(plan: sharded.DedupPlan
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(uniq, inverse) from a host dedup plan — the sort-free form of
    ``sharded.dedup_tokens``. ``uniq``: the unique rows ascending, padded
    with ascending out-of-range ids (never routed). ``inverse``: each
    token's unique lane (sorted position i belongs to the first segment
    whose end is past i)."""
    order, uniq, segend = plan.order, plan.uniq, plan.segend
    n = order.shape[0]
    seg_sorted = torch.searchsorted(
        segend.long(), torch.arange(n, device=order.device), right=True)
    seg_sorted = seg_sorted.clamp(max=n - 1)
    inverse = torch.empty(n, dtype=torch.int64, device=order.device)
    inverse[order.long()] = seg_sorted
    return uniq, inverse


# ---------------------------------------------------------------------------
# pull
# ---------------------------------------------------------------------------

def routed_pull(table_shard, idx: torch.Tensor, cfg: EmbeddingConfig,
                mesh, axes, capacity_factor: float = 2.0, plan=None,
                dedup: bool = False, return_dropped: bool = False):
    """Plan-keyed distributed gather: each unique row crosses the wire
    once; tokens re-expand from the returned lanes. Without a dedup plan
    this is ``sharded.routed_lookup`` (device dedup per ``dedup``: the
    eval path packs no plan)."""
    D = mesh.axis_size(axes)
    if D == 1:
        out = sharded.lookup(table_shard, idx, cfg)
        zero = torch.zeros((), dtype=torch.int64, device=idx.device)
        return (out, zero) if return_dropped else out
    if not isinstance(plan, sharded.DedupPlan):
        return sharded.routed_lookup(table_shard, idx, cfg, mesh, axes,
                                     capacity_factor, dedup=dedup,
                                     return_dropped=return_dropped)
    uniq, inverse = plan_dedup_indices(plan)
    rows, dropped = sharded.routed_lookup(table_shard, uniq, cfg, mesh,
                                          axes, capacity_factor,
                                          return_dropped=True)
    out = rows.index_select(0, inverse)
    return (out, dropped) if return_dropped else out


def routed_pull_pooled(table_shard, idx: torch.Tensor, cfg: EmbeddingConfig,
                       mesh, axes, num_slots: int, slot_len: int,
                       capacity_factor: float = 2.0, plan=None,
                       return_dropped: bool = False):
    """(B, S*L) indices → (B, S, pull_width): the fused gather-pool pull
    on the mesh. The unique rows route once (plan-keyed when a plan rides
    the batch, device dedup otherwise), land in a local (lanes,
    pull_width) table, and ``gather_pool`` pools per (example, slot) from
    that table. Masked tokens point at the null row's lane, whose routed
    value is the zero row, so padding adds zeros exactly as on one
    shard."""
    B = idx.shape[0]
    D = mesh.axis_size(axes)
    if D == 1:
        out = sharded.fused_pull_pool(table_shard, idx, cfg, num_slots,
                                      slot_len)
        zero = torch.zeros((), dtype=torch.int64, device=idx.device)
        return (out, zero) if return_dropped else out
    if isinstance(plan, sharded.DedupPlan):
        uniq, inverse = plan_dedup_indices(plan)
    else:
        uniq, inverse = dedup_tokens(idx.reshape(-1))
    rows, dropped = sharded.routed_lookup(table_shard, uniq, cfg, mesh,
                                          axes, capacity_factor,
                                          return_dropped=True)
    lane_idx = inverse.to(torch.int32).reshape(B, num_slots * slot_len)
    pooled = kernels.gather_pool(rows.contiguous(), lane_idx.contiguous(),
                                 cfg, num_slots, slot_len)
    return (pooled, dropped) if return_dropped else pooled


# ---------------------------------------------------------------------------
# push (wire-compressed)
# ---------------------------------------------------------------------------

def _compress_push(send_pay: torch.Tensor, gw: int, wire: str) -> tuple:
    """(D, cap, gw+k) f32 payload → wire planes. Grad columns compress;
    the show/clk increments (exact small counts), any touch count and the
    int8 scale stay in an f32 side plane — counters never round."""
    if wire == "f32":
        return (send_pay,)
    g, side = send_pay[..., :gw], send_pay[..., gw:]
    if wire == "bf16":
        return (g.to(torch.bfloat16), side.contiguous())
    q, scale = quant.quantize_lanes(g, "int8")
    return (q, torch.cat([side, scale[..., None]], dim=-1))


def _decompress_push(planes: tuple, wire: str) -> torch.Tensor:
    if wire == "f32":
        return planes[0]
    g, side = planes
    if wire == "bf16":
        return torch.cat([g.to(torch.float32), side], dim=-1)
    x = quant.dequantize_lanes(g, side[..., -1])
    return torch.cat([x, side[..., :-1]], dim=-1)


def _exchange_push(send_pay: torch.Tensor, gw: int, wire: str, mesh,
                   axes) -> torch.Tensor:
    """The push payload's all-to-all in ``wire`` format, decompressed."""
    recv = tuple(mesh.all_to_all(p.contiguous(), axes)
                 for p in _compress_push(send_pay, gw, wire))
    return _decompress_push(recv, wire)


def _scatter_engine(table_shard, cfg: EmbeddingConfig, rps: int) -> bool:
    f32 = not quant.is_quant(table_shard)
    dev = (table_shard.device if f32 else table_shard.fp.device).type
    return kernels.resolve_push_engine(
        cfg, rps, premerged=True, device_type=dev,
        table_width=table_shard.shape[1] if f32 else None) \
        == "scatter_accumulate"


def _apply_received(table_shard, local_row: torch.Tensor,
                    flat_pay: torch.Tensor, touched: torch.Tensor,
                    cfg: EmbeddingConfig, rps: int, runs: int) -> str:
    """The exchange's apply tail on the owner shard: ``runs`` row-wise
    ascending received runs of local rows (flattened; the out-of-range
    ``rps`` on empty lanes) with (gw+2) payloads and each lane's count of
    real contributions ``touched``. Under the fused engine the
    cross-source merge onto one lane per unique row is a D-way merge of
    the runs (``merge_sorted_runs``; unmerged input keeps the sort
    dedup), then ``scatter_accumulate`` updates exactly those rows; empty
    lanes and merge pads carry a zero touch count and never write.
    Otherwise ``sharded.push``. Returns the engine that ran."""
    gw = cfg.grad_width
    if _scatter_engine(table_shard, cfg, rps):
        if runs > 0:
            uniq, inverse = merge_sorted_runs(local_row.reshape(runs, -1))
        else:
            uniq, inverse = dedup_tokens(local_row)
        payload = torch.cat([flat_pay, touched[:, None]], dim=1)
        merged = payload.new_zeros((local_row.shape[0], gw + 3)
                                   ).index_add_(0, inverse, payload)
        kernels.scatter_accumulate(
            table_shard, uniq.to(torch.int32).contiguous(),
            merged[:, :gw].contiguous(), merged[:, gw].contiguous(),
            merged[:, gw + 1].contiguous(), cfg,
            touched=merged[:, gw + 2].contiguous())
        return "scatter_accumulate"
    return sharded.push(table_shard, local_row, flat_pay[:, :gw],
                        flat_pay[:, gw], flat_pay[:, gw + 1], cfg)


def routed_push(table_shard, idx: torch.Tensor, grads: torch.Tensor,
                shows: torch.Tensor, clks: torch.Tensor,
                cfg: EmbeddingConfig, mesh, axes,
                capacity_factor: float = 2.0, wire: str = "f32",
                plan=None, premerged: bool = False,
                topology: str = "flat") -> str:
    """Distributed merge-update with a premerged, wire-compressed payload
    (the reverse of ``routed_pull``), in place on this rank's shard;
    returns the engine the owner ran.

    With a dedup plan (or ``premerged`` lanes from a deferred apply, in
    the plan's ascending unique order) per-token payloads merge onto one
    lane per unique row before routing, so each row crosses once per
    source. The grad plane crosses in ``wire`` format; the owner merges
    the sources' lanes and applies the optimizer as one shard does.
    ``topology`` "hier" runs the two-stage decomposition; ``axes`` must
    then be the (node, dp) pair."""
    D = mesh.axis_size(axes)
    if D == 1:
        if premerged:
            return sharded._merge_update(table_shard, idx, grads, shows,
                                         clks, cfg, premerged=True,
                                         windows=None)
        return sharded.push(table_shard, idx, grads, shows, clks, cfg,
                            plan=plan)
    merged_input = premerged
    if not premerged and isinstance(plan, sharded.DedupPlan):
        idx, grads, shows, clks = sharded.plan_premerge(idx, grads, shows,
                                                        clks, plan)
        merged_input = True
    if topology == "hier":
        return _routed_push_hier(table_shard, idx, grads, shows, clks, cfg,
                                 mesh, axes, capacity_factor, wire,
                                 merged=merged_input)
    n = idx.shape[0]
    rps = quant.table_rows(table_shard)
    cap = _capacity(n, D, capacity_factor)
    gw = cfg.grad_width
    order, sowner, pos, valid, send_idx = _route(idx, rps, D, cap)
    payload = torch.cat([grads, shows[:, None], clks[:, None]],
                        dim=1).index_select(0, order)
    send_pay = _scatter_lanes(payload, sowner, pos, valid, D, cap)
    flat_idx = mesh.all_to_all(send_idx, axes).reshape(-1)
    flat_pay = _exchange_push(send_pay, gw, wire, mesh, axes
                              ).reshape(-1, gw + 2)
    empty = flat_idx < 0
    local_row = torch.where(empty, rps, flat_idx % rps).to(torch.int32)
    flat_pay = torch.where(empty[:, None], 0.0, flat_pay)
    # the D-way merge needs ascending runs: a merged source order (the
    # plan's unique rows ascend; token-order input does not)
    return _apply_received(table_shard, local_row, flat_pay,
                           (~empty).to(flat_pay.dtype), cfg, rps,
                           runs=D if merged_input else 0)


def _routed_push_hier(table_shard, idx: torch.Tensor, grads: torch.Tensor,
                      shows: torch.Tensor, clks: torch.Tensor,
                      cfg: EmbeddingConfig, mesh, axes,
                      capacity_factor: float, wire: str,
                      merged: bool) -> str:
    """Two-stage push on a (node, dp) mesh:

    1. an intra-node shuffle over dp, f32: tokens go to the node-local
       rank whose dp slot owns their column of the shard grid;
    2. a node merge: the P received ascending runs merge onto one lane
       per unique global row, summing payloads and real counts, so a row
       every local rank touched crosses the inter-node wire once;
    3. the inter-node exchange over node, wire-compressed (touch counts
       ride the f32 side plane with show/clk).

    Capacities are sized so hier drops nothing flat would not (stage 1
    holds H flat groups a slot, stage 2 P a node); on the f32 wire the
    per-row sums are the flat exchange's contributions in its merged
    order — bit-identical."""
    axes = tuple(axes) if not isinstance(axes, str) else (axes,)
    if len(axes) != 2:
        raise ValueError(
            "exchange_topology='hier' needs the (node, dp) axis pair; "
            f"got axes={axes!r}")
    node_ax, dp_ax = axes
    H = mesh.axis_size(node_ax)
    P = mesh.axis_size(dp_ax)
    D = H * P
    gw = cfg.grad_width
    rps = quant.table_rows(table_shard)
    if not merged:
        # no host plan: merge on the device first, so the stage-1 runs
        # ascend and each row leaves a rank once
        uniq0, inv0 = dedup_tokens(idx)
        payload = torch.cat([grads, shows[:, None], clks[:, None]], dim=1)
        m0 = payload.new_zeros((uniq0.shape[0], gw + 2)).index_add_(
            0, inv0, payload)
        idx, grads, shows, clks = uniq0, m0[:, :gw], m0[:, gw], m0[:, gw + 1]
    n = idx.shape[0]
    flat_cap = _capacity(n, D, capacity_factor)
    # stage 1: route by the owner shard's dp slot. NULL tokens and the
    # plan's out-of-range pads go to the drop group (the slot modulus
    # would wrap pads into real groups)
    cap1 = min(n, H * flat_cap)
    drop1 = (idx == sharded.NULL_INDEX) | (idx >= rps * D)
    owner1 = torch.where(drop1, P, torch.div(
        idx, rps, rounding_mode="floor") % P).long()
    order1, sown1, pos1, valid1, send_idx1 = _route_owner(idx, owner1, P,
                                                          cap1)
    payload = torch.cat([grads, shows[:, None], clks[:, None]],
                        dim=1).index_select(0, order1)
    send_pay1 = _scatter_lanes(payload, sown1, pos1, valid1, P, cap1)
    recv_idx1 = mesh.all_to_all(send_idx1, dp_ax)
    recv_pay1 = mesh.all_to_all(send_pay1, dp_ax)
    # node merge: P ascending runs of global rows → unique lanes
    flat1 = recv_idx1.reshape(-1)
    empty1 = flat1 < 0
    sentinel = rps * D                        # > every valid global row
    midx = torch.where(empty1, sentinel, flat1)
    uniq1, inverse1 = merge_sorted_runs(midx.reshape(P, cap1))
    real1 = (~empty1).to(recv_pay1.dtype)
    pay1 = torch.where(empty1[:, None], 0.0,
                       recv_pay1.reshape(-1, gw + 2))
    merged1 = pay1.new_zeros((uniq1.shape[0], gw + 3)).index_add_(
        0, inverse1, torch.cat([pay1, real1[:, None]], dim=1))
    # stage 2: route merged uniques by owner node. The sentinel lane and
    # the merge's tail pads carry a zero touch count: both drop (a padded
    # row 0 would reach shard 0 and decay an untouched row's state)
    drop2 = merged1[:, gw + 2] <= 0.0
    owner2 = torch.where(drop2, H, torch.div(
        uniq1, rps * P, rounding_mode="floor")).long()
    cap2 = P * flat_cap
    order2, sown2, pos2, valid2, send_idx2 = _route_owner(uniq1, owner2, H,
                                                          cap2)
    send_pay2 = _scatter_lanes(merged1.index_select(0, order2), sown2,
                               pos2, valid2, H, cap2)
    recv_idx2 = mesh.all_to_all(send_idx2, node_ax)
    recv_pay2 = _exchange_push(send_pay2, gw, wire, mesh, node_ax)
    # apply: every arriving row is this shard's; H ascending runs of
    # local rows merge through the same tail
    flat2 = recv_idx2.reshape(-1)
    empty2 = flat2 < 0
    local_row = torch.where(empty2, rps, flat2 % rps).to(torch.int32)
    pay2 = torch.where(empty2[:, None], 0.0,
                       recv_pay2.reshape(-1, gw + 3))
    return _apply_received(table_shard, local_row, pay2[:, :gw + 2],
                           pay2[:, gw + 2], cfg, rps, runs=H)
