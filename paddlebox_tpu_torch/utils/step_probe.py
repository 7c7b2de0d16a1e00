"""Per-stage device-time attribution of the train step, and the sparse
push's analytic floor — the port of ``paddlebox_tpu/utils/step_probe.py``.

The reference prints a read/trans/cal/sync split per pass
(``log_for_profile``, boxps_worker.cc:746-759); this module is the
device-side account of one step: ``lookup``, ``dense_fwd_bwd``,
``sparse_push`` and the ``dispatch_floor`` (a no-op step with the same
arguments), as device seconds, by telescoping ablation of the step
(``Trainer.train_step(ablate=...)``). :func:`push_floor_analysis` states
what the push should cost on this card — the bytes the port's CUDA
kernels must move over the card's memory rate — and whether the measured
push closes against it (the doctor's push-floor rule reads that
statement).

Measurement discipline: the port's step is eager, a few hundred kernel
launches from Python, so a host clock would time the dispatch. Every
stage is timed as device work with CUDA events behind a device-side
sleep (:func:`time_ms`): the sleep holds the card while the host queues
the calls, so the events see the kernels back to back. That is the
port's stand-in for the reference's ``lax.optimization_barrier`` chain:
eager ops can be neither hoisted nor dead-coded, so no chaining is
needed. CUDA keeps only so many launches pending (about a thousand); a
step is 264 (one-hot) to 296 (multi-hot) launches, so a window holds
``k`` = 1 step (several would let the queue drain and the host's
dispatch pace the card again) and :func:`timed_repeat` repeats windows,
keeping the fastest. A window the queue drained anyway falls back to
fewer calls (``time_ms``). On the CPU the same functions time host
wall clock (the tests' small shapes), and the peaks are unknown, so the
floor's closure abstains.

The card's numbers live here once: :data:`HBM_BYTES_PER_S`,
:data:`FP32_OPS_PER_S` and :data:`SECTOR` (``chip_smoke.py`` computes
its kernels' bounds from them), and :data:`PEAKS`, keyed by
``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                    # H100 SXM, f32 (non-tensor)
SECTOR = 32                               # bytes the memory system moves
                                          # at the least (one L2 sector)

# (peak f32 op/s, peak memory bytes/s) by device name; a card missing
# here (or the CPU) has no peaks, and the floor's closure abstains
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (FP32_OPS_PER_S, HBM_BYTES_PER_S),
}


def device_peaks(device=None) -> tuple[float, float] | None:
    """The peak table's entry for ``device`` (default: the current CUDA
    card), or None on the CPU or a card the table does not hold."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type != "cuda":
        return None
    return PEAKS.get(torch.cuda.get_device_name(dev))


def time_ms(fn: Callable, iters: int = 20, warmup: int = 3,
            device=None) -> float:
    """Mean device ms per call over ``iters`` calls between CUDA events.

    The calls are queued behind a device-side sleep longer than their
    host dispatch, so the events time the device's work and not the
    wrappers' Python overhead (a 0.03 ms kernel behind a 0.1 ms wrapper
    would otherwise read 0.1 ms). If the device catches up with the queue
    anyway, because the calls hold more launches than CUDA keeps
    pending, the count drops to a quarter and the timing repeats; a
    function that waits for the device itself (a boolean-mask index does)
    is timed with its waits, and a line says so. With ``device`` on the
    CPU (or no card) it is the mean host wall time of the calls."""
    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t) / max(1, warmup)
    if not on_card:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) / iters * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    while True:
        torch.cuda.synchronize()
        # 2e9 cycles/s is at least the SM clock: the sleep is no shorter
        torch.cuda._sleep(int((2 * iters * host_s + 0.005) * 2e9))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        drained = t0.query()     # the device reached t0 before the host
        torch.cuda.synchronize()  # had queued every call
        ms = t0.elapsed_time(t1) / iters
        if not drained:
            return ms
        if iters == 1:
            print(f"  ({ms:.4f} ms includes host waits: the function "
                  f"waits for the device)")
            return ms
        iters = max(1, iters // 4)


def timed_repeat(fn: Callable, args: tuple = (), k: int = 1,
                 windows: int = 6, device=None,
                 calls: dict | None = None, name: str = "") -> float:
    """Device seconds per ``fn(*args)`` call: the fastest of ``windows``
    :func:`time_ms` windows of ``k`` calls each (k small enough that a
    step's launches stay pending). ``calls[name]`` accumulates the calls
    made, warm-ups included: the launch accounting of a probe (a stage
    launches each of its kernels once a call)."""
    n = [0]

    def counted():
        n[0] += 1
        return fn(*args)

    best = min(time_ms(counted, iters=k, warmup=1, device=device)
               for _ in range(max(1, windows)))
    if calls is not None:
        calls[name] = calls.get(name, 0) + n[0]
    return best / 1e3


def measure_step_floor(trainer, staged, k: int = 1, windows: int = 6,
                       calls: dict | None = None) -> float:
    """The per-step floor: a no-op step taking the train step's staged
    arguments (one reduction over the labels, so the call reaches the
    device), timed like the step. On the card it is the launch of one
    tiny kernel; the host's dispatch cost lives in the step loop's wall,
    not here."""
    labels = staged[3]

    def noop():
        return labels.sum() * 0.0

    return timed_repeat(noop, k=k, windows=windows, device=trainer.device,
                        calls=calls, name="floor")


def _step_fn(trainer, table, staged, ablate: tuple = ()):
    idx, mask, dense, labels, plan, extras = staged

    def step():
        return trainer.train_step(table, idx, mask, dense, labels, plan,
                                  extras, ablate=ablate)
    return step


def attribute_step(trainer, ws, staged, step_seconds: float,
                   k: int = 1, windows: int = 6) -> dict:
    """Stage breakdown of one train step, as device seconds.

    Primary account — **telescoping cumulative ablation**: the same step
    with successively more stages replaced by shape-preserving stand-ins
    (``Trainer.train_step(ablate=...)``: full -> -push -> -push-lookup
    -> -push-lookup-fwdbwd), each timed as device work, then the no-op
    floor. Successive differences sum exactly to the full step, so
    coverage is ~100% by construction; a stage's delta is its marginal
    cost given the stages removed before it. ``glue_residual`` is what
    the emptied step still costs above the no-op ``dispatch_floor`` (the
    zero grads, the dense optimizer). ``isolated`` times each stage's own
    function alone, and, for a model with an ``interaction`` (and its
    ``interaction_input``), that interaction's forward and backward alone
    (``isolated["interaction"]``).

    Under push overlap (``trainer.push_overlap``) ``overlap_ab`` times
    the inline step against the deferred pair (the pending apply, then
    the step that stages its own push: the training loop's dataflow) and
    the deferred loss path alone.

    The probe trains: the steps it times update ``ws.table`` and the
    dense params as training steps do (the ablated ones partly). Run it
    on a working set whose state is not needed afterwards.

    trainer : a Trainer on one shard ("allreduce" dense sync)
    ws      : the PassWorkingSet whose table the step trains
    staged  : one staged batch, ``trainer.stage(trainer.pack_arrays(...))``
    step_seconds : the step loop's wall seconds a step (the headline);
        ``unattributed_seconds`` is that minus the device account — the
        host's share of the step loop.
    """
    from paddlebox_tpu_torch.embedding import sharded
    from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots

    assert trainer.cfg.dense_sync_mode == "allreduce", (
        "stage attribution instruments the allreduce step")
    assert trainer.n_shards == 1, "stage attribution runs on one shard"
    dev = trainer.device
    calls: dict[str, int] = {}
    table = ws.table
    times = []
    for abl in ((), ("push",), ("push", "lookup"),
                ("push", "lookup", "fwdbwd")):
        name = "step" if not abl else "ablate_" + "_".join(abl)
        times.append(timed_repeat(_step_fn(trainer, table, staged, abl),
                                  k=k, windows=windows, device=dev,
                                  calls=calls, name=name))
    floor = measure_step_floor(trainer, staged, k=k, windows=windows,
                               calls=calls)
    stages = {
        "sparse_push": times[0] - times[1],
        "lookup": times[1] - times[2],
        "dense_fwd_bwd": times[2] - times[3],
        "glue_residual": times[3] - floor,
        "dispatch_floor": floor,
    }

    idx, mask, dense, labels, plan, extras = staged
    overlap_ab = None
    if trainer.push_overlap:
        stager = trainer._push_stager

        def pair():
            trainer._dispatch_pending_apply(table)
            trainer.train_step(table, idx, mask, dense, labels, plan,
                               extras, defer=True)

        def loss_path():
            trainer.train_step(table, idx, mask, dense, labels, plan,
                               extras, defer=True)
            stager.take()                 # dropped: the loss path alone

        applies0 = trainer.push_applies
        try:
            t_pair = timed_repeat(pair, k=k, windows=windows, device=dev,
                                  calls=calls, name="overlap_pair")
            trainer._dispatch_pending_apply(table)
            t_loss = timed_repeat(loss_path, k=k, windows=windows,
                                  device=dev, calls=calls,
                                  name="overlap_loss_path")
        finally:
            trainer._dispatch_pending_apply(table)
            stager.clear()
        calls["overlap_applies"] = trainer.push_applies - applies0
        overlap_ab = {
            "inline_single_step": round(times[0], 6),
            "deferred_step_plus_apply": round(t_pair, 6),
            "deferred_loss_path_step": round(t_loss, 6),
            "note": "pair = the pending apply then the step staging its "
                    "own push (the training loop's dataflow, one stream); "
                    "loss_path = the deferred step alone — what the "
                    "AUC/D2H consumer waits on when the apply overlaps "
                    "the next pack",
        }

    # --- isolated stage times (secondary: each stage's function alone)
    emb_cfg = trainer.store.cfg
    lay = trainer.layout
    S, T = lay.num_slots, lay.total_len
    B = idx.shape[0]
    model = trainer.model
    seg = lay.segment_ids
    fused = trainer.pull_engine == "fused_gather_pool"
    maskf = mask.to(torch.float32)
    shows0 = maskf.reshape(-1)
    clks0 = (maskf * labels[:, None]).reshape(-1)
    flat_idx = idx.reshape(-1)

    if fused:
        def lookup_fn():
            return sharded.fused_pull_pool(table, idx, emb_cfg, S, T // S)
    else:
        def lookup_fn():
            return sharded.lookup(table, idx, emb_cfg)
    isolated = {"lookup": timed_repeat(lookup_fn, k=k, windows=windows,
                                       device=dev, calls=calls,
                                       name="isolated_lookup")}
    pulled0 = lookup_fn()
    calls["isolated_lookup"] += 1

    def fwdbwd():
        p = pulled0.detach().requires_grad_()
        logits = model(PooledSlots(p) if fused else p, mask, dense, seg, S,
                       *extras)
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        return torch.autograd.grad(loss, [*trainer.params, p],
                                   allow_unused=True)[-1]

    isolated["dense_fwd_bwd"] = timed_repeat(fwdbwd, k=k, windows=windows,
                                             device=dev, calls=calls,
                                             name="isolated_fwd_bwd")
    if callable(getattr(model, "interaction", None)):
        # the model's interaction alone (DLRM-DCNv2's cross network),
        # forward and backward (its input's gradient and its weights'), on
        # this batch's pooled inputs
        with torch.no_grad():
            x0 = model.interaction_input(
                PooledSlots(pulled0) if fused else pulled0, mask, dense, seg)
        x0.requires_grad_()
        gy = torch.ones_like(x0)

        def interaction_fn():
            return torch.autograd.grad(model.interaction(x0),
                                       [x0, *trainer.params], gy,
                                       allow_unused=True)[0]

        isolated["interaction"] = timed_repeat(
            interaction_fn, k=k, windows=windows, device=dev, calls=calls,
            name="isolated_interaction")
    gpulled0 = fwdbwd()
    if fused:
        sgrad0 = sharded.pooled_grad_tokens(gpulled0, mask, trainer._seg, S)
    else:
        sgrad0 = gpulled0[..., 2:].reshape(B * T, emb_cfg.grad_width)

    def push_fn():
        return sharded.push(table, flat_idx, sgrad0, shows0, clks0,
                            emb_cfg, plan=plan)

    isolated["sparse_push"] = timed_repeat(push_fn, k=k, windows=windows,
                                           device=dev, calls=calls,
                                           name="isolated_push")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    attributed = float(sum(stages.values()))
    single = times[0]
    return {
        "stages": {n: round(s, 6) for n, s in stages.items()},
        "isolated": {n: round(s, 6) for n, s in isolated.items()},
        "push_overlap": "on" if trainer.push_overlap else "off",
        "overlap_ab": overlap_ab,
        "attributed_seconds": round(attributed, 6),
        "single_step_seconds": round(single, 6),
        "headline_step_seconds": round(step_seconds, 6),
        "unattributed_seconds": round(step_seconds - attributed, 6),
        "coverage": round(attributed / single, 3) if single else 0.0,
        "calls": calls,
        "method_overlap": "overlap_ab (when push_overlap is on) A/Bs the "
                          "inline step against the deferred apply+step "
                          "pair and the deferred loss path alone",
        "method": "stages = telescoping cumulative ablation of the "
                  "single step (full -> -push -> -push-lookup -> "
                  "-push-lookup-fwdbwd -> no-op floor), each the fastest "
                  "of several windows of k steps timed as device work "
                  "with CUDA events behind a device-side sleep; the "
                  "differences sum to the single step. "
                  "headline_step_seconds is the step loop's wall a step "
                  "(host dispatch and the pack included), so "
                  "unattributed_seconds = headline - device account is "
                  "the host's share. isolated = each stage's function "
                  "alone; calls = the calls each timing made, warm-ups "
                  "included (the launch accounting)",
    }


# ---------------------------------------------------------------------------
# Sparse-push floor analysis: what the push SHOULD cost on this card.
#
# The stage attribution says what the push DOES cost; this derives the
# analytic floor of each push engine from the bytes the port's CUDA
# kernels must move (the pushes are memory-bound: a few flops a byte), so
# a regression alarms against a floor, not only against the card's
# headline peaks. Stage keys are the reference's: plan_h2d (the host plan,
# staged by the pack thread — off the step's critical path, excluded from
# the floor), kernel_dma (the engine's kernel or scatter bytes),
# onehot_dots (the TPU's matrix-unit merge: the port's kernels have none,
# kept with 0 operations) and fused_update (the table pass).
# ---------------------------------------------------------------------------

_ONEHOT_NOTE = ("no one-hot matrix merge on the card: binned_merge_acc "
                "merges duplicate rows with a warp sort and shared-memory "
                "atomics, scatter_accumulate and index_add_ update rows "
                "directly — 0 operations (the key stays for the "
                "reference's statement shape)")


def _union_sector_bytes(n_rows: int, stride: int, parts) -> float:
    """Expected bytes, in whole 32-byte sectors, that an access pattern
    over an array of ``n_rows`` rows ``stride`` bytes apart moves: each
    part ``(offset, length, prob)`` is a byte range of every row, read
    with probability ``prob`` independently per row; a sector moves once
    however many ranges touch it. Exact under those assumptions: the
    row/sector overlap repeats every lcm(stride, 32) bytes."""
    period = stride * SECTOR // math.gcd(stride, SECTOR)
    rows = period // stride
    miss = [1.0] * (period // SECTOR)
    for r in range(rows):
        for off, length, prob in parts:
            if length <= 0 or prob <= 0:
                continue
            a = r * stride + off
            for sct in range(a // SECTOR, (a + length - 1) // SECTOR + 1):
                miss[sct] *= 1.0 - prob
    return sum(1.0 - m for m in miss) * SECTOR * n_rows / rows


def push_floor_analysis(emb_cfg, n_rows: int, tokens: int,
                        n_split: int = 2, peaks=None,
                        measured_push: float | None = None,
                        slack: float = 3.0, premerged: bool = False,
                        table_width: int | None = None,
                        unique_lanes: int | None = None,
                        device_type: str = "cuda") -> dict:
    """Per-stage analytic bounds of one sparse push + closure statements.

    peaks : (peak f32 op/s, peak memory bytes/s) — :func:`device_peaks`
            — or None (unknown hardware: bounds are reported as bytes
            only, closure abstains).
    measured_push : the attribution's sparse_push seconds, if available.
    premerged / table_width : the lane contract and physical table width
            the engine resolver keys on, so ``engine`` names the code
            path the step runs (``kernels.resolve_push_engine`` with
            ``device_type``).
    unique_lanes : rows the push touches (defaults to ``tokens``, an
            upper bound): scatter_accumulate's bytes and merge_update's
            row pass scale with it.
    n_split : the reference's f32 split planes of its matrix merge; the
            port sums in f32 and ignores it.
    closed : True when the measured push sits within ``slack`` x the
            active engine's floor; otherwise a reason string naming the
            gap — the alarm line. ``engines`` carries the same statement
            per candidate engine, and ``best_engine`` names the
            lowest-floor one (the doctor's push-floor rule suggests
            forcing it with ``flags.push_engine``).

    The bytes, per engine (4-byte words; rw the logical row width, W the
    physical one, gw the grad width; a row access is counted in whole
    32-byte sectors, the least the memory system moves, with the
    ``unique_lanes`` touched rows spread uniformly over the table —
    :func:`_union_sector_bytes`):
    - binned_kernel: binned_merge_acc reads each token's id, order entry,
      show, clk and gw grads and writes the whole (n_rows, gw + 3)
      accumulator; merge_update reads every row's count and the touched
      rows' other accumulator columns, and reads and writes the touched
      table rows;
    - scatter_accumulate: the touched table rows read and written at
      their W-column stride, each lane's id, gw grads, show and clk read;
    - xla_scatter: ``index_add_`` of the tokens' ids and gw + 3 payload
      words into a zero-filled accumulator, then merge_update's pass.
    """
    from paddlebox_tpu_torch.config import flags as config_flags
    from paddlebox_tpu_torch.ops import kernels

    f32 = emb_cfg.storage == "f32"
    width = int(table_width) if table_width is not None \
        else emb_cfg.row_width
    engine = kernels.resolve_push_engine(emb_cfg, n_rows,
                                         premerged=premerged,
                                         device_type=device_type,
                                         table_width=width)
    gw = emb_cfg.grad_width
    rw = emb_cfg.row_width
    P = gw + 3
    lanes = int(unique_lanes) if unique_lanes is not None else tokens
    peak_f, peak_b = peaks if peaks is not None else (None, None)

    def _bw_stage(nbytes, note):
        return {"bytes": int(nbytes),
                "bound_seconds": (round(nbytes / peak_b, 9)
                                  if peak_b else None),
                "note": note}

    def _dots():
        return {"flops": 0.0, "bound_seconds": 0.0 if peak_b else None,
                "note": _ONEHOT_NOTE}

    touched = min(1.0, lanes / max(1, n_rows))
    # the touched rows read and written at the table's physical stride
    row_rw = 2 * _union_sector_bytes(n_rows, width * 4,
                                     [(0, rw * 4, touched)])

    def _update_pass(note):
        acc = _union_sector_bytes(n_rows, P * 4, [((gw + 2) * 4, 4, 1.0),
                                                  (0, (gw + 2) * 4,
                                                   touched)])
        return _bw_stage(acc + row_rw, note)

    def _engine_stages(name):
        """The three floor stages (constant keys across engines) of one
        candidate engine at this geometry, or None when the engine
        cannot engage here."""
        st: dict = {}
        if name == "binned_kernel":
            geom = kernels.binned_geometry(emb_cfg, n_rows)
            if geom is None or (f32 and width > kernels.SA_MAX_WIDTH):
                return None
            sb, nb = geom
            st["kernel_dma"] = _bw_stage(
                tokens * (4 * 4 + gw * 4) + 2 * nb * 4 + n_rows * P * 4,
                f"binned_merge_acc: {tokens} tokens' ids, order, show, "
                f"clk and {gw} grads read, the ({n_rows}, {P}) "
                f"accumulator written ({nb} blocks of {sb} rows)")
            st["onehot_dots"] = _dots()
            st["fused_update"] = _update_pass(
                f"merge_update: every row's count read, {lanes} touched "
                f"rows' accumulator read and table rows read + written")
            return st
        if name == "scatter_accumulate":
            if not f32 or not kernels.scatter_accumulate_supported(
                    n_rows, width):
                return None
            st["kernel_dma"] = _bw_stage(
                row_rw + lanes * (gw + 3) * 4,
                f"scatter_accumulate: each lane's row read + written at "
                f"the physical width ({width} columns) + its id and "
                f"payload — {lanes} lanes, O(unique rows), no full-table "
                f"term")
            st["onehot_dots"] = _dots()
            st["fused_update"] = _bw_stage(
                0, "the optimizer runs in-kernel on the gathered rows — "
                   "no table pass")
            return st
        st["kernel_dma"] = _bw_stage(
            n_rows * P * 4 + tokens * (P * 4 + 4),
            "index_add_: the accumulator zero-filled, each token's id "
            "and payload read")
        st["onehot_dots"] = _dots()
        st["fused_update"] = _update_pass(
            "merge_update's pass over the scattered accumulator")
        return st

    def _floor_of(st):
        bounded = [s["bound_seconds"] for s in st.values()]
        return (round(sum(b for b in bounded if b is not None), 9)
                if any(b is not None for b in bounded) else None)

    stages = _engine_stages(engine)
    assert stages is not None, engine   # the resolver names engageable ones
    stages = {"plan_h2d": {
        "bytes": tokens * 4 * 3 + 1024,
        "bound_seconds": None,
        "note": "host plan staged by the pack thread, overlapped with "
                "device compute — off the step's critical path; counted "
                "for completeness, excluded from the floor",
    }, **stages}
    engines: dict = {}
    for name in kernels.PUSH_ENGINES:
        st = _engine_stages(name)
        if st is None:
            continue
        e = {"floor_seconds": _floor_of(st)}
        if name == "scatter_accumulate" and not premerged:
            e["note"] = ("requires premerged unique lanes "
                         "(flags.push_dedup_premerge)")
        if name == "binned_kernel" and not config_flags.binned_push:
            # auto skips it while the enable knob is off; a forced
            # flags.push_engine="binned_kernel" bypasses the knob
            e["note"] = ("flags.binned_push is off — engages only when "
                         "forced")
        engines[name] = e
    out = {
        "engine": engine,
        "premerged": bool(premerged),
        "tokens": tokens,
        "unique_lanes": lanes,
        "table_rows": n_rows,
        "stages": stages,
        "floor_seconds": _floor_of(
            {k: v for k, v in stages.items() if k != "plan_h2d"}),
        "engines": engines,
        "measured_push_seconds": (round(measured_push, 6)
                                  if measured_push is not None else None),
    }
    finalize_push_floor(out, measured_push, slack)
    return out


def finalize_push_floor(floor: dict, measured_push: float | None,
                        slack: float = 3.0) -> None:
    """(Re)close a push_floor_analysis result once the attribution has
    measured the real push stage — mutates ``floor`` in place. Closes the
    active engine's statement and the per-candidate-engine statements,
    and names ``best_engine`` — the lowest-floor candidate — so an
    off-floor point suggests a concrete flags.push_engine force."""
    f = floor.get("floor_seconds")
    if measured_push is not None:
        floor["measured_push_seconds"] = round(measured_push, 6)

    def _close(bound, label):
        if bound is None:
            return "no peak table for this hardware (CPU smoke?)"
        if measured_push is None:
            return "no measured push stage (attribution absent)"
        if measured_push <= slack * max(bound, 1e-9):
            return True
        return (f"measured {measured_push*1e3:.2f}ms > {slack:.0f}x "
                f"{label} {bound*1e3:.2f}ms")

    closed = _close(f, "floor")
    floor["closed"] = (closed if closed is True or f is None
                       or measured_push is None else closed +
                       " — push is off its physics; check the push "
                       "engine and plan staging before trusting the "
                       "step")
    engines = floor.get("engines") or {}
    best = None
    for name, e in engines.items():
        e["closed"] = _close(e.get("floor_seconds"),
                             f"{name} floor")
        fs = e.get("floor_seconds")
        if fs is not None and (best is None
                               or fs < engines[best]["floor_seconds"]):
            best = name
    if best is not None:
        floor["best_engine"] = best
