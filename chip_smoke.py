#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddlebox_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Two layouts of bench.py's Criteo DeepFM (26 sparse slots, 13 dense, MLP
400-400-400, adagrad table, adam dense, batch 8192):

- multihot4_dim32: 26 slots x 1..4 ids, dim 32, a 2^20-key table — the
  fused pull (gather_pool) and the premerged push (scatter_accumulate);
- onehot_dim8 (the bench's headline): 26 slots x 1 id, dim 8, a 2^19-key
  table — the plain gather pull and the binned push (binned_merge_acc,
  then merge_update).

Phases, each of which exits non-zero on failure:

1. header — the card (nvidia-smi name, power limit), torch, CUDA, nvcc;
2. build — all four kernels from csrc/ with nvcc (in parallel) and the
   host key index with g++, timed;
3. kernels vs their plain PyTorch versions at each layout's step shapes,
   edge cases included (pads, out-of-range ids, an all-pad batch, row 0
   staying zero, untouched rows bitwise, exact count columns);
4. timing — each kernel, its plain version and (where one exists) one
   PyTorch library call computing the same function, with CUDA events,
   beside the least time the card could take (bound_ms, its bytes
   counted in whole 32-byte sectors); binned_merge_acc also on a hot row
   and on per-slot Zipf keys, with each stream's ratio to the uniform
   (main-path) time; merge_update also at about 1% and 100% touched
   rows;
5. each layout's main path — HostEmbeddingStore, an in-memory SlotDataset
   of 16 x 8192 examples, BoxPS.begin_pass -> Trainer.train_pass ->
   BoxPS.end_pass with every kernel's launch count reset just before and
   read just after, then Trainer.eval_pass on 4 batches and a padded
   tail (counts read around it: multi-hot launches gather_pool once a
   batch), then a breakdown of one step (host pack, device step,
   profiler split); for the one-hot layout also the device step under
   each push engine on pre-staged batches carrying that engine's plan;
6. a small pass of each layout on the card and on the CPU (plain
   versions) must agree;
7. persistence, on the one-hot layout at full width: three passes of 16
   steps through BoxPS.end_pass(checkpointer=PassCheckpointer(base_every
   2)) — a base, a delta, a new chain's base — with every count reset
   just before and read just after the phase; resume of pass 2 into a
   fresh store, trainer and BoxPS must be bit-equal to the live state
   after pass 2 (keys, rows, dense params, adam mu/nu/count, metric
   state, cursor); pass 3 from the resumed state must agree with the
   live pass 3 (LOSS_TOL / TABLE_TOL: the kernels' f32 atomics reorder
   sums); with pass 3's dense.npz truncated, resume must fall back to
   pass 2 with a warning. Prints the seconds and bytes of each save and
   of the resume beside the card's name and power limit;
8. the pass boundary (FeedPassManager, which every train_pass and
   eval_pass above already goes through: resident rows reused, lazy
   write-back), on the one-hot layout at full width: (a) bench.py's
   boundary drill, 5 passes over 2^19-key windows with 90% overlap, a
   table edit, begin_feed_pass of the next window and a pure-eviction
   shrink at each boundary, incremental and full rebuild, whose stores
   must be bit-identical; (b) three checkpointed passes of 16 steps over
   sliding windows through train_pass with preload_keys, without it,
   and with incremental_feed off plus a store mutation between passes
   (the full rebuild), whose stores must agree within TABLE_TOL. Prints
   each boundary's seconds, build/h2d split, fresh/reused/stale/patched
   rows and bytes, each save's flush, the step loop's examples/s and the
   one-hot kernels' launches per pass;
9. ingest, on the one-hot layout at full width: phase 5's records as
   MultiSlot text with ins_id prefixes in 8 files (two gzip), loaded
   four ways — the native parser (which must be the one that parses),
   pipe_command "cat", a MultiSlotDataGenerator script as the pipe
   command over a raw form of one file, and .pbar archives — which must
   pack to byte-identical batches; the Python parser on one file beside
   the native one; merge_by_ins_id(2) dropping a known count; one pass
   from the archives through BoxPS.begin_pass -> train_pass -> end_pass
   (counts reset just before and read just after: binned_merge_acc and
   merge_update 16 each, the others 0) agreeing with phase 5's pass; a
   QueueDataset(num_threads=2) streaming the files into a HeterTrainer
   on the card for one pass; its first 2 batches at prefetch_depth=1 on
   the card and on the CPU agreeing. Prints each load's seconds, MB/s
   and examples/s, the archive's size and write seconds, the parser
   ratio and the HeterTrainer's split (host numbers on the card's
   machine, beside its name and power limit);
10. the model zoo: each of the seven families (dnn_ctr, deepfm,
   wide_deep, dcn_v2, dlrm, mmoe, pv_rank; ZOO's full widths) on each
   layout for one 16-step pass through BoxPS.begin_pass -> train_pass
   -> end_pass on records with page views of 1-3 ads, counts reset just
   before and read just after (16 for the layout's two kernels, 0 for
   the others), printing loss, AUC, step-loop examples/s, profiled
   device ms/step with its largest ops, and host syncs in one step
   (must be 0); DLRM once more in bf16 on the one-hot layout; DeepFM on
   the one-hot layout under each dense optimizer; every family at a
   narrow width for 2 steps on the card and on the CPU, which must
   agree (LOSS_TOL, TABLE_TOL, MLP_TOL); fused_gather_seqpool_cvm at the
   multi-hot step's shapes against the unfused plain path, forward and
   table gradient, one gather_pool launch each; and check_nan_inf
   raising FloatingPointError at the step after a NaN is put into a
   dense parameter.

The last lines are the kernels JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
B, S, DENSE = 8192, 26, 13                # bench.py's Criteo DeepFM
HIDDEN = (400, 400, 400)
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
FP32_OPS_PER_S = 67e12
SECTOR = 32                               # bytes the memory system moves
                                          # at the least (one L2 sector)
GATHER_TOL = dict(rtol=1e-6, atol=1e-6)   # test_gather_pool.py
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)  # test_scatter_accumulate.py
MERGE_TOL = dict(rtol=1e-6, atol=1e-6)    # test_pallas_kernels.py
ACC_TOL = dict(rtol=1e-4, atol=2e-5)      # test_binned_push.py
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/golden_deepfm.py
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)
ZIPF_A = 1.1                              # per-slot key skew of the
                                          # binned_merge_acc skew probe

CSRC = "paddlebox_tpu_torch/csrc/"
TPU = "paddlebox_tpu/ops/pallas_kernels.py:"
SOURCES = {"gather_pool": (CSRC + "gather_pool.cu", TPU + "854"),
           "scatter_accumulate": (CSRC + "scatter_accumulate.cu",
                                  TPU + "1080"),
           "binned_merge_acc": (CSRC + "binned_merge_acc.cu", TPU + "264"),
           "merge_update": (CSRC + "merge_update.cu", TPU + "79")}


@dataclasses.dataclass(frozen=True)
class Layout:
    name: str
    dim: int
    max_len: int
    n_keys: int
    steps: int
    kernels: tuple            # launched once per main-path step
    engine: str               # the push engine auto picks on the card


MULTI = Layout("multihot4_dim32", 32, 4, 1 << 20, 16,
               ("gather_pool", "scatter_accumulate"), "scatter_accumulate")
ONEHOT = Layout("onehot_dim8", 8, 1, 1 << 19, 16,
                ("binned_merge_acc", "merge_update"), "binned_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def assert_close(name, got, want, tol) -> float:
    import torch
    err = max_err(got, want)
    try:
        torch.testing.assert_close(got, want, **tol)
    except AssertionError as e:
        raise SmokeFailure(f"{name}: kernel disagrees with its plain "
                           f"version (max abs err {err:.3g}): {e}") from e
    print(f"  {name}: max abs err {err:.3g} (tolerance rtol "
          f"{tol['rtol']:g} atol {tol['atol']:g}) ok")
    return err


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device ms per call over ``iters`` calls between CUDA events.

    The calls are queued behind a device-side sleep longer than their
    host dispatch, so the events time the device's work and not the
    wrappers' Python overhead (a 0.03 ms kernel behind a 0.1 ms wrapper
    would otherwise read 0.1 ms). If the device catches up with the queue
    anyway, because the calls hold more launches than CUDA keeps
    pending, the count drops to a quarter and the timing repeats; a
    function that waits for the device itself (a boolean-mask index does)
    is timed with its waits, and a line says so."""
    import torch
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t) / warmup   # dispatch + any waits
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


def sector_ids(torch, starts, length: int):
    """The 32-byte sectors that byte ranges [s, s + length) cover, for
    each s in ``starts`` (an int64 tensor of byte offsets)."""
    first = starts // SECTOR
    last = (starts + length - 1) // SECTOR
    span = int((last - first).max()) + 1 if starts.numel() else 1
    ids = first[:, None] + torch.arange(span, device=starts.device)
    return ids[ids <= last[:, None]]


def sector_bytes(torch, *parts) -> int:
    """Bytes in the distinct sectors that (starts, length) parts of one
    array cover: what the memory system must move to touch them once."""
    ids = torch.cat([sector_ids(torch, st, n) for st, n in parts])
    return int(torch.unique(ids).numel()) * SECTOR


def dense_bytes(n_bytes: int) -> int:
    """A contiguous array's bytes in whole sectors."""
    return -(-int(n_bytes) // SECTOR) * SECTOR


def row_starts(torch, rows, stride_floats: int, col: int = 0):
    """Byte offsets of column ``col`` of the given rows of an f32 array
    whose rows are ``stride_floats`` apart."""
    return (rows.long() * stride_floats + col) * 4


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def kernel_row(name, err, ms, plain_ms, n_bytes, n_ops, library_ms,
               note) -> dict:
    b_ms, b_by = bound(n_bytes, n_ops)
    lib = ("no single PyTorch call computes this" if library_ms is None
           else f"library {library_ms:.4f} ms")
    print(f"  timing: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | {lib} "
          f"| bound {b_ms:.4f} ms ({b_by}; {note})")
    src, tpu = SOURCES[name]
    return dict(name=name, route="cuda", source=src, replaces=tpu,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def launch_counts(kernels) -> dict[str, int]:
    return {k: getattr(kernels, k).launches for k in SOURCES}


def reset_counts(kernels) -> None:
    for k in SOURCES:
        getattr(kernels, k).launches = 0


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def header(torch) -> None:
    print(f"card: {smi_line()}")
    nvcc = "not found"
    try:
        from paddlebox_tpu_torch.ops import kernels
        out = subprocess.run([kernels.nvcc_path(), "--version"],
                             capture_output=True, text=True, timeout=60)
        nvcc = out.stdout.strip().splitlines()[-1]
    except Exception as e:  # reported, and the build phase fails on it
        nvcc = f"unavailable ({e})"
    print(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
          f"torch CUDA {torch.version.cuda} | nvcc: {nvcc}")


def build() -> None:
    from paddlebox_tpu_torch.native import key_index
    from paddlebox_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    paths = kernels.build_kernels()
    t1 = time.perf_counter()
    check(key_index.get_lib() is not None, "native key index did not build")
    t2 = time.perf_counter()
    check(sorted(paths) == sorted(SOURCES),
          f"built {sorted(paths)}, expected {sorted(SOURCES)}")
    print(f"build: kernels {t1 - t0:.1f} s ({', '.join(sorted(paths))}), "
          f"key index {t2 - t1:.1f} s")
    for name, log in sorted(kernels.build_logs.items()):
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the kernel and its template arguments (<OPT, G, CPL>)
                m = re.search(r"\d+([a-z_]+_kernel)((?:I(?:L[a-z]\d+E)+E)?)",
                              line)
                entry = m.group(1) if m else "?"
                if m and m.group(2):
                    entry += "<" + ",".join(re.findall(
                        r"L[a-z](\d+)E", m.group(2))) + ">"
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3-4: kernels at slice shapes
# ---------------------------------------------------------------------------

def slice_table(torch, cfg, n_rows, dev, gen):
    """A pass table with counter-like show/clk, non-negative optimizer
    state and the all-zero null row 0."""
    table = torch.randn((n_rows, cfg.row_width), generator=gen,
                        device=dev) * 0.05
    table[:, 0] = torch.randint(0, 50, (n_rows,), generator=gen, device=dev)
    table[:, 1] = torch.randint(0, 5, (n_rows,), generator=gen, device=dev)
    table[:, cfg.opt_cols] = table[:, cfg.opt_cols].abs()
    table[0] = 0.0
    return table


def slice_inputs(torch, lay, cfg, dev, gen):
    """A pass table of lay.n_keys keys and one batch's translated ids:
    slot lengths 1..max_len with real pad masking, as bench.py makes
    them (every slot holds one id in the one-hot layout)."""
    n_rows = lay.n_keys + 1
    L = lay.max_len
    table = slice_table(torch, cfg, n_rows, dev, gen)
    lens = torch.randint(1, L + 1, (B, S, 1), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev) < lens).reshape(B, S * L)
    ids = torch.randint(1, n_rows, (B, S * L), generator=gen, device=dev)
    idx = torch.where(mask, ids, 0).to(torch.int32).contiguous()
    return table, idx, mask


def token_payload(torch, cfg, idx, mask, gen):
    """One step's per-token push payload: random grads, unit shows, 25%
    clicks, all zero on masked tokens (which point at row 0)."""
    flat = idx.reshape(-1)
    n = flat.numel()
    maskf = mask.reshape(-1).float()
    grads = torch.randn((n, cfg.grad_width), generator=gen,
                        device=idx.device) * 1e-3 * maskf[:, None]
    clks = (torch.rand((n,), generator=gen, device=idx.device) < 0.25)
    return flat, grads, maskf, clks.float() * maskf


def check_gather_pool(torch, kernels, lay, cfg, table, idx) -> dict:
    import torch.nn.functional as F
    L = lay.max_len
    print("gather_pool vs gather_pool_plain at (B, S, L, W) = "
          f"({B}, {S}, {L}, {table.shape[1]}):")
    err = assert_close("no filters", kernels.gather_pool(table, idx, cfg, S, L),
                       kernels.gather_pool_plain(table, idx, cfg, S, L),
                       GATHER_TOL)
    thr = torch.linspace(-1.0, 3.0, S, device=table.device)
    for name, kw in (("need_filter scalar", dict(need_filter=True,
                                                 threshold=2.0)),
                     ("need_filter per slot", dict(need_filter=True,
                                                   threshold=thr)),
                     ("embed_threshold", dict(embed_threshold=0.02)),
                     ("quant_ratio", dict(quant_ratio=128))):
        assert_close(name, kernels.gather_pool(table, idx, cfg, S, L, **kw),
                     kernels.gather_pool_plain(table, idx, cfg, S, L, **kw),
                     GATHER_TOL)
    pad = torch.zeros_like(idx)
    out = kernels.gather_pool(table, pad, cfg, S, L)
    torch.cuda.synchronize()
    check(bool((out == 0).all()), "gather_pool: an all-pad batch is not 0")
    print("  all-pad batch pools to exact zeros ok")

    P = cfg.pull_width
    print(f"  lane group at P {P}: (lanes, columns a lane) "
          f"{kernels.gp_lane_group(P)}")
    rows = torch.unique(idx.long().clamp(0, table.shape[0] - 1))
    rows = rows[rows != 0]       # row 0 is zeros by contract: never read
    distinct = int(rows.numel())
    ms = time_ms(lambda: kernels.gather_pool(table, idx, cfg, S, L))
    plain_ms = time_ms(lambda: kernels.gather_pool_plain(table, idx, cfg, S,
                                                         L))
    bags = idx.reshape(B * S, L).long()
    lib_out = F.embedding_bag(bags, table, mode="sum")[:, :P]
    check(max_err(lib_out.reshape(B, S, P),
                  kernels.gather_pool_plain(table, idx, cfg, S, L)) < 1e-4,
          "embedding_bag yardstick disagrees")
    lib_ms = time_ms(lambda: F.embedding_bag(bags, table, mode="sum"))
    # least work, in whole sectors: each distinct referenced row's P
    # columns read once, the ids read once, the pooled output written
    # once; one add per element
    n_bytes = (sector_bytes(torch, (row_starts(torch, rows, table.shape[1]),
                                    P * 4))
               + dense_bytes(idx.numel() * 4) + dense_bytes(B * S * P * 4))
    return kernel_row("gather_pool", err, ms, plain_ms, n_bytes,
                      idx.numel() * P, lib_ms,
                      f"{distinct} distinct non-pad rows")


def premerged_lanes(torch, table, idx, mask, cfg, gen):
    """The push operands of one multi-hot step: the host dedup plan and
    the device premerge over random per-token grads."""
    from paddlebox_tpu_torch.embedding import sharded
    from paddlebox_tpu_torch.native.key_index import dedup_plan
    dev = table.device
    n_rows = table.shape[0]
    flat, grads, shows, clks = token_payload(torch, cfg, idx, mask, gen)
    o, u, s, _, _ = dedup_plan(flat.cpu().numpy(), n_rows, n_rows, 1)
    plan = sharded.DedupPlan(*(torch.from_numpy(a).to(dev)
                               for a in (o, u, s)))
    return sharded.plan_premerge(flat, grads, shows, clks, plan)


def check_scatter_accumulate(torch, kernels, cfg, table, idx, mask,
                             gen) -> dict:
    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    print("scatter_accumulate vs scatter_accumulate_plain, premerged lanes "
          f"of one batch ({idx.numel()} tokens):")
    lanes = premerged_lanes(torch, table, idx, mask, cfg, gen)
    uniq = lanes[0]
    n_rows = table.shape[0]
    valid = (uniq >= 0) & (uniq < n_rows)
    u = int(valid.sum())
    check(int(uniq[0]) == 0 and u < uniq.numel(),
          "expected a real row-0 lane mixed with out-of-range pads")
    got = kernels.scatter_accumulate(table.clone(), *lanes, cfg)
    want = kernels.scatter_accumulate_plain(table.clone(), *lanes, cfg)
    err = assert_close("adagrad, real row-0 lane + pads", got, want,
                       SCATTER_TOL)
    untouched = torch.ones(n_rows, dtype=torch.bool, device=table.device)
    untouched[uniq[valid].long()] = False
    check(torch.equal(got[untouched], table[untouched]),
          "scatter_accumulate changed a row no lane names")
    check(bool((got[0] == 0).all()), "row 0 lost its zero bits")
    print(f"  {int(untouched.sum())} untouched rows bit-identical, row 0 "
          f"still zero ok")
    # an all-pad batch: one zero-payload row-0 lane + pads
    zl = premerged_lanes(torch, table, torch.zeros_like(idx),
                         torch.zeros_like(mask), cfg, gen)
    got0 = kernels.scatter_accumulate(table.clone(), *zl, cfg)
    check(torch.equal(got0, table), "all-pad batch changed the table")
    print("  all-pad batch leaves the table bit-identical ok")
    # in-range lanes whose touched flag is 0 never write
    touched = (torch.arange(uniq.numel(), device=table.device) % 2).int()
    gt = kernels.scatter_accumulate(table.clone(), *lanes, cfg,
                                    touched=touched)
    wt = kernels.scatter_accumulate_plain(table.clone(), *lanes, cfg,
                                          touched=touched)
    assert_close("touched flags", gt, wt, SCATTER_TOL)
    # the other optimizers at the same lanes (their own row widths)
    sub = 1 << 16
    for opt in ("sgd", "adam", "ftrl"):
        c = EmbeddingConfig(dim=cfg.dim, optimizer=opt, learning_rate=0.05)
        t = slice_table(torch, c, sub, table.device, gen)
        # lanes past the smaller table become out-of-range pads
        li = torch.where(uniq < sub, uniq, sub).to(torch.int32)
        args = (li, *lanes[1:])
        assert_close(opt, kernels.scatter_accumulate(t.clone(), *args, c),
                     kernels.scatter_accumulate_plain(t.clone(), *args, c),
                     SCATTER_TOL)

    W = table.shape[1]
    scratch = table.clone()
    ms = time_ms(lambda: kernels.scatter_accumulate(scratch, *lanes, cfg))
    print(f"  lane group at W {cfg.row_width}: (lanes, columns a lane) "
          f"{kernels.sa_lane_group(cfg.row_width)}")
    plain_ms = time_ms(lambda: kernels.scatter_accumulate_plain(
        scratch, *lanes, cfg))
    n = uniq.numel()
    # least work, in whole sectors: each valid lane's row read and written
    # once, its payload read once, every lane's id read once; ~20 flops
    # per row element
    lane_no = torch.nonzero(valid).reshape(-1)
    g, sh, ck = lanes[1], lanes[2], lanes[3]
    n_bytes = (2 * sector_bytes(torch, (row_starts(torch, uniq[valid], W),
                                        cfg.row_width * 4))
               + sector_bytes(torch, (row_starts(torch, lane_no,
                                                 g.stride(0)),
                                      cfg.grad_width * 4))
               + sector_bytes(torch, (row_starts(torch, lane_no,
                                                 sh.stride(0)), 4))
               + sector_bytes(torch, (row_starts(torch, lane_no,
                                                 ck.stride(0)), 4))
               + dense_bytes(n * 4))
    return kernel_row("scatter_accumulate", err, ms, plain_ms, n_bytes,
                      u * W * 20, None, f"{u} valid of {n} lanes")


def check_acc(torch, name, got, want, gw) -> float:
    """binned_merge_acc's columns: grads within ACC_TOL, show, clk and
    count exact."""
    err = assert_close(f"{name}, grad columns", got[:, :gw], want[:, :gw],
                       ACC_TOL)
    check(torch.equal(got[:, gw:], want[:, gw:]),
          f"{name}: the show, clk or count column is not exact")
    print(f"  {name}: show, clk and count columns exact ok")
    return err


def check_binned_merge_acc(torch, kernels, cfg, table, idx, mask,
                           gen) -> tuple[dict, tuple]:
    from paddlebox_tpu_torch.native.key_index import block_plan
    n_rows = table.shape[0]
    gw = cfg.grad_width
    SB, NB = kernels.binned_geometry(cfg, n_rows)
    print(f"binned_merge_acc vs binned_merge_acc_plain, one batch's "
          f"{idx.numel()} tokens into {n_rows} rows (SB {SB}, NB {NB}):")

    def host_plan(flat):
        return tuple(torch.from_numpy(a).to(table.device)
                     for a in block_plan(flat.cpu().numpy(), SB, NB))

    def check_both(name, tok) -> float:
        want = kernels.binned_merge_acc_plain(*tok, cfg, n_rows)
        err = check_acc(torch, f"{name}, host plan", kernels.binned_merge_acc(
            *tok, cfg, n_rows, plan=host_plan(tok[0])), want, gw)
        check_acc(torch, f"{name}, device grouping",
                  kernels.binned_merge_acc(*tok, cfg, n_rows), want, gw)
        return err

    # the main path's stream (every one-hot slot holds an id), then the
    # same with one token in 64 masked: pads point at row 0 with a zero
    # payload, so row 0 is a hot row of its block
    tok = token_payload(torch, cfg, idx, mask, gen)
    flat = tok[0]
    err = check_both("main-path tokens", tok)
    g2 = torch.Generator(device=table.device).manual_seed(SEED + 3)
    pad_mask = mask & (torch.rand(mask.shape, generator=g2,
                                  device=idx.device) >= 1 / 64)
    tok_pad = token_payload(torch, cfg, torch.where(pad_mask, idx, 0).to(
        torch.int32).contiguous(), pad_mask, gen)
    n_pad = int((tok_pad[0] == 0).sum())
    check_both(f"{n_pad} pad tokens on row 0", tok_pad)
    # Criteo-like hot keys: each slot's ids a Zipf(ZIPF_A) draw (numpy,
    # from SEED) over its own 1/S of the rows, ranks scattered over them
    rng = np.random.default_rng(SEED)
    K = (n_rows - 1) // S
    ranks = np.minimum(rng.zipf(ZIPF_A, (B, S)), K) - 1
    perm = np.argsort(rng.random((S, K)), axis=1)
    zrows = 1 + np.arange(S) * K + perm[np.arange(S), ranks]
    zidx = torch.from_numpy(zrows.reshape(-1).astype(np.int32)).to(
        idx.device)
    tok_zipf = (zidx, *tok[1:])
    z_hot = int(np.bincount(zrows.reshape(-1)).max())
    check_both(f"Zipf({ZIPF_A}) ids per slot, hottest row {z_hot} tokens",
               tok_zipf)
    # out-of-range ids (both sides of the table) mixed into the stream
    bad = torch.rand(flat.shape, generator=g2, device=flat.device) < 0.05
    junk = torch.tensor([-1, -77, n_rows, n_rows + 9], dtype=torch.int32,
                        device=flat.device)
    pick = torch.randint(0, 4, flat.shape, generator=g2, device=flat.device)
    check_both("out-of-range ids",
               (torch.where(bad, junk[pick], flat).contiguous(), *tok[1:]))
    # an all-pad batch: every token on row 0 with a zero payload
    z = torch.zeros_like(flat)
    zp = (z, torch.zeros_like(tok[1]), torch.zeros_like(tok[2]),
          torch.zeros_like(tok[3]))
    got0 = kernels.binned_merge_acc(*zp, cfg, n_rows)
    check(torch.equal(got0, kernels.binned_merge_acc_plain(*zp, cfg,
                                                           n_rows)),
          "all-pad batch: accumulator differs")
    print("  all-pad batch: accumulator exact ok")

    n = flat.numel()
    plan = host_plan(flat)
    ms = time_ms(lambda: kernels.binned_merge_acc(*tok, cfg, n_rows,
                                                  plan=plan))
    ms_dev = time_ms(lambda: kernels.binned_merge_acc(*tok, cfg, n_rows))
    plan_pad = host_plan(tok_pad[0])
    ms_pad = time_ms(lambda: kernels.binned_merge_acc(*tok_pad, cfg, n_rows,
                                                      plan=plan_pad))
    plan_zipf = host_plan(zidx)
    ms_zipf = time_ms(lambda: kernels.binned_merge_acc(
        *tok_zipf, cfg, n_rows, plan=plan_zipf))
    plain_ms = time_ms(lambda: kernels.binned_merge_acc_plain(*tok, cfg,
                                                              n_rows))
    payload = torch.cat([tok[1], tok[2][:, None], tok[3][:, None],
                         tok[1].new_ones((n, 1))], dim=1)
    safe = flat.long()
    acc0 = torch.zeros((n_rows, gw + 3), device=table.device)
    # the kernel writes every accumulator row, so its yardstick pays for
    # the zero fill too
    lib_ms = time_ms(lambda: acc0.zero_().index_add_(0, safe, payload))
    print(f"  device grouping (argsort + searchsorted + kernel) "
          f"{ms_dev:.4f} ms")
    print(f"  streams, host plan: uniform (main path) {ms:.4f} ms | hot row "
          f"({n_pad} pad tokens on row 0, one window) {ms_pad:.4f} ms = "
          f"{ms_pad / ms:.2f}x uniform | Zipf({ZIPF_A}) per slot (hottest "
          f"row {z_hot} tokens) {ms_zipf:.4f} ms = {ms_zipf / ms:.2f}x "
          f"uniform")
    # least work, in whole sectors: each token's id, order entry and gw + 2
    # payload floats read once, the windows read once, the accumulator
    # written once; one add per accumulator element per token
    n_bytes = (4 * dense_bytes(n * 4)          # ids, order, shows, clks
               + dense_bytes(n * gw * 4) + 2 * dense_bytes(NB * 4)
               + dense_bytes(n_rows * (gw + 3) * 4))
    row = kernel_row("binned_merge_acc", err, ms, plain_ms, n_bytes,
                     n * (gw + 3), lib_ms,
                     f"{n} tokens, host plan; library = the accumulator's "
                     f"zero fill + one index_add_")
    return row, tok_pad


def check_merge_update(torch, kernels, cfg, table, tok, gen) -> dict:
    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    n_rows, W = table.shape
    gw = cfg.grad_width
    acc = kernels.binned_merge_acc_plain(*tok, cfg, n_rows)
    touched = acc[:, gw + 2] > 0
    u = int(touched.sum())
    check(bool(touched[0]) and bool((acc[0, :gw + 2] == 0).all()),
          "expected row 0 touched by masked tokens with a zero payload")
    print(f"merge_update vs merge_update_plain over {n_rows} rows, {u} "
          f"touched:")
    got = kernels.merge_update(table.clone(), acc, cfg)
    want = kernels.merge_update_plain(table.clone(), acc, cfg)
    err = assert_close("adagrad", got, want, MERGE_TOL)
    check(torch.equal(got[~touched], table[~touched]),
          "merge_update changed an untouched row")
    check(bool((got[0] == 0).all()), "row 0 lost its zeros")
    print(f"  {n_rows - u} untouched rows bit-identical, row 0 still zero "
          f"ok")
    sub = 1 << 16
    flat = tok[0]
    sub_tok = (torch.where(flat < sub, flat, sub).to(torch.int32),
               *tok[1:])
    for opt in ("sgd", "adam", "ftrl"):
        c = EmbeddingConfig(dim=cfg.dim, optimizer=opt, learning_rate=0.05)
        t = slice_table(torch, c, sub, table.device, gen)
        a = kernels.binned_merge_acc_plain(*sub_tok, c, sub)
        g = kernels.merge_update(t.clone(), a, c)
        assert_close(opt, g, kernels.merge_update_plain(t.clone(), a, c),
                     MERGE_TOL)
        check(bool((g[0] == 0).all()), f"{opt}: row 0 lost its zeros")
        keep = a[:, gw + 2] <= 0
        check(torch.equal(g[keep], t[keep]),
              f"{opt}: merge_update changed an untouched row")
    print("  sgd, adam, ftrl: row 0 still zero, untouched rows "
          "bit-identical ok")

    print(f"  lane group at W {cfg.row_width}: (lanes, columns a lane) "
          f"{kernels.mu_lane_group(cfg.row_width)}")
    # the same table at about 1% and at 100% touched rows, beside the
    # main path's share: held to the plain version, then timed
    g3 = torch.Generator(device=table.device).manual_seed(SEED + 4)
    few = acc.clone()
    few[torch.rand(n_rows, generator=g3, device=table.device) >= 0.01,
        gw + 2] = 0.0
    every = acc.clone()
    every[:, gw + 2] = every[:, gw + 2].clamp(min=1.0)
    scratch = table.clone()
    for share, a in (("~1%", few), ("100%", every)):
        assert_close(f"adagrad, {share} touched", kernels.merge_update(
            table.clone(), a, cfg), kernels.merge_update_plain(
                table.clone(), a, cfg), MERGE_TOL)
        t_ms = time_ms(lambda: kernels.merge_update(scratch, a, cfg))
        b_ms, _ = bound(merge_update_bytes(torch, cfg, W, a), 0)
        print(f"  {share} touched ({int((a[:, gw + 2] > 0).sum())} rows): "
              f"kernel {t_ms:.4f} ms | bound {b_ms:.4f} ms")
    ms = time_ms(lambda: kernels.merge_update(scratch, acc, cfg))
    plain_ms = time_ms(lambda: kernels.merge_update_plain(scratch, acc,
                                                          cfg))
    return kernel_row("merge_update", err, ms, plain_ms,
                      merge_update_bytes(torch, cfg, W, acc), u * W * 20,
                      None, f"{u} touched of {n_rows} rows")


def merge_update_bytes(torch, cfg, W, acc) -> int:
    """merge_update's least bytes, in whole sectors: every row's touch
    count read once (acc rows are 4 * (gw + 3) bytes apart, so that is
    one sector a row); each touched row's other acc columns read once and
    its table row read and written once (~20 flops per touched row
    element are free beside them)."""
    gw = cfg.grad_width
    P = gw + 3
    n_rows = acc.shape[0]
    rows = torch.nonzero(acc[:, gw + 2] > 0).reshape(-1)
    all_rows = torch.arange(n_rows, device=acc.device)
    acc_bytes = sector_bytes(
        torch, (row_starts(torch, all_rows, P, gw + 2), 4),
        (row_starts(torch, rows, P), (gw + 2) * 4))
    return acc_bytes + 2 * sector_bytes(
        torch, (row_starts(torch, rows, W), cfg.row_width * 4))


def kernel_phase(torch, kernels, dev, gen) -> list[dict]:
    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    rows = []
    for lay in (MULTI, ONEHOT):
        cfg = EmbeddingConfig(dim=lay.dim, optimizer="adagrad",
                              learning_rate=0.05)
        print(f"== kernels at {lay.name} shapes: B {B}, {S} slots x "
              f"{lay.max_len}, dim {lay.dim} (W {cfg.row_width}), "
              f"{lay.n_keys + 1} rows")
        table, idx, mask = slice_inputs(torch, lay, cfg, dev, gen)
        if lay is MULTI:
            rows += [check_gather_pool(torch, kernels, lay, cfg, table, idx),
                     check_scatter_accumulate(torch, kernels, cfg, table,
                                              idx, mask, gen)]
        else:
            row, tok_pad = check_binned_merge_acc(torch, kernels, cfg, table,
                                                  idx, mask, gen)
            rows += [row, check_merge_update(torch, kernels, cfg, table,
                                             tok_pad, gen)]
        del table, idx, mask
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 5: the main paths
# ---------------------------------------------------------------------------

def make_records(schema, n, keys, rng, max_len):
    """Criteo-shaped examples: the schema's slots (26 at full width) of
    1..max_len ids drawn from the key set, a 25%-positive label and 13
    dense floats."""
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    lens = [rng.integers(1, max_len + 1, n)
            for _ in range(len(schema.sparse_slots))]
    vals = [rng.choice(keys, int(l.sum())).astype(np.int64) for l in lens]
    offs = [np.concatenate([[0], np.cumsum(l)]).astype(np.int64)
            for l in lens]
    floats = [(rng.random(n) < 0.25).astype(np.float32)]
    floats += [rng.normal(size=n).astype(np.float32) for _ in range(DENSE)]
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats, z64, z64, z32, z32)


def check_text_parse(schema, records) -> None:
    """The MultiSlot text path: 64 examples written out and read back
    through SlotDataset pack to the same bytes."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.data.parser import format_multislot_example
    n = 64
    pb = records.pack(0, n)
    float_names = [s.name for s in schema.float_slots]
    lines = []
    for i in range(n):
        vals = [(name, [repr(float(pb.floats[i, j]))])
                for j, name in enumerate(float_names)]
        for s, slot in enumerate(schema.sparse_slots):
            o = records.sparse_offsets[s]
            v = records.sparse_values[s][o[i]:o[i + 1]]
            vals.append((slot.name, [int(x) & ((1 << 64) - 1) for x in v]))
        lines.append(format_multislot_example(vals, schema))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "part-0")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        ds = SlotDataset(schema)
        ds.set_filelist([path])
        ds.load_into_memory(global_shuffle=False)
    got = next(ds.batches(n))
    for name in ("ids", "mask", "floats"):
        check(getattr(got, name).tobytes() == getattr(pb, name).tobytes(),
              f"text parse: {name} differ from the in-memory records")
    print(f"text parse: {n} MultiSlot lines pack to identical bytes ok")


def make_trainer(torch, lay, n_batch, device, seed=SEED):
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    cfg = EmbeddingConfig(dim=lay.dim, optimizer="adagrad",
                          learning_rate=0.05)
    store = HostEmbeddingStore(cfg)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=n_batch, max_len=lay.max_len)
    tr = Trainer(DeepFMModel(S, lay.dim, DENSE, hidden=HIDDEN), store,
                 schema, TrainerConfig(global_batch_size=n_batch,
                                       auc_buckets=1 << 16),
                 seed=seed, device=device)
    return store, schema, tr


def draw_keys(n_keys: int):
    """A main path's key set and the generator its records draw from."""
    rng = np.random.default_rng(SEED)
    keys = np.unique(rng.integers(1, 1 << 50, n_keys + 4096,
                                  dtype=np.uint64))[:n_keys]
    rng.shuffle(keys)
    return keys, rng


def main_path(torch, kernels, lay, keep: dict | None = None
              ) -> dict[str, int]:
    """``keep``, when given, receives the pass's losses and its
    working set's keys and flushed rows (phase 9 holds its archive-fed
    pass against them)."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    print(f"== main path, {lay.name}")
    keys, rng = draw_keys(lay.n_keys)
    store, schema, tr = make_trainer(torch, lay, B, None)
    t0 = time.perf_counter()
    records = make_records(schema, lay.steps * B, keys, rng, lay.max_len)
    check_text_parse(schema, records)
    ds = SlotDataset(schema)
    ds.records = records
    n_tokens = int(sum(len(v) for v in records.sparse_values))
    print(f"data: {records.num} examples, {n_tokens} ids, "
          f"{time.perf_counter() - t0:.1f} s to make")
    box = BoxPS(store)
    box.set_date(20261016)
    box.begin_pass()
    reset_counts(kernels)
    out = tr.train_pass(ds)
    launches = launch_counts(kernels)
    box.end_pass()
    steps = out["steps"]
    engine = tr.resolved_push_engine(tr.last_ws)
    print(f"main path: steps {steps} | loss first {out['loss_first']:.6f} "
          f"last {out['loss_last']:.6f} mean {out['loss_mean']:.6f} | auc "
          f"{out['auc']:.6f} | {steps * B / out['step_seconds']:.1f} "
          f"examples/s | step {out['step_seconds'] / steps * 1e3:.3f} ms "
          f"(step loop) | pass {out['seconds']:.2f} s | pull "
          f"{tr.pull_engine} | push {engine} | working set "
          f"{tr.last_ws.num_keys} keys")
    print(f"launches in the main path: {launches}")
    check(steps == lay.steps, f"expected {lay.steps} steps, ran {steps}")
    check(np.isfinite(out["loss_mean"]), "non-finite loss")
    check(engine == lay.engine, f"push engine {engine}, expected "
          f"{lay.engine}")
    for name, n in launches.items():
        want = steps if name in lay.kernels else 0
        check(n == want, f"{name} launched {n} times in {steps} steps, "
              f"expected {want}")
    ws_keys = tr.last_ws.sorted_keys
    # write-back is lazy: get_rows flushes the card's rows first
    rows = store.get_rows(ws_keys)
    check(float(rows[:, 0].astype(np.float64).sum()) == n_tokens,
          "written-back show counters do not sum to the pass's ids")
    changed = np.any(rows != store._init_rows(ws_keys), axis=1).mean()
    check(changed > 0.99, f"only {changed:.3f} of the rows changed")
    print(f"write-back: show counters sum to {n_tokens}, "
          f"{changed * 100:.2f}% of rows changed ok")
    if keep is not None:
        keep.update(out=out, keys=ws_keys, rows=rows)
    eval_check(kernels, lay, tr, schema, keys, rng)
    breakdown(torch, tr, ds, out["step_seconds"] / steps * 1e3)
    if lay is ONEHOT:
        engine_ab(torch, tr, ds)
    return {k: launches[k] for k in lay.kernels}


def eval_check(kernels, lay, tr, schema, keys, rng) -> None:
    """Trainer.eval_pass over 4 full batches and a tail of 1000 examples
    (padded, masked out of the AUC) with every count reset just before
    and read just after: the multi-hot eval pulls through gather_pool
    once a batch, the one-hot eval launches no kernel (a plain gather),
    and the store neither grows nor gets dirty rows."""
    from paddlebox_tpu_torch.data import SlotDataset
    n = 4 * B + 1000
    ds = SlotDataset(schema)
    ds.records = make_records(schema, n, keys, rng, lay.max_len)
    store = tr.store
    n_keys, dirty = len(store), int(store._dirty[:store._n].sum())
    reset_counts(kernels)
    out = tr.eval_pass(ds)
    launches = launch_counts(kernels)
    steps = out["steps"]
    print(f"eval_pass, {lay.name} ({smi_line()}): {steps} batches, "
          f"{out['examples']} examples (a tail of 1000 padded and masked) | "
          f"auc {out['auc']:.6f} | {n / out['step_seconds']:.1f} examples/s "
          f"(batch loop) | {n / out['seconds']:.1f} examples/s (whole "
          f"pass, {out['seconds']:.3f} s) | launches {launches}")
    check(out["examples"] == n and out["size"] == n,
          f"eval_pass scored {out['examples']} examples, expected {n}")
    check(np.isfinite(out["auc"]), "eval_pass: non-finite AUC")
    check(len(store) == n_keys and int(store._dirty[:store._n].sum())
          == dirty, "eval_pass grew the store or dirtied rows")
    for name, k in launches.items():
        want = steps if (name == "gather_pool" and lay is MULTI) else 0
        check(k == want, f"eval_pass launched {name} {k} times in {steps} "
              f"batches, expected {want}")


def device_profile(torch, tr, staged) -> tuple[list, float]:
    """torch.profiler over one train_step on each pre-staged batch: the
    device-side ops as (ms per step, name), largest first (the CPU op
    rows repeat their kernels' time, so they are left out), and the
    device ops a step."""
    from torch.profiler import ProfilerActivity, profile
    ws = tr.last_ws
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in staged:
            tr.train_step(ws.table, *s)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and getattr(e, "self_device_time_total", 0) > 0]
    rows = sorted(((e.self_device_time_total / len(staged) / 1e3, e.key)
                   for e in events), reverse=True)
    return rows, sum(e.count for e in events) / len(staged)


def step_syncs(torch, tr, staged) -> list:
    """The host syncs of one train_step, as sync-debug warnings: each
    stalls the host until the device drains, so the dispatch of the rest
    of the step cannot overlap it."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            tr.train_step(tr.last_ws.table, *staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return syncs


def breakdown(torch, tr, ds, loop_ms: float) -> None:
    """Where a main-path step's time goes: the host pack of one batch
    (translate + push plan + pin, the pack thread's work), the device
    step alone on pre-staged batches, the profiler's split of the device
    time by kernel, and the step loop of a second pass with the pack
    inline instead of on its thread. Runs after the main path's launch
    counts are read, on its last working set."""
    ws = tr.last_ws
    n = 4
    clock = time.perf_counter
    it = ds.batches(B)
    t0 = clock()
    pbs = [next(it) for _ in range(n)]
    t1 = clock()
    idxs = [ws.translate(pb.ids, pb.mask) for pb in pbs]
    t2 = clock()
    plans = [tr.host_plan(ws, i) for i in idxs]
    t3 = clock()
    hosts = [tr._pack_host(ws, pb) for pb in pbs]
    t4 = clock()
    host_ms = (t4 - t3) / n * 1e3
    print(f"breakdown, host ms per batch: records.pack "
          f"{(t1 - t0) / n * 1e3:.3f} | translate {(t2 - t1) / n * 1e3:.3f} "
          f"| push plan ({type(plans[0]).__name__}) "
          f"{(t3 - t2) / n * 1e3:.3f} | the pack thread's _pack_host "
          f"(translate + plan + pin) {host_ms:.3f}")
    staged = [tr.stage(h) for h in hosts]
    tr.train_step(ws.table, *staged[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in staged:
        tr.train_step(ws.table, *s)
    torch.cuda.synchronize()
    dev_ms = (time.perf_counter() - t0) / len(staged) * 1e3
    rows, n_dev = device_profile(torch, tr, staged)
    busy_ms = sum(r[0] for r in rows)
    syncs = step_syncs(torch, tr, staged[0])
    print(f"breakdown: device step {dev_ms:.3f} ms (pre-staged, host "
          f"clock) | profiled device busy {busy_ms:.3f} ms/step in "
          f"{n_dev:.0f} device ops | host syncs per step {len(syncs)} | "
          f"device idle share of the main path's step loop "
          f"{1 - busy_ms / loop_ms:.3f}")
    for w in syncs[:3]:
        print(f"  sync: {str(w.message).splitlines()[0][:120]} "
              f"({w.filename}:{w.lineno})")
    for ms, name in rows[:16]:
        print(f"  {ms:8.4f} ms/step  {name[:100]}")
    # the same pass with the pack done inline on the step's thread: does
    # the pack thread overlap the host work with the device, or contend?
    from paddlebox_tpu_torch.config import flags
    depth, flags.prefetch_batches = flags.prefetch_batches, 0
    try:
        out = tr.train_pass(ds)
    finally:
        flags.prefetch_batches = depth
    print(f"breakdown: step loop without the pack thread "
          f"{out['step_seconds'] / out['steps'] * 1e3:.3f} ms/step")


def engine_ab(torch, tr, ds) -> None:
    """The one-hot device step under each push engine, on pre-staged
    batches that carry that engine's own plan (binned_kernel: block plan;
    scatter_accumulate: dedup plan, then premerge; xla_scatter: no plan,
    index_add_ + merge_update), in turns A B C C B A: device ms per step
    (time_ms: the steps queued behind a sleep, so host dispatch is
    hidden) and host-clock ms per step (dispatch included, as the step
    loop pays it)."""
    from paddlebox_tpu_torch.config import flags
    ws = tr.last_ws
    it = ds.batches(B)
    pbs = [next(it) for _ in range(6)]
    engines = ("binned_kernel", "scatter_accumulate", "xla_scatter")
    saved = flags.push_engine
    staged = {}
    try:
        for eng in engines:
            flags.push_engine = eng
            check(tr.resolved_push_engine(ws) == eng,
                  f"forcing {eng} resolved {tr.resolved_push_engine(ws)}")
            staged[eng] = [tr.stage(tr._pack_host(ws, pb)) for pb in pbs]
        dev = {e: [] for e in engines}
        host = {e: [] for e in engines}
        for eng in (*engines, *reversed(engines)):
            flags.push_engine = eng

            # one step per timed call: a step is about 250 launches, so
            # the whole of it queues behind the sleep (several steps
            # overflow CUDA's queue of pending launches, and then the
            # host's dispatch paces the device again)
            dev[eng].append(np.mean([
                time_ms(functools.partial(tr.train_step, ws.table, *s),
                        iters=1, warmup=1) for s in staged[eng]]))
            t0 = time.perf_counter()
            for s in staged[eng]:
                tr.train_step(ws.table, *s)
            torch.cuda.synchronize()
            host[eng].append((time.perf_counter() - t0) / len(pbs) * 1e3)
    finally:
        flags.push_engine = saved
    for what, times in (("device", dev), ("host clock", host)):
        print(f"engine A/B, one-hot step on pre-staged batches, {what} "
              f"ms/step (turns A B C C B A): " + " | ".join(
                  f"{e} {t[0]:.3f} {t[1]:.3f} (mean {np.mean(t):.3f})"
                  for e, t in times.items()))


def reference_check(torch, lay) -> None:
    """A small pass on the card (kernels) and on the CPU (plain
    versions, the index_add push) from the same params and data."""
    from paddlebox_tpu_torch.data import SlotDataset
    nb, steps = 256, 4
    rng = np.random.default_rng(SEED + 1)
    keys = rng.choice(1 << 40, 4000, replace=False).astype(np.uint64)
    outs, stores, engines = [], [], []
    for device in ("cuda", "cpu"):
        store, schema, tr = make_trainer(torch, lay, nb, device)
        ds = SlotDataset(schema)
        ds.records = make_records(schema, nb * steps, keys,
                                  np.random.default_rng(SEED + 2),
                                  lay.max_len)
        outs.append(tr.train_pass(ds))
        engines.append(tr.resolved_push_engine(tr.last_ws))
        tr.flush_sparse()         # lazy write-back: rows reach the store
        stores.append(store)
    gpu, cpu = outs
    check(engines == [lay.engine, "xla_scatter"],
          f"{lay.name}: engines {engines}")
    np.testing.assert_allclose(gpu["loss_mean"], cpu["loss_mean"],
                               **LOSS_TOL)
    check(abs(gpu["auc"] - cpu["auc"]) < 1e-3, "AUC differs card vs CPU")
    np.testing.assert_allclose(stores[0].peek_rows(keys),
                               stores[1].peek_rows(keys), **TABLE_TOL)
    print(f"reference, {lay.name}: card ({engines[0]}) vs CPU "
          f"({engines[1]}) on {nb * steps} examples: loss "
          f"{gpu['loss_mean']:.6f} vs {cpu['loss_mean']:.6f}, auc "
          f"{gpu['auc']:.6f} vs {cpu['auc']:.6f}, rows within rtol 1e-3 ok")


def flat_dense(tr) -> dict:
    from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
    return {p: np.array(x) for p, x in flatten_tree(tr.dense_state())}


def metric_state(box) -> dict:
    return {k: v.cpu().numpy().copy()
            for k, v in box.metrics.get_state("auc").items()}


def persistence_phase(torch, kernels) -> None:
    """The one-hot headline at full width through three checkpointed
    passes, a resume of pass 2 into a fresh job, pass 3 again from the
    resumed state, and a resume past a torn newest snapshot. Every
    count is reset just before the phase and read just after: its four
    training passes launch binned_merge_acc and merge_update once a
    step."""
    import shutil
    import warnings
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    lay = ONEHOT
    print(f"== persistence, {lay.name}: {lay.n_keys}-key store, 3 passes x "
          f"{lay.steps} steps, PassCheckpointer(base_every=2)")
    rng = np.random.default_rng(SEED + 5)
    keys = np.unique(rng.integers(1, 1 << 50, lay.n_keys + 4096,
                                  dtype=np.uint64))[:lay.n_keys]

    def job(seed):
        store, schema, tr = make_trainer(torch, lay, B, None, seed=seed)
        box = BoxPS(store)
        box.init_metric("auc")
        return store, schema, tr, box

    store, schema, tr, box = job(SEED)
    datasets = []
    for p in range(3):
        ds = SlotDataset(schema, seed=p)
        ds.records = make_records(schema, lay.steps * B, keys,
                                  np.random.default_rng(SEED + 10 + p), 1)
        datasets.append(ds)
    card = smi_line()
    reset_counts(kernels)
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "snapshots")
        ckpt = PassCheckpointer(root, base_every=2)
        saves = []
        for p, ds in enumerate(datasets, 1):
            box.set_date(20261017)
            box.begin_pass()
            out = tr.train_pass(ds, metrics=box.metrics)
            t0 = time.perf_counter()
            box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
            end_s = time.perf_counter() - t0
            sv = dict(ckpt.last_save)
            saves.append(sv)
            kind = "save_base" if sv["rotated"] else "save_delta"
            fm = tr.feed_mgr
            print(f"  pass {p}: loss mean {out['loss_mean']:.6f} | auc "
                  f"{out['auc']:.6f} | registry auc "
                  f"{box.get_metric_msg('auc')['auc']:.6f} | boundary "
                  f"(pass - step seconds) {out['seconds'] - out['step_seconds']:.3f} s"
                  f", manager {fm.last_boundary_seconds:.3f} s (fresh "
                  f"{fm.last_fresh_rows} reused {fm.last_reused_rows}) | "
                  f"save flush {sv['flush_seconds']:.3f} s"
                  f" | end_pass {end_s:.3f} s: {kind} {sv['sparse_member']} "
                  f"{sv['sparse_bytes']} bytes in {sv['sparse_seconds']:.3f} s,"
                  f" snapshot {sv['snapshot']} {sv['bytes']} bytes in "
                  f"{sv['seconds']:.3f} s")
            if p == 2:
                k2 = store.keys()
                live2 = dict(keys=k2, rows=store.get_rows(k2),
                             dense=flat_dense(tr), metrics=metric_state(box),
                             step=tr.global_step)
            if p == 3:
                live3 = dict(out=out, keys=store.keys())
                live3["rows"] = store.get_rows(live3["keys"])
        check([s["rotated"] for s in saves] == [True, False, True],
              f"saves rotated {[s['rotated'] for s in saves]}, expected "
              f"base, delta, base")
        check(sorted(os.listdir(root)) == ["chain-0001", "chain-0002",
                                           "pass-00001", "pass-00002",
                                           "pass-00003"],
              f"snapshot root holds {sorted(os.listdir(root))}")

        # resume pass 2 into a fresh job (pass 3's snapshot never landed)
        root2 = os.path.join(d, "resumed")
        shutil.copytree(root, root2)
        shutil.rmtree(os.path.join(root2, "pass-00003"))
        store2, _, tr2, box2 = job(SEED + 1)
        ck2 = PassCheckpointer(root2, base_every=2)
        cursor = tr2.resume(ck2, box=box2)
        res = dict(ck2.last_resume)
        check(cursor is not None and cursor["pass_id"] == 2
              and box2.pass_id == 2 and cursor["date"] == 20261017
              and tr2.global_step == live2["step"] == 2 * lay.steps,
              f"resumed cursor {cursor}")
        check(np.array_equal(store2.keys(), live2["keys"])
              and np.array_equal(store2.get_rows(live2["keys"]),
                                 live2["rows"]),
              "resumed store keys/rows differ from the live store after "
              "pass 2")
        got = flat_dense(tr2)
        check(sorted(got) == sorted(live2["dense"]) and all(
            got[k].dtype == v.dtype and np.array_equal(got[k], v)
            for k, v in live2["dense"].items()),
              "resumed dense params / adam state differ from the live ones")
        check(got["opt_state/0/count"].shape == ()
              and int(got["opt_state/0/count"]) == 2 * lay.steps,
              "adam count not restored")
        check(next(tr2.model.parameters()).device.type == "cuda",
              "restored dense state is not on the card")
        mt = metric_state(box2)
        check(all(np.array_equal(mt[k], v)
                  for k, v in live2["metrics"].items()),
              "resumed metric state differs from the live one")
        print(f"  resume of pass 2 into a fresh job: {res['bytes']} bytes "
              f"in {res['seconds']:.3f} s; store ({len(store2)} keys), "
              f"dense params, adam mu/nu/count, metric state and cursor "
              f"bit-equal to the live run ok")
        box2.begin_pass()
        out3 = tr2.train_pass(datasets[2], metrics=box2.metrics)
        box2.end_pass(checkpointer=ck2, trainer=tr2, dataset=datasets[2])
        live_out = live3["out"]
        np.testing.assert_allclose(out3["loss_mean"], live_out["loss_mean"],
                                   **LOSS_TOL)
        check(abs(out3["auc"] - live_out["auc"]) < 1e-3,
              "resumed pass 3 AUC differs from the live one")
        check(np.array_equal(store2.keys(), live3["keys"]),
              "resumed pass 3 keys differ")
        np.testing.assert_allclose(store2.get_rows(live3["keys"]),
                                   live3["rows"], **TABLE_TOL)
        check(ck2.last_save["rotated"], "resumed pass 3 save was no base")
        print(f"  pass 3 from the resumed state: loss {out3['loss_mean']:.6f}"
              f" vs live {live_out['loss_mean']:.6f}, auc {out3['auc']:.6f} "
              f"vs {live_out['auc']:.6f}, rows within rtol 1e-3 ok")

        # a torn newest snapshot: resume falls back to pass 2
        dense_f = os.path.join(root, "pass-00003", "dense.npz")
        with open(dense_f, "r+b") as f:
            f.truncate(os.path.getsize(dense_f) // 2)
        store3, _, tr3, box3 = job(SEED + 2)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cursor3 = tr3.resume(PassCheckpointer(root, base_every=2),
                                 box=box3)
        named = [str(w.message) for w in caught
                 if "pass-00003" in str(w.message)]
        check(cursor3 is not None and cursor3["pass_id"] == 2 and named,
              f"torn pass 3: resumed {cursor3}, warnings {named}")
        check(np.array_equal(store3.get_rows(live2["keys"]), live2["rows"]),
              "fallback resume: rows differ from pass 2's")
        print(f"  pass 3's dense.npz truncated: resume fell back to pass 2 "
              f"with a warning ({named[0][:100]}...) ok")
    launches = launch_counts(kernels)
    print(f"launches in the persistence phase (4 training passes): "
          f"{launches}")
    for name, n in launches.items():
        want = 4 * lay.steps if name in lay.kernels else 0
        check(n == want, f"{name} launched {n} times in the persistence "
              f"phase, expected {want}")
    base1, delta, base3 = saves
    print(f"persistence ({card}): save_base {base1['sparse_bytes']} bytes "
          f"in {base1['sparse_seconds']:.3f} s | save_delta "
          f"{delta['sparse_bytes']} bytes in {delta['sparse_seconds']:.3f} s"
          f" | save_base (pass 3) {base3['sparse_bytes']} bytes in "
          f"{base3['sparse_seconds']:.3f} s | whole snapshot "
          f"{base1['seconds']:.3f} / {delta['seconds']:.3f} / "
          f"{base3['seconds']:.3f} s | resume {res['bytes']} bytes in "
          f"{res['seconds']:.3f} s")


# ---------------------------------------------------------------------------
# phase 8: the pass boundary (FeedPassManager)
# ---------------------------------------------------------------------------

def key_window(p: int, n_keys: int, churn: int) -> np.ndarray:
    """Pass p's sorted key window: n_keys keys sliding by churn a pass."""
    return np.sort(np.arange(p * churn, p * churn + n_keys, dtype=np.uint64)
                   * np.uint64(2654435761) + np.uint64(1))


def boundary_drill(torch, card: str) -> None:
    """bench.py's boundary drill on the port: 5 passes over key
    windows with 90% overlap, a table edit a pass (keys staying into the
    next window get +1 show, the cold tail's show is zeroed, every w
    column +0.5), then ``begin_feed_pass`` of the next window and a
    pure-eviction ``store.shrink(min_show=0.5, decay=1.0)`` at each
    boundary. Run incremental and with ``flags.incremental_feed=False``
    (the full rebuild); the two stores must come out bit-identical."""
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.embedding.feed_pass import FeedPassManager
    cfg = EmbeddingConfig(dim=ONEHOT.dim, optimizer="adagrad",
                          learning_rate=0.05)
    n_keys, passes = ONEHOT.n_keys, 5
    churn = n_keys // 10
    print(f"== boundary drill: {n_keys}-key windows, {passes} passes, 90% "
          f"overlap, dim {cfg.dim} (W {cfg.row_width}), shrink at every "
          f"boundary")

    def run(incremental: bool):
        flags.incremental_feed = incremental
        store = HostEmbeddingStore(cfg)
        mgr = FeedPassManager(store)
        dev = mgr.device
        name = "incremental" if incremental else "full rebuild"
        total = 0.0
        for p in range(passes):
            keys = key_window(p, n_keys, churn)
            ws = mgr.begin_pass(keys)
            if p:
                total += mgr.last_boundary_seconds
                sp = mgr.last_boundary_split
                print(f"  {name}, pass {p + 1} ({card}): boundary "
                      f"{mgr.last_boundary_seconds:.4f} s | build "
                      f"{sp['build']:.4f} s h2d {sp['h2d']:.4f} s | fresh "
                      f"{mgr.last_fresh_rows} reused {mgr.last_reused_rows}"
                      f" stale {mgr.last_stale_rows} patched "
                      f"{mgr.last_patched_rows} | h2d {mgr.last_h2d_bytes} "
                      f"bytes, d2h at retirement {mgr.last_d2h_bytes} bytes"
                      f", flushed before the last shrink {flushed} bytes")
            nxt = key_window(p + 1, n_keys, churn)
            idx = torch.from_numpy(ws.translate(keys).astype(np.int64)).to(
                dev)
            staying = torch.from_numpy(np.isin(keys, nxt,
                                               assume_unique=True)).to(dev)
            t = ws.table
            t[idx[staying], 0] += 1.0
            t[idx[~staying], 0] = 0.0
            t[idx, 2] += 0.5
            mgr.end_pass(ws)
            if incremental and p + 1 < passes:
                mgr.begin_feed_pass(nxt)
            d0 = mgr.last_d2h_bytes
            store.shrink(min_show=0.5, decay=1.0)
            flushed = mgr.last_d2h_bytes - d0
        mgr.close()
        return store, total

    saved = flags.incremental_feed
    try:
        inc, inc_s = run(True)
        full, full_s = run(False)
    finally:
        flags.incremental_feed = saved
    check(np.array_equal(inc.keys(), full.keys()),
          "boundary drill: the stores' keys differ")
    check(np.array_equal(inc._rows[:len(inc)], full._rows[:len(full)]),
          "boundary drill: incremental and full-rebuild rows differ")
    print(f"boundary drill ({card}): passes 2-{passes} boundary "
          f"{inc_s:.4f} s incremental vs {full_s:.4f} s full rebuild; "
          f"stores bit-identical ({len(inc)} keys, rows and key order) ok")


def boundary_trainer(torch, kernels, card: str) -> None:
    """Three checkpointed passes of lay.steps steps through train_pass
    over sliding key windows (90% overlap, each draw uniform in its
    window), in three variants: (i) incremental with preload_keys= the
    next pass's keys, (ii) incremental without preload, (iii)
    flags.incremental_feed=False with a store mutation (a shrink that
    evicts nothing) between passes, the full rebuild. Counts are reset
    before each pass and read after it. The stores must agree within
    TABLE_TOL after a flush, and the losses within LOSS_TOL."""
    import tempfile as _tf
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    lay, n_batch, n_keys = ONEHOT, B, ONEHOT.n_keys
    churn = n_keys // 10
    print(f"== boundary, trainer: {lay.name}, {n_keys}-key windows sliding "
          f"by {churn}, 3 passes x {lay.steps} steps x {n_batch}, "
          f"PassCheckpointer(base_every=2)")
    variants = (("preload", True), ("incremental", True),
                ("full rebuild", False))
    results = {}
    saved = flags.incremental_feed
    try:
        for name, incremental in variants:
            flags.incremental_feed = incremental
            store, schema, tr = make_trainer(torch, lay, n_batch, None)
            box = BoxPS(store)
            box.init_metric("auc")
            dss = []
            for p in range(3):
                ds = SlotDataset(schema, seed=p)
                ds.records = make_records(
                    schema, lay.steps * n_batch, key_window(p, n_keys, churn),
                    np.random.default_rng(SEED + 20 + p), lay.max_len)
                dss.append(ds)
            losses = []
            with _tf.TemporaryDirectory() as d:
                ckpt = PassCheckpointer(os.path.join(d, "snap"),
                                        base_every=2)
                for p, ds in enumerate(dss):
                    nxt = (dss[p + 1].unique_keys()
                           if name == "preload" and p < 2 else None)
                    t0 = time.perf_counter()
                    ds.unique_keys()     # timed alone: train_pass calls it
                    uk_s = time.perf_counter() - t0
                    box.set_date(20261017)
                    box.begin_pass()
                    reset_counts(kernels)
                    out = tr.train_pass(ds, metrics=box.metrics,
                                        preload_keys=nxt)
                    launches = launch_counts(kernels)
                    box.end_pass(checkpointer=ckpt, trainer=tr, dataset=ds)
                    sv = ckpt.last_save
                    fm = tr.feed_mgr
                    steps = out["steps"]
                    losses.append(out["loss_mean"])
                    print(f"  {name}, pass {p + 1} ({card}): pass "
                          f"{out['seconds']:.3f} s | step loop "
                          f"{out['step_seconds']:.3f} s, "
                          f"{steps * n_batch / out['step_seconds']:.1f} "
                          f"examples/s | boundary (pass - step) "
                          f"{out['seconds'] - out['step_seconds']:.3f} s, "
                          f"of it unique_keys {uk_s:.3f} s and the "
                          f"manager {fm.last_boundary_seconds:.4f} s (build "
                          f"{fm.last_boundary_split['build']:.4f} h2d "
                          f"{fm.last_boundary_split['h2d']:.4f}) | fresh "
                          f"{fm.last_fresh_rows} reused "
                          f"{fm.last_reused_rows} patched "
                          f"{fm.last_patched_rows} | save: flush "
                          f"{sv['flush_seconds']:.3f} s {sv['flush_bytes']} "
                          f"bytes, {'base' if sv['rotated'] else 'delta'} "
                          f"{sv['sparse_seconds']:.3f} s | launches "
                          f"binned_merge_acc {launches['binned_merge_acc']}"
                          f" merge_update {launches['merge_update']}")
                    check(steps == lay.steps, f"{name}: {steps} steps")
                    check(np.isfinite(out["loss_mean"]),
                          f"{name}: non-finite loss")
                    for k in lay.kernels:
                        check(launches[k] == steps,
                              f"{name}, pass {p + 1}: {k} launched "
                              f"{launches[k]} times in {steps} steps")
                    if p and incremental:
                        check(fm.last_reused_rows > 0,
                              f"{name}, pass {p + 1}: no resident row reused")
                    if not incremental:
                        check(fm.last_reused_rows == 0,
                              f"{name}, pass {p + 1}: reused rows in a full "
                              f"rebuild")
                        # a store mutation the flag keeps from proving:
                        # the next pass rebuilds in full
                        box.shrink_table(0.0)
            tr.flush_sparse()
            keys = np.sort(store.keys())
            results[name] = (keys, store.get_rows(keys), losses)
            del tr
            torch.cuda.empty_cache()
    finally:
        flags.incremental_feed = saved
    ref_keys, ref_rows, ref_losses = results["full rebuild"]
    for name in ("preload", "incremental"):
        keys, rows, losses = results[name]
        check(np.array_equal(keys, ref_keys),
              f"boundary trainer: {name} store keys differ from the full "
              f"rebuild's")
        np.testing.assert_allclose(rows, ref_rows, **TABLE_TOL)
        np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL)
    print(f"boundary, trainer ({card}): stores of preload, incremental and "
          f"full rebuild agree ({len(ref_keys)} keys, rows within rtol 1e-3, "
          f"losses within rtol 2e-4) ok")


# ---------------------------------------------------------------------------
# phase 9: ingest — the data plane, then a pass from its archives and a
# streamed HeterTrainer pass
# ---------------------------------------------------------------------------

N_FILES = 8
GZ_FILES = (1, 5)                         # stored gzip in the text filelist
U64 = (1 << 64) - 1
MERGE_ODD = (1000, 500)                   # singleton and triple groups

_GENERATOR = """
import sys
sys.path.insert(0, {repo!r})
from paddlebox_tpu_torch.data import DataFeedSchema
from paddlebox_tpu_torch.data.data_generator import MultiSlotDataGenerator

SCHEMA = DataFeedSchema.ctr(num_sparse={s}, num_float={d}, max_len=1)
DENSE = [slot.name for slot in SCHEMA.float_slots[1:]]
SPARSE = [slot.name for slot in SCHEMA.sparse_slots]


class Raw(MultiSlotDataGenerator):
    # raw form: "<ins_id>,<label>,<dense ...>,<id ...>"
    def generate_sample(self, line):
        ins, label, dense, ids = line.split(",")
        yield ins, ([("label", [label])]
                    + [(n, [v]) for n, v in zip(DENSE, dense.split())]
                    + [(n, [k]) for n, k in zip(SPARSE, ids.split())])


Raw(SCHEMA, with_ins_id=True).run_from_stdin()
"""


def text_columns(records) -> tuple[list[str], list[str], list[str],
                                   list[str]]:
    """Per example: ins_id, label, dense and id strings of one-hot
    records (floats as the shortest repr of their f32 value, which both
    parsers read back to the same bits; signs as unsigned)."""
    for offs in records.sparse_offsets:
        check(bool(np.all(np.diff(offs) == 1)), "ingest expects one-hot")
    ins = [f"day20261016-{i:07d}" for i in range(records.num)]
    label = [repr(x) for x in records.float_values[0].tolist()]
    dense = [" ".join(r) for r in zip(*([repr(x) for x in fv.tolist()]
                                        for fv in records.float_values[1:]))]
    ids = [" ".join(r) for r in zip(*([str(x & U64) for x in v.tolist()]
                                      for v in records.sparse_values))]
    return ins, label, dense, ids


def write_ingest_files(d: str, records) -> tuple[list, list, str, int]:
    """The records as MultiSlot text with ``<ins_id>\\t`` prefixes in
    N_FILES files: the plain text of each, the filelist with GZ_FILES
    gzip-compressed, and the raw form of file 0 for the generator.
    Returns (plain, filelist, raw, text bytes)."""
    import gzip
    ins, label, dense, ids = text_columns(records)
    per = records.num // N_FILES
    plain, files, n_bytes = [], [], 0
    for f in range(N_FILES):
        rows = range(f * per, (f + 1) * per)
        text = "".join(
            f"{ins[i]}\t1 {label[i]} 1 " + dense[i].replace(" ", " 1 ")
            + " 1 " + ids[i].replace(" ", " 1 ") + "\n"
            for i in rows).encode()
        path = os.path.join(d, f"part-{f:05d}")
        with open(path, "wb") as fh:
            fh.write(text)
        plain.append(path)
        n_bytes += len(text)
        if f in GZ_FILES:
            with gzip.open(path + ".gz", "wb", compresslevel=1) as fh:
                fh.write(text)
            files.append(path + ".gz")
        else:
            files.append(path)
    raw = os.path.join(d, "raw-00000.csv")
    with open(raw, "w") as fh:
        fh.writelines(f"{ins[i]},{label[i]},{dense[i]},{ids[i]}\n"
                      for i in range(per))
    return plain, files, raw, n_bytes


def batch_bytes(ds, n_batch: int) -> list[tuple]:
    return [tuple(getattr(pb, k).tobytes()
                  for k in ("ids", "mask", "floats", "ins_id"))
            for pb in ds.batches(n_batch)]


def parse_cap_ab(paths, schema, host: str) -> None:
    """The native parser's thread cap, measured: every file parsed at
    once on its own thread, each parse on its share of the cores (what
    SlotDataset does) and uncapped (the parser's default, one thread per
    core in every call), in turns, twice each. Reading and decompressing
    are outside the timing."""
    import concurrent.futures
    from paddlebox_tpu_torch.data.dataset import parse_threads_per_file
    from paddlebox_tpu_torch.native import slot_parser
    bufs = []
    for p in paths:
        with open(p, "rb") as fh:
            bufs.append(fh.read())
    cap = parse_threads_per_file(len(bufs))
    times: dict = {cap: [], 0: []}
    with concurrent.futures.ThreadPoolExecutor(len(bufs)) as pool:
        for t in (cap, 0, 0, cap):
            t0 = time.perf_counter()
            list(pool.map(functools.partial(
                slot_parser.parse_buffer, schema=schema, with_ins_id=True,
                n_threads=t), bufs))
            times[t].append(time.perf_counter() - t0)
    print(f"  parser threads, {len(bufs)} files at once: {cap} a file "
          f"{' / '.join(f'{x:.3f}' for x in times[cap])} s, one per core "
          f"({os.cpu_count()} cores) a file "
          f"{' / '.join(f'{x:.3f}' for x in times[0])} s [{host}]")


def ingest_phase(torch, kernels, card: str, ref: dict) -> None:
    """Phase 9 on the one-hot headline. Writes phase 5's records as
    MultiSlot text (ins_id prefixes, N_FILES files, two gzip), loads
    them four ways — (a) the native parser, (b) pipe_command "cat" over
    the plain files, (c) a MultiSlotDataGenerator script as the pipe
    command over a raw form of file 0, (d) .pbar archives written by
    archive_filelist — which must pack to byte-identical batches (ids,
    mask, floats, ins_id); times each load, the archive write and the
    Python parser on one file; merge_by_ins_id(2) must drop a known
    count; one pass of BoxPS.begin_pass -> train_pass -> end_pass from
    the archives (counts reset just before and read just after) must
    agree with phase 5's in-memory pass (``ref``); a
    QueueDataset(num_threads=2) streams the files into a HeterTrainer on
    the card for one pass; its first 2 batches at prefetch_depth=1 on
    the card and on the CPU must agree. Load and parse
    numbers are host numbers taken on the card's machine."""
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.native import slot_parser
    lay = ONEHOT
    n = lay.steps * B
    print(f"== ingest, {lay.name}: {n} examples in {N_FILES} files "
          f"(files {GZ_FILES} gzip), batch {B}")
    check(slot_parser.available(),
          f"native slot parser did not build: {slot_parser.build_error()}")
    keys, rng = draw_keys(lay.n_keys)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=lay.max_len)
    records = make_records(schema, n, keys, rng, lay.max_len)
    host = f"host numbers on the card's machine ({card})"
    with tempfile.TemporaryDirectory() as d:
        _ingest(torch, kernels, card, ref, d, host, schema, records)


def _ingest(torch, kernels, card, ref, d, host, schema, records) -> None:
    from paddlebox_tpu_torch.data import (QueueDataset, SlotDataset,
                                          archive, parser)
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.native import slot_parser
    from paddlebox_tpu_torch.train import HeterConfig, HeterTrainer
    lay = ONEHOT
    n_batch = B
    n = records.num
    t0 = time.perf_counter()
    plain, files, raw, n_bytes = write_ingest_files(d, records)
    disk = sum(os.path.getsize(f) for f in files)
    print(f"ingest files: {n_bytes} bytes of text "
          f"({n_bytes / n:.1f} bytes a line), {disk} bytes on disk "
          f"with gzip, written in {time.perf_counter() - t0:.2f} s")

    def load(name, filelist, mb, **kw):
        ds = SlotDataset(schema)
        ds.with_ins_id = True
        ds.set_filelist(filelist)
        pipe = kw.pop("pipe", None)
        ds.set_pipe_command(pipe)
        ds.load_into_memory(global_shuffle=False, **kw)
        st = ds.last_load_stats
        sec = st["seconds"]
        print(f"  load {name}: {sec:.3f} s | {mb / sec / 1e6:.1f} MB/s "
              f"| {ds.num_examples / sec:.1f} examples/s | parses "
              f"native {st['native']} python {st['python']} | "
              f"{st['file_threads']} file threads x "
              f"{st['parse_threads'] or 'all'} parser threads "
              f"[{host}]")
        check(st["python"] == 0 and st["native_rejects"] == 0
              and st["parse_errors"] == 0,
              f"load {name}: the Python parser ran ({st})")
        return ds

    ds_a = load("(a) native parser", files, n_bytes)
    check(ds_a.last_load_stats["native"] == N_FILES,
          "load (a): the native parser did not parse every file")
    ds_b = load("(b) pipe_command cat", plain, n_bytes, pipe="cat")
    gen = os.path.join(d, "gen.py")
    with open(gen, "w") as fh:
        fh.write(_GENERATOR.format(
            repo=os.path.dirname(os.path.abspath(__file__)), s=S,
            d=DENSE))
    ds_c = load("(c) MultiSlotDataGenerator pipe", [raw],
                os.path.getsize(raw), pipe=f"{sys.executable} {gen}")
    t0 = time.perf_counter()
    pbars = archive.archive_filelist(files, schema,
                                     os.path.join(d, "arch"),
                                     with_ins_id=True)
    t_arch = time.perf_counter() - t0
    arch_bytes = sum(os.path.getsize(f) for f in pbars)
    print(f"  archive_filelist: {arch_bytes} bytes in {N_FILES} .pbar "
          f"({arch_bytes / n_bytes:.3f} of the text), parse + write "
          f"{t_arch:.3f} s [{host}]")
    ds_d = load("(d) .pbar archives", pbars, arch_bytes)
    check(ds_d.last_load_stats["native"] == 0, "archives were parsed")

    want = batch_bytes(ds_a, n_batch)
    check(len(want) == lay.steps, f"{len(want)} batches")
    mem = [tuple(getattr(pb, k).tobytes() for k in ("ids", "mask",
                                                     "floats"))
           for pb in (records.pack(i * n_batch, (i + 1) * n_batch)
                      for i in range(lay.steps))]
    check([w[:3] for w in want] == mem,
          "load (a) differs from the in-memory records")
    check(batch_bytes(ds_b, n_batch) == want, "load (b) differs")
    check(batch_bytes(ds_d, n_batch) == want, "load (d) differs")
    got_c = batch_bytes(ds_c, n_batch)
    check(len(got_c) == lay.steps // N_FILES
          and got_c == want[:len(got_c)], "load (c) differs")
    print(f"  loads (a) (b) (d) pack to {len(want)} byte-identical "
          f"batches, (c) to the first {len(got_c)} (ids, mask, floats, "
          f"ins_id) ok")

    parse_cap_ab(plain, schema, host)
    with open(plain[0], "rb") as fh:
        buf = fh.read()
    t0 = time.perf_counter()
    nat = slot_parser.parse_buffer(buf, schema, with_ins_id=True)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = parser._parse_python(buf.decode().splitlines(), schema, True)
    t_py = time.perf_counter() - t0
    for f in ("sparse_values", "sparse_offsets", "float_values"):
        check(all(a.tobytes() == b.tobytes() for a, b in
                  zip(getattr(nat, f), getattr(py, f))),
              f"python parser differs in {f}")
    check(nat.ins_id.tobytes() == py.ins_id.tobytes(),
          "python parser differs in ins_id")
    mb = len(buf) / 1e6
    print(f"  one file, {len(buf)} bytes: native {t_nat:.3f} s "
          f"({mb / t_nat:.1f} MB/s), python {t_py:.3f} s "
          f"({mb / t_py:.2f} MB/s): python/native {t_py / t_nat:.1f}x "
          f"[{host}]")

    # merge_by_ins_id on a copy whose ids pair up, with odd groups
    n1, n3 = MERGE_ODD
    n2 = (n - n1 - 3 * n3) // 2
    sizes = [2] * n2 + [1] * n1 + [3] * n3
    ids = np.repeat(np.arange(1, len(sizes) + 1, dtype=np.uint64), sizes)
    ds_m = SlotDataset(schema)
    ds_m.records = dataclasses.replace(
        ds_d.records, ins_id=np.random.default_rng(SEED).permutation(ids))
    t0 = time.perf_counter()
    dropped = ds_m.merge_by_ins_id(merge_size=2)
    t_merge = time.perf_counter() - t0
    check(dropped == n1 + 3 * n3 and ds_m.num_examples == n2,
          f"merge_by_ins_id dropped {dropped} ({ds_m.num_examples} left), "
          f"expected {n1 + 3 * n3} ({n2} left)")
    check(all(bool(np.all(np.diff(o) == 2))
              for o in ds_m.records.sparse_offsets),
          "merged examples do not hold two ids a slot")
    print(f"  merge_by_ins_id(merge_size=2): {n2} pairs kept, {dropped} "
          f"dropped ({n1} singletons + {n3} triples) in {t_merge:.3f} s ok")

    # one pass from the archives against the in-memory pass
    store, _, tr = make_trainer(torch, lay, n_batch, None)
    box = BoxPS(store)
    box.set_date(20261016)
    box.begin_pass()
    reset_counts(kernels)
    out = tr.train_pass(ds_d)
    launches = launch_counts(kernels)
    box.end_pass()
    print(f"  pass from the archives ({card}): steps {out['steps']} | loss "
          f"mean {out['loss_mean']:.6f} (in-memory "
          f"{ref['out']['loss_mean']:.6f}) | "
          f"{out['steps'] * n_batch / out['step_seconds']:.1f} examples/s "
          f"(step loop) | launches {launches}")
    for name, k in launches.items():
        want_k = out["steps"] if name in lay.kernels else 0
        check(k == want_k, f"archive pass launched {name} {k} times, "
              f"expected {want_k}")
    check(np.array_equal(tr.last_ws.sorted_keys, ref["keys"]),
          "archive pass: working set keys differ")
    np.testing.assert_allclose(
        [out[k] for k in ("loss_first", "loss_last", "loss_mean")],
        [ref["out"][k] for k in ("loss_first", "loss_last", "loss_mean")],
        **LOSS_TOL)
    np.testing.assert_allclose(store.get_rows(ref["keys"]), ref["rows"],
                               **TABLE_TOL)
    print("  archive pass agrees with the in-memory pass (losses within "
          "rtol 2e-4, rows within rtol 1e-3) ok")

    def heter(dev, filelist, depth, threads):
        cfg = EmbeddingConfig(dim=lay.dim, optimizer="adagrad",
                              learning_rate=0.05)
        hstore = HostEmbeddingStore(cfg)
        htr = HeterTrainer(DeepFMModel(S, lay.dim, DENSE, hidden=HIDDEN),
                           hstore, schema,
                           HeterConfig(global_batch_size=n_batch,
                                       auc_buckets=1 << 16,
                                       prefetch_depth=depth),
                           seed=SEED, device=dev)
        q = QueueDataset(schema, num_threads=threads)
        q.with_ins_id = True
        q.set_filelist(filelist)
        return hstore, htr.train_pass(q), q

    hstore, hout, q = heter(None, files, 2, 2)
    steps = hout["steps"]
    shows = float(hstore.get_rows(hstore.keys())[:, 0]
                  .astype(np.float64).sum())
    sp = hout["split"]
    print(f"  HeterTrainer, QueueDataset(num_threads=2) ({card}): steps "
          f"{steps} | loss mean {hout['loss_mean']:.6f} | auc "
          f"{hout['auc']:.6f} | {steps * n_batch / hout['step_seconds']:.1f}"
          f" examples/s (step loop) | pull {sp['pull']:.3f} s (prefetch "
          f"thread) / device {sp['device']:.3f} s / push "
          f"{sp['push']:.3f} s | {len(hstore)} keys | stream "
          f"{q.last_stream_stats}")
    check(steps == lay.steps and np.isfinite(hout["loss_mean"]),
          f"heter pass: {steps} steps, loss {hout['loss_mean']}")
    check(shows == n * S, f"heter store shows sum to {shows}, streamed "
          f"{n * S} ids")
    pair = [heter(dev, files[:1], 1, 1) for dev in (None, "cpu")]
    (s_dev, o_dev, _), (s_cpu, o_cpu, _) = pair
    check(o_dev["steps"] == o_cpu["steps"] == 2, "heter pair: steps")
    np.testing.assert_allclose(
        [o_dev[k] for k in ("loss_first", "loss_last")],
        [o_cpu[k] for k in ("loss_first", "loss_last")], **LOSS_TOL)
    hkeys = s_cpu.keys()
    np.testing.assert_allclose(s_dev.get_rows(hkeys), s_cpu.get_rows(hkeys),
                               **TABLE_TOL)
    print(f"  HeterTrainer first 2 batches, prefetch_depth=1: card loss "
          f"{o_dev['loss_last']:.6f} vs cpu "
          f"{o_cpu['loss_last']:.6f}, {len(hkeys)} rows within rtol 1e-3 ok")


# ---------------------------------------------------------------------------
# phase 10: the model zoo
# ---------------------------------------------------------------------------

# each family at its full width: bench.py's MLP (400-400-400) where the
# family has one tower, DLRM at the widths of DLRM's Criteo Kaggle script
# (bottom 13-512-256-dim, top ...-512-256-1)
ZOO = {
    "dnn_ctr": dict(hidden=HIDDEN),
    "deepfm": dict(hidden=HIDDEN),
    "wide_deep": dict(hidden=HIDDEN),
    "dcn_v2": dict(num_cross_layers=3, hidden=HIDDEN),
    "dlrm": dict(bottom_hidden=(512, 256), top_hidden=(512, 256)),
    "mmoe": dict(num_experts=4, num_tasks=2, expert_hidden=(400, 400),
                 expert_out=400, tower_hidden=(400,)),
    "pv_rank": dict(max_rank=3, slot_proj=8, att_dim=8, hidden=HIDDEN),
}
# the card-vs-CPU check's narrow widths
ZOO_NARROW = {
    "dnn_ctr": dict(hidden=(16, 16)),
    "deepfm": dict(hidden=(16, 16)),
    "wide_deep": dict(hidden=(16, 16)),
    "dcn_v2": dict(num_cross_layers=2, hidden=(16, 16)),
    "dlrm": dict(bottom_hidden=(16,), top_hidden=(16, 16)),
    "mmoe": dict(num_experts=3, num_tasks=2, expert_hidden=(16,),
                 expert_out=16, tower_hidden=(16,)),
    "pv_rank": dict(max_rank=3, slot_proj=4, att_dim=4, hidden=(16, 16)),
}
MLP_TOL = dict(rtol=2e-3, atol=2e-5)      # tests/test_torch_trainer.py
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)     # index_add_'s atomic order


def page_views(records, rng) -> None:
    """Give ``records`` page views of 1-3 ads: a shared search_id and
    ranks 1..k within each view (PV-rank's rank_offset input)."""
    n = records.num
    pv = np.repeat(np.arange(n), rng.integers(1, 4, n))[:n]
    starts = np.flatnonzero(np.r_[True, pv[1:] != pv[:-1]])
    first = np.repeat(starts, np.diff(np.r_[starts, n]))
    records.search_id = pv.astype(np.uint64)
    records.rank = (np.arange(n) - first + 1).astype(np.int32)


def zoo_trainer(name, lay, n_batch, device, widths, num_slots=S,
                optimizer="adam", **opts):
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.models import MODEL_REGISTRY
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    store = HostEmbeddingStore(EmbeddingConfig(
        dim=lay.dim, optimizer="adagrad", learning_rate=0.05))
    schema = DataFeedSchema.ctr(num_sparse=num_slots, num_float=DENSE,
                                batch_size=n_batch, max_len=lay.max_len)
    model = MODEL_REGISTRY[name](num_slots, lay.dim, DENSE, **widths[name],
                                 **opts)
    tr = Trainer(model, store, schema,
                 TrainerConfig(global_batch_size=n_batch,
                               auc_buckets=1 << 16,
                               dense_optimizer=optimizer),
                 seed=SEED, device=device)
    return store, schema, tr


def zoo_pass(torch, kernels, card, lay, name, ds, label=None,
             optimizer="adam", **opts) -> dict:
    """One 16-step pass of a family through BoxPS.begin_pass ->
    train_pass -> end_pass, counts reset just before and read just
    after; then device ms/step and host syncs on two of its batches."""
    from paddlebox_tpu_torch.fleet import BoxPS
    store, _, tr = zoo_trainer(name, lay, B, None, ZOO, optimizer=optimizer,
                               **opts)
    box = BoxPS(store)
    box.set_date(20261017)
    box.begin_pass()
    reset_counts(kernels)
    out = tr.train_pass(ds)
    launches = launch_counts(kernels)
    box.end_pass()
    steps = out["steps"]
    it = ds.batches(B)
    staged = [tr.stage(tr._pack_host(tr.last_ws, next(it)))
              for _ in range(2)]
    tr.train_step(tr.last_ws.table, *staged[0])
    top, _ = device_profile(torch, tr, staged)
    dev_ms = sum(r[0] for r in top)
    syncs = len(step_syncs(torch, tr, staged[0]))
    eps = steps * B / out["step_seconds"]
    label = label or name
    print(f"  {label}, {lay.name} ({card}): loss {out['loss_mean']:.6f} "
          f"| auc {out['auc']:.6f} | {eps:.1f} examples/s (step loop) | "
          f"device {dev_ms:.3f} ms/step | host syncs/step {syncs} | "
          f"launches {launches} | pull {tr.pull_engine} | push "
          f"{tr.resolved_push_engine(tr.last_ws)}")
    print("    largest device ops, ms/step: " + " | ".join(
        f"{ms:.3f} {op[:60]}" for ms, op in top[:4]))
    check(steps == lay.steps, f"{label}: {steps} steps, expected "
          f"{lay.steps}")
    check(np.isfinite(out["loss_mean"]), f"{label}: non-finite loss")
    check(syncs == 0, f"{label}: {syncs} host syncs in one step")
    for k, n in launches.items():
        want = steps if k in lay.kernels else 0
        check(n == want, f"{label}, {lay.name}: {k} launched {n} times in "
              f"{steps} steps, expected {want}")
    del tr, store, staged
    torch.cuda.empty_cache()
    return dict(examples_per_s=eps, device_ms=dev_ms, launches=launches)


def zoo_reference(torch, name, lay) -> str:
    """Two narrow steps of a family on the card and on the CPU (plain
    versions) from the same carried-across weights."""
    from paddlebox_tpu_torch import weights
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
    nb, n_slots = 256, 4
    rng = np.random.default_rng(SEED + 9)
    keys = rng.choice(1 << 40, 3000, replace=False).astype(np.uint64)
    runs = []
    start = None
    for device in ("cuda", "cpu"):
        store, schema, tr = zoo_trainer(name, lay, nb, device, ZOO_NARROW,
                                        num_slots=n_slots)
        if start is None:
            start = weights.model_params(tr.model)
        weights.load_model_params(tr.model, start)
        ds = SlotDataset(schema)
        records = make_records(schema, 2 * nb, keys,
                               np.random.default_rng(SEED + 10),
                               lay.max_len)
        page_views(records, np.random.default_rng(SEED + 11))
        ds.records = records
        out = tr.train_pass(ds)
        tr.flush_sparse()         # lazy write-back: rows reach the store
        runs.append((out, store.peek_rows(keys),
                     dict(flatten_tree(weights.model_params(tr.model)))))
    (gpu, g_rows, g_p), (cpu, c_rows, c_p) = runs
    np.testing.assert_allclose(gpu["loss_mean"], cpu["loss_mean"],
                               **LOSS_TOL)
    np.testing.assert_allclose(g_rows, c_rows, **TABLE_TOL)
    for k in c_p:
        np.testing.assert_allclose(g_p[k], c_p[k], err_msg=k, **MLP_TOL)
    return (f"{name} {gpu['loss_mean']:.6f} vs {cpu['loss_mean']:.6f}")


def fused_gather_check(torch, kernels, cfg, table, idx, mask) -> None:
    """fused_gather_seqpool_cvm at the multi-hot main path's shapes, on
    the card: forward (the gather_pool kernel) and the table gradient
    against the unfused plain path, fused_seqpool_cvm over a per-token
    gather (its autograd scatters with index_add_)."""
    from paddlebox_tpu_torch.embedding import sharded
    from paddlebox_tpu_torch.ops.seqpool_cvm import (
        fused_gather_seqpool_cvm, fused_seqpool_cvm)
    L = MULTI.max_len
    seg = np.repeat(np.arange(S), L)
    gen = torch.Generator(device=table.device).manual_seed(SEED + 12)
    cot = torch.randn(B, S * cfg.pull_width, generator=gen,
                      device=table.device)
    for case, kw in (("no filters", {}),
                     ("embed_threshold 0.02", dict(embed_threshold=0.02))):
        t = table.clone().requires_grad_()
        reset_counts(kernels)
        out = fused_gather_seqpool_cvm(t, idx, mask, seg, S, cfg, **kw)
        (g,) = torch.autograd.grad((out * cot).sum(), [t])
        torch.cuda.synchronize()
        n = kernels.gather_pool.launches
        tp = table.clone().requires_grad_()
        pulled = sharded.lookup(tp, torch.where(mask, idx, 0), cfg)
        want = fused_seqpool_cvm(pulled, mask, seg, S, **kw)
        (gw,) = torch.autograd.grad((want * cot).sum(), [tp])
        print(f"  fused_gather_seqpool_cvm ({case}) at (B, S, L, W) = "
              f"({B}, {S}, {L}, {table.shape[1]}): gather_pool launches "
              f"{n}")
        assert_close("  forward", out.detach(), want.detach(), GATHER_TOL)
        assert_close("  table gradient", g, gw, GRAD_TOL)
        check(n == 1, f"fused_gather_seqpool_cvm launched gather_pool {n} "
              f"times, expected 1")


def nan_guard_check(torch, card) -> None:
    """check_nan_inf on the card: a NaN put into one dense parameter
    after a clean pass trips FloatingPointError at the next step."""
    import re
    from paddlebox_tpu_torch.data import SlotDataset
    rng = np.random.default_rng(SEED + 13)
    keys = rng.choice(1 << 40, 3000, replace=False).astype(np.uint64)
    _, schema, tr = zoo_trainer("deepfm", ONEHOT, 256, None, ZOO_NARROW,
                                num_slots=4)
    tr.cfg.check_nan_inf = True
    ds = SlotDataset(schema)
    ds.records = make_records(schema, 2 * 256, keys, rng, 1)
    tr.train_pass(ds)
    with torch.no_grad():
        tr.model.mlp[0].w[1, 2] = float("nan")
    try:
        tr.train_pass(ds)
    except FloatingPointError as e:
        m = re.search(r"at step (\d+)", str(e))
        check(m is not None and int(m.group(1)) == 2,
              f"nan guard tripped at the wrong step: {e}")
        print(f"  nan guard ({card}): {str(e)[:150]}")
        return
    raise SmokeFailure("a NaN dense parameter did not trip check_nan_inf")


def zoo_phase(torch, kernels, card) -> dict:
    """Phase 10. Returns {family/layout: numbers} for the summary."""
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    from paddlebox_tpu_torch.train import optimizers
    print(f"== model zoo: {len(ZOO)} families x 2 layouts at full width, "
          f"{B} x {S} slots, {DENSE} dense, one 16-step pass each")
    numbers = {}
    onehot_ds = None
    for lay in (MULTI, ONEHOT):
        keys, rng = draw_keys(lay.n_keys)
        schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                    batch_size=B, max_len=lay.max_len)
        records = make_records(schema, lay.steps * B, keys, rng, lay.max_len)
        page_views(records, rng)
        ds = SlotDataset(schema)
        ds.records = records
        for name in ZOO:
            numbers[f"{name}/{lay.name}"] = zoo_pass(torch, kernels, card,
                                                     lay, name, ds)
        if lay is ONEHOT:
            onehot_ds = ds
            numbers[f"dlrm_bf16/{lay.name}"] = zoo_pass(
                torch, kernels, card, lay, "dlrm", ds, label="dlrm bf16",
                compute_dtype=torch.bfloat16)
    print("== dense optimizers, deepfm on onehot_dim8")
    for opt in optimizers.NAMES:
        numbers[f"deepfm+{opt}/onehot_dim8"] = zoo_pass(
            torch, kernels, card, ONEHOT, "deepfm", onehot_ds,
            label=f"deepfm + {opt}", optimizer=opt)
    print("== zoo, card vs CPU: 2 narrow steps (4 slots, dim 8, hidden 16)")
    for lay in (MULTI, ONEHOT):
        agree = [zoo_reference(torch, name, lay) for name in ZOO]
        print(f"  {lay.name}: losses (card vs CPU), rows and params within "
              f"LOSS_TOL / TABLE_TOL / MLP_TOL ok: " + " | ".join(agree))
    print("== fused_gather_seqpool_cvm at multi-hot main-path shapes")
    cfg = EmbeddingConfig(dim=MULTI.dim, optimizer="adagrad",
                          learning_rate=0.05)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    table, idx, mask = slice_inputs(torch, MULTI, cfg, torch.device("cuda"),
                                    gen)
    fused_gather_check(torch, kernels, cfg, table, idx, mask)
    del table, idx, mask
    torch.cuda.empty_cache()
    nan_guard_check(torch, card)
    return numbers


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddlebox_tpu_torch.ops import kernels

    header(torch)
    build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = kernel_phase(torch, kernels, dev, gen)
    launches = {}
    onehot_pass: dict = {}
    for lay in (MULTI, ONEHOT):
        launches.update(main_path(torch, kernels, lay,
                                  onehot_pass if lay is ONEHOT else None))
        torch.cuda.empty_cache()
    for lay in (MULTI, ONEHOT):
        reference_check(torch, lay)
    persistence_phase(torch, kernels)
    card = smi_line()
    boundary_drill(torch, card)
    boundary_trainer(torch, kernels, card)
    ingest_phase(torch, kernels, card, onehot_pass)
    zoo_phase(torch, kernels, card)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
