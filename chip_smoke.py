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
   beside the least time the card could take (bound_ms);
   binned_merge_acc also on a hot row and on per-slot Zipf keys, with
   each stream's ratio to the uniform (main-path) time;
5. each layout's main path — HostEmbeddingStore, an in-memory SlotDataset
   of 16 x 8192 examples, BoxPS.begin_pass -> Trainer.train_pass ->
   BoxPS.end_pass with every kernel's launch count reset just before and
   read just after, then a breakdown of one step (host pack, device step,
   profiler split); for the one-hot layout also the device step under
   each push engine on pre-staged batches carrying that engine's plan;
6. a small pass of each layout on the card and on the CPU (plain
   versions) must agree.

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
    distinct = int(torch.unique(idx).numel())
    ms = time_ms(lambda: kernels.gather_pool(table, idx, cfg, S, L))
    plain_ms = time_ms(lambda: kernels.gather_pool_plain(table, idx, cfg, S,
                                                         L))
    bags = idx.reshape(B * S, L).long()
    lib_out = F.embedding_bag(bags, table, mode="sum")[:, :P]
    check(max_err(lib_out.reshape(B, S, P),
                  kernels.gather_pool_plain(table, idx, cfg, S, L)) < 1e-4,
          "embedding_bag yardstick disagrees")
    lib_ms = time_ms(lambda: F.embedding_bag(bags, table, mode="sum"))
    # least work: each distinct referenced row's P columns read once, the
    # ids read once, the pooled output written once; one add per element
    n_bytes = distinct * P * 4 + idx.numel() * 4 + B * S * P * 4
    return kernel_row("gather_pool", err, ms, plain_ms, n_bytes,
                      idx.numel() * P, lib_ms, f"{distinct} distinct rows")


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
    # least work: each valid lane's row read and written once, its payload
    # read once, every lane's id read once; ~20 flops per row element
    n_bytes = u * W * 4 * 2 + u * (cfg.grad_width + 2) * 4 + n * 4
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
    lib_ms = time_ms(lambda: acc0.index_add_(0, safe, payload))
    print(f"  device grouping (argsort + searchsorted + kernel) "
          f"{ms_dev:.4f} ms")
    print(f"  streams, host plan: uniform (main path) {ms:.4f} ms | hot row "
          f"({n_pad} pad tokens on row 0, one window) {ms_pad:.4f} ms = "
          f"{ms_pad / ms:.2f}x uniform | Zipf({ZIPF_A}) per slot (hottest "
          f"row {z_hot} tokens) {ms_zipf:.4f} ms = {ms_zipf / ms:.2f}x "
          f"uniform")
    # least work: each token's id, order entry and gw + 2 payload floats
    # read once, the windows read once, the accumulator written once; one
    # add per accumulator element per token
    n_bytes = n * (4 + 4 + (gw + 2) * 4) + NB * 8 + n_rows * (gw + 3) * 4
    row = kernel_row("binned_merge_acc", err, ms, plain_ms, n_bytes,
                     n * (gw + 3), lib_ms,
                     f"{n} tokens, host plan; library = one index_add_ "
                     f"into the accumulator")
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

    scratch = table.clone()
    ms = time_ms(lambda: kernels.merge_update(scratch, acc, cfg))
    plain_ms = time_ms(lambda: kernels.merge_update_plain(scratch, acc,
                                                          cfg))
    # least work: every row's touch count read once; each touched row's
    # other acc columns read once and its table row read and written
    # once; ~20 flops per touched row element
    n_bytes = n_rows * 4 + u * (gw + 2) * 4 + u * W * 4 * 2
    return kernel_row("merge_update", err, ms, plain_ms, n_bytes, u * W * 20,
                      None, f"{u} touched of {n_rows} rows")


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
    """Criteo-shaped examples: 26 slots of 1..max_len ids drawn from the
    key set, a 25%-positive label and 13 dense floats."""
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    lens = [rng.integers(1, max_len + 1, n) for _ in range(S)]
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


def make_trainer(torch, lay, n_batch, device):
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
                 seed=SEED, device=device)
    return store, schema, tr


def main_path(torch, kernels, lay) -> dict[str, int]:
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    print(f"== main path, {lay.name}")
    rng = np.random.default_rng(SEED)
    keys = np.unique(rng.integers(1, 1 << 50, lay.n_keys + 4096,
                                  dtype=np.uint64))[:lay.n_keys]
    rng.shuffle(keys)
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
    rows = store.peek_rows(ws_keys)
    check(float(rows[:, 0].astype(np.float64).sum()) == n_tokens,
          "written-back show counters do not sum to the pass's ids")
    changed = np.any(rows != store._init_rows(ws_keys), axis=1).mean()
    check(changed > 0.99, f"only {changed:.3f} of the rows changed")
    print(f"write-back: show counters sum to {n_tokens}, "
          f"{changed * 100:.2f}% of rows changed ok")
    breakdown(torch, tr, ds, out["step_seconds"] / steps * 1e3)
    if lay is ONEHOT:
        engine_ab(torch, tr, ds)
    return {k: launches[k] for k in lay.kernels}


def breakdown(torch, tr, ds, loop_ms: float) -> None:
    """Where a main-path step's time goes: the host pack of one batch
    (translate + push plan + pin, the pack thread's work), the device
    step alone on pre-staged batches, the profiler's split of the device
    time by kernel, and the step loop of a second pass with the pack
    inline instead of on its thread. Runs after the main path's launch
    counts are read, on its last working set."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in staged:
            tr.train_step(ws.table, *s)
        torch.cuda.synchronize()
    # device-side events only: the CPU op rows repeat their kernels' time
    dev_events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and getattr(e, "self_device_time_total", 0) > 0]
    rows = sorted(((e.self_device_time_total / len(staged) / 1e3, e.key)
                   for e in dev_events), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    n_dev = sum(e.count for e in dev_events) / len(staged)
    # host syncs in one step: each one stalls the host until the device
    # drains, so the dispatch of the rest of the step cannot overlap it
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            tr.train_step(ws.table, *staged[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
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
        stores.append(store)
        engines.append(tr.resolved_push_engine(tr.last_ws))
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
    for lay in (MULTI, ONEHOT):
        launches.update(main_path(torch, kernels, lay))
        torch.cuda.empty_cache()
    for lay in (MULTI, ONEHOT):
        reference_check(torch, lay)
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
