#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddlebox_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which exits non-zero on failure:

1. header — the card (nvidia-smi name, power limit), torch, CUDA, nvcc;
2. build — both kernels from csrc/ with nvcc (in parallel) and the host
   key index with g++, timed;
3. kernels vs their plain PyTorch versions at the training step's
   shapes (Criteo-width DeepFM, batch 8192, 26 slots x 4 ids, dim 32 with
   adagrad, a 2^20-key table), edge cases included: pads, a real row-0
   lane mixed with pads, an all-pad batch, untouched rows bitwise;
4. timing — each kernel, its plain version and (where one exists) one
   PyTorch library call computing the same function, with CUDA events,
   beside the least time the card could take (bound_ms);
5. the main path — HostEmbeddingStore, an in-memory SlotDataset of
   16 x 8192 multi-hot examples (plus a small text-file parse check),
   BoxPS.begin_pass -> Trainer.train_pass -> BoxPS.end_pass with every
   kernel's launch count reset just before and read just after, then a
   breakdown of one step (host pack, device step, profiler split); then
   the same small pass on the card and on the CPU (plain versions) must
   agree.

The last lines are the kernels JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
B, S, L, DENSE = 8192, 26, 4, 13          # bench.py's Criteo DeepFM
DIM, HIDDEN = 32, (400, 400, 400)         # the multihot4_dim32 point
N_KEYS = 1 << 20
STEPS = 16
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
FP32_OPS_PER_S = 67e12
GATHER_TOL = dict(rtol=1e-6, atol=1e-6)   # test_gather_pool.py
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)  # test_scatter_accumulate.py
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/golden_deepfm.py
TABLE_TOL = dict(rtol=1e-3, atol=2e-5)

GATHER_SRC = "paddlebox_tpu_torch/csrc/gather_pool.cu"
SCATTER_SRC = "paddlebox_tpu_torch/csrc/scatter_accumulate.cu"
GATHER_TPU = "paddlebox_tpu/ops/pallas_kernels.py:854"
SCATTER_TPU = "paddlebox_tpu/ops/pallas_kernels.py:1080"


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
    """Mean ms per call over ``iters`` launches between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


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
    print(f"build: kernels {t1 - t0:.1f} s ({', '.join(sorted(paths))}), "
          f"key index {t2 - t1:.1f} s")
    for name, log in sorted(kernels.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3-4: kernels at slice shapes
# ---------------------------------------------------------------------------

def slice_inputs(torch, cfg, dev, gen):
    """A 2^20-key pass table and one batch's translated multi-hot ids
    (slot lengths 1..4 with real pad masking, as bench.py makes them)."""
    n_rows = N_KEYS + 1
    W = cfg.row_width
    table = torch.randn((n_rows, W), generator=gen, device=dev) * 0.05
    table[:, 0] = torch.randint(0, 50, (n_rows,), generator=gen, device=dev)
    table[:, 1] = torch.randint(0, 5, (n_rows,), generator=gen, device=dev)
    table[:, cfg.opt_cols] = table[:, cfg.opt_cols].abs()
    table[0] = 0.0
    lens = torch.randint(1, L + 1, (B, S, 1), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev) < lens).reshape(B, S * L)
    ids = torch.randint(1, n_rows, (B, S * L), generator=gen, device=dev)
    idx = torch.where(mask, ids, 0).to(torch.int32).contiguous()
    return table, idx, mask


def check_gather_pool(torch, kernels, cfg, table, idx) -> dict:
    import torch.nn.functional as F
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
    b_ms, b_by = bound(n_bytes, idx.numel() * P)
    print(f"  timing: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"embedding_bag {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}; "
          f"{distinct} distinct rows)")
    return dict(name="gather_pool", route="cuda", source=GATHER_SRC,
                replaces=GATHER_TPU, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def premerged_lanes(torch, table, idx, mask, cfg, gen):
    """The push operands of one step: the host dedup plan and the device
    premerge over random per-token grads (zero on masked tokens)."""
    from paddlebox_tpu_torch.embedding import sharded
    from paddlebox_tpu_torch.native.key_index import dedup_plan
    dev = table.device
    n_rows = table.shape[0]
    flat = idx.reshape(-1)
    n = flat.numel()
    maskf = mask.reshape(-1).float()
    grads = torch.randn((n, cfg.grad_width), generator=gen,
                        device=dev) * 1e-3 * maskf[:, None]
    clks = (torch.rand((n,), generator=gen, device=dev) < 0.25).float()
    o, u, s, _, _ = dedup_plan(flat.cpu().numpy(), n_rows, n_rows, 1)
    plan = tuple(torch.from_numpy(a).to(dev) for a in (o, u, s))
    return sharded.plan_premerge(flat, grads, maskf, clks * maskf, plan)


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
        c = EmbeddingConfig(dim=DIM, optimizer=opt, learning_rate=0.05)
        t = torch.randn((sub, c.row_width), generator=gen,
                        device=table.device) * 0.05
        t[:, c.opt_cols] = t[:, c.opt_cols].abs()
        t[0] = 0.0
        # lanes past the smaller table become out-of-range pads
        li = torch.where(uniq < sub, uniq, sub).to(torch.int32)
        args = (li, *lanes[1:])
        assert_close(opt, kernels.scatter_accumulate(t.clone(), *args, c),
                     kernels.scatter_accumulate_plain(t.clone(), *args, c),
                     SCATTER_TOL)

    W = table.shape[1]
    scratch = table.clone()
    ms = time_ms(lambda: kernels.scatter_accumulate(scratch, *lanes, cfg))
    plain_ms = time_ms(lambda: kernels.scatter_accumulate_plain(
        scratch, *lanes, cfg))
    n = uniq.numel()
    # least work: each valid lane's row read and written once, its payload
    # read once, every lane's id read once; ~20 flops per row element
    n_bytes = u * W * 4 * 2 + u * (cfg.grad_width + 2) * 4 + n * 4
    b_ms, b_by = bound(n_bytes, u * W * 20)
    print(f"  timing: kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | no "
          f"single PyTorch call computes this | bound {b_ms:.4f} ms "
          f"({b_by}; {u} valid of {n} lanes)")
    return dict(name="scatter_accumulate", route="cuda", source=SCATTER_SRC,
                replaces=SCATTER_TPU, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def make_records(schema, n, keys, rng):
    """Criteo-shaped multi-hot examples: 26 slots of 1..4 ids drawn from
    the key set, a 25%-positive label and 13 dense floats."""
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    lens = [rng.integers(1, L + 1, n) for _ in range(S)]
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


def make_trainer(torch, n_batch, device):
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    cfg = EmbeddingConfig(dim=DIM, optimizer="adagrad", learning_rate=0.05)
    store = HostEmbeddingStore(cfg)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=n_batch, max_len=L)
    tr = Trainer(DeepFMModel(S, DIM, DENSE, hidden=HIDDEN), store, schema,
                 TrainerConfig(global_batch_size=n_batch,
                               auc_buckets=1 << 16),
                 seed=SEED, device=device)
    return store, schema, tr


def main_path(torch, kernels) -> dict[str, int]:
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    rng = np.random.default_rng(SEED)
    keys = np.unique(rng.integers(1, 1 << 50, N_KEYS + 4096,
                                  dtype=np.uint64))[:N_KEYS]
    rng.shuffle(keys)
    store, schema, tr = make_trainer(torch, B, None)
    t0 = time.perf_counter()
    records = make_records(schema, STEPS * B, keys, rng)
    check_text_parse(schema, records)
    ds = SlotDataset(schema)
    ds.records = records
    n_tokens = int(sum(len(v) for v in records.sparse_values))
    print(f"data: {records.num} examples, {n_tokens} ids, "
          f"{time.perf_counter() - t0:.1f} s to make")
    box = BoxPS(store)
    box.set_date(20261016)
    box.begin_pass()
    kernels.gather_pool.launches = 0
    kernels.scatter_accumulate.launches = 0
    out = tr.train_pass(ds)
    launches = {"gather_pool": kernels.gather_pool.launches,
                "scatter_accumulate": kernels.scatter_accumulate.launches}
    box.end_pass()
    steps = out["steps"]
    print(f"main path: steps {steps} | loss first {out['loss_first']:.6f} "
          f"last {out['loss_last']:.6f} mean {out['loss_mean']:.6f} | auc "
          f"{out['auc']:.6f} | {steps * B / out['step_seconds']:.1f} "
          f"examples/s | step {out['step_seconds'] / steps * 1e3:.3f} ms "
          f"(step loop) | pass {out['seconds']:.2f} s | pull "
          f"{tr.pull_engine} | push {tr.resolved_push_engine(tr.last_ws)} | "
          f"working set {tr.last_ws.num_keys} keys")
    print(f"launches in the main path: {launches}")
    check(steps == STEPS, f"expected {STEPS} steps, ran {steps}")
    check(np.isfinite(out["loss_mean"]), "non-finite loss")
    for name, n in launches.items():
        check(n == steps, f"{name} launched {n} times in {steps} steps")
    ws_keys = tr.last_ws.sorted_keys
    rows = store.peek_rows(ws_keys)
    check(float(rows[:, 0].astype(np.float64).sum()) == n_tokens,
          "written-back show counters do not sum to the pass's ids")
    changed = np.any(rows != store._init_rows(ws_keys), axis=1).mean()
    check(changed > 0.99, f"only {changed:.3f} of the rows changed")
    print(f"write-back: show counters sum to {n_tokens}, "
          f"{changed * 100:.2f}% of rows changed ok")
    breakdown(torch, tr, ds, out["step_seconds"] / steps * 1e3)
    return launches


def breakdown(torch, tr, ds, loop_ms: float) -> None:
    """Where a main-path step's time goes: the host pack of one batch
    (translate + dedup plan + pin, the pack thread's work), the device
    step alone on pre-staged batches, the profiler's split of the device
    time by kernel, and the step loop of a second pass with the pack
    inline instead of on its thread. Runs after the main path's launch
    counts are read, on its last working set."""
    from torch.profiler import ProfilerActivity, profile
    from paddlebox_tpu_torch.native.key_index import dedup_plan
    ws = tr.last_ws
    n = 4
    clock = time.perf_counter
    it = ds.batches(B)
    t0 = clock()
    pbs = [next(it) for _ in range(n)]
    t1 = clock()
    idxs = [ws.translate(pb.ids, pb.mask) for pb in pbs]
    t2 = clock()
    for i in idxs:
        dedup_plan(i.reshape(-1), ws.padded_rows, ws.padded_rows, 1)
    t3 = clock()
    hosts = [tr._pack_host(ws, pb) for pb in pbs]
    t4 = clock()
    host_ms = (t4 - t3) / n * 1e3
    print(f"breakdown, host ms per batch: records.pack "
          f"{(t1 - t0) / n * 1e3:.3f} | translate {(t2 - t1) / n * 1e3:.3f} "
          f"| dedup plan {(t3 - t2) / n * 1e3:.3f} | the pack thread's "
          f"_pack_host (translate + plan + pin) {host_ms:.3f}")
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
    rows = [(getattr(e, "self_device_time_total", 0) / len(staged) / 1e3,
             e.key) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"breakdown: device step {dev_ms:.3f} ms (pre-staged, host "
          f"clock) | profiled device busy {busy_ms:.3f} ms/step | device "
          f"idle share of the main path's step loop "
          f"{1 - busy_ms / loop_ms:.3f}")
    for ms, name in rows[:12]:
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


def reference_check(torch) -> None:
    """A small pass on the card (kernels) and on the CPU (plain
    versions, the index_add push) from the same params and data."""
    from paddlebox_tpu_torch.data import SlotDataset
    nb, steps = 256, 4
    rng = np.random.default_rng(SEED + 1)
    keys = rng.choice(1 << 40, 4000, replace=False).astype(np.uint64)
    outs, stores = [], []
    for device in ("cuda", "cpu"):
        store, schema, tr = make_trainer(torch, nb, device)
        ds = SlotDataset(schema)
        ds.records = make_records(schema, nb * steps, keys,
                                  np.random.default_rng(SEED + 2))
        outs.append(tr.train_pass(ds))
        stores.append(store)
    gpu, cpu = outs
    np.testing.assert_allclose(gpu["loss_mean"], cpu["loss_mean"],
                               **LOSS_TOL)
    check(abs(gpu["auc"] - cpu["auc"]) < 1e-3, "AUC differs card vs CPU")
    np.testing.assert_allclose(stores[0].peek_rows(keys),
                               stores[1].peek_rows(keys), **TABLE_TOL)
    print(f"reference: card vs CPU on {nb * steps} examples: loss "
          f"{gpu['loss_mean']:.6f} vs {cpu['loss_mean']:.6f}, auc "
          f"{gpu['auc']:.6f} vs {cpu['auc']:.6f}, rows within rtol 1e-3 ok")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
    from paddlebox_tpu_torch.ops import kernels

    header(torch)
    build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = EmbeddingConfig(dim=DIM, optimizer="adagrad", learning_rate=0.05)
    table, idx, mask = slice_inputs(torch, cfg, dev, gen)
    rows = [check_gather_pool(torch, kernels, cfg, table, idx),
            check_scatter_accumulate(torch, kernels, cfg, table, idx, mask,
                                     gen)]
    del table, idx, mask
    launches = main_path(torch, kernels)
    reference_check(torch)
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
