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
   dense parameter;
11. the serving half and the phased loop, DeepFM at full width: (a) on
   the one-hot layout three passes through BoxPS.end_pass(trainer=,
   publisher=ServingPublisher(quant int8, publish_base_every 2,
   hot_top_k 1024)), save_inference_model of pass 2's state and
   Predictor.load on the card (its parameters and inputs must be on
   cuda) scoring a batch within MLP_TOL of the CPU Predictor, a
   ServingServer on the card whose first poll_once loads v1 (base) and
   v2 (delta) with health "ok" and served scores tracking the export's
   (Pearson > 0.98), then v3 (base); Predictor.predict at a batch split
   into host lookup, H2D and device forward; (b) 64 lone requests one
   after another (light load: one-row batches), then a BatchingFrontend(
   max_batch 1024, max_wait_s 0.002) fed single examples by 4 client
   threads (at least 16,384 requests) while pass 4's end_pass publishes
   a delta and poll_once swaps it in: 0 failures, the run ends on the
   new version; then a corrupted v5 is skipped with its CRC diagnosis
   (health "degraded") while v4 keeps serving the same scores; (c) a
   multi-hot export of a 2^20-key table scored on the card and on the
   CPU; (d) a PhasedTrainer (join DeepFM with CVM, update DeepFM
   without) for 3 one-hot passes driven by box.flip_phase(), the flip
   reusing the resident working set (0 fresh rows), and at a narrow
   width on the card and on the CPU (LOSS_TOL, TABLE_TOL); (e) an
   AucRunner (baseline + 26 slot ablations) over a 4-batch multi-hot
   eval set, and at a narrow width on the card and on the CPU (AUCs
   within 1e-3). Every training pass and the AucRunner's run is counted
   between a reset just before and a read just after (16 a one-hot pass
   for binned_merge_acc and merge_update, 4 for the 4-step multi-hot
   pass's pair, gather_pool once an eval batch: 27 x 4); the kernels
   line carries the phase's sums as phase11_launches;
12. the storage tiers, DeepFM one-hot at full width, every training pass
   counted between a reset just before and a read just after (the sums
   are the kernels line's phase12_launches): (a) phase 5's pass with
   int16 and with int8 device tables (QuantTable on the card) through
   BoxPS: binned_merge_acc 16, the other kernels 0, the table's bytes
   against f32's, loss and AUC against phase 5's, profiled device
   ms/step, and on one step's tokens binned_merge_acc beside the plain
   requant pass and the plain dequant at the gather; a small int8 pass
   on the card and on the CPU whose decoded tables agree within
   TABLE_TOL plus one quantization step; (b) three checkpointed f32
   passes on disjoint 2^19-key windows A, B, A (Zipf ids) over
   tiering.store_from_flags(table_tiering "spill", spill_cache_rows
   2^16), binned_merge_acc and merge_update 16 each a pass, agreeing
   with the same passes on a HostEmbeddingStore (TABLE_TOL, LOSS_TOL),
   printing each pass's cache hit rate, fault-in seconds, spill file
   bytes and boundary split with spill_fault_in; (c) the same with
   flags.use_replica_cache: pass 3 serves fresh keys from the replica
   and agrees with (b); (d) phase 5's pass with
   flags.transfer_compress_embedx: the build's H2D and the flush's D2H
   bytes equal transfer_bytes, the flushed rows are the bf16 rounding
   of the card's, and they agree with phase 5's rows (TABLE_TOL; embedx
   within one bf16 step more, the build having rounded the initial
   rows);
13. the monitor's write side and mid-pass snapshots, DeepFM at full
   width, every training pass counted between a reset just before and
   a read just after (the sums are the kernels line's
   phase13_launches): (a) on each layout, 16-step passes through
   BoxPS.begin_pass -> train_pass -> end_pass with the telemetry hub
   off, disabled (a session opened and closed) and on a JsonlSink,
   alternating, 3 each after a warm-up: the layout's kernels 16 each in
   every mode, the events file clean under validate_events_file, the
   flight record's steps 16 and examples 16 x 8192, trainer.tokens the
   tokens packed, 0 host syncs a step inside the loop with the hub on
   (sync-debug warnings read at each step's start), and each run's
   step-loop examples/s and host ms a batch, beside the hub's host cost
   a span and an event, disabled and on a JsonlSink; (b) on the one-hot
   layout,
   mid-pass snapshots every 4 steps of a pass, printing each save's
   seconds, bytes and stream wait; a process armed to die at
   trainer.midpass.post_save after the step-8 snapshot, resumed in a
   fresh process whose restored state (keys, rows, dense params, adam
   state, metric state, cursor) is bit-equal to the killed process's
   live state at step 8 and whose tail (binned_merge_acc and
   merge_update 8 each) ends within LOSS_TOL / TABLE_TOL of the
   uninterrupted pass; drain_and_snapshot after a pass raised at the top
   of step 7, resumed the same way; (c) start_device_trace /
   stop_device_trace (torch.profiler with CUDA activity) around one
   one-hot pass: the Chrome trace names the kernels and the pass_begin /
   pass_end markers;
14. the step's dispatch modes and remote roots, DeepFM at full width,
   every training pass counted between a reset just before and a read
   just after (the sums are the kernels line's phase14_launches): (a) on
   each layout, push overlap off and on (flags.push_overlap, read when
   the Trainer is built), a warm-up pass each then 2 alternating 16-step
   passes each: the layout's kernels 16 each and push_applies 16 (on) /
   0 (off) a pass, the two runs' losses and rows within LOSS_TOL /
   TABLE_TOL, then a profiled pass (device kernels' busy ms/step, idle
   share against the step loop) and a sync-probed pass (0 host syncs a
   step) of each, printing each run's step-loop examples/s and the
   spread; (b) the same for steps_per_dispatch 4 against 1, then a k=4
   job with mid-pass snapshots every 4 steps killed after the step-8
   snapshot and resumed in a fresh process at that dispatch boundary
   (restored state bit-equal to the killed process's live state, the
   tail launching 8 of each one-hot kernel, the finished pass within
   LOSS_TOL / TABLE_TOL of the uninterrupted one); (c) a stand-in hadoop
   CLI that this script writes, registered with init_afs_api for afs://:
   phase 5's one-hot records as a remote filelist loaded directly and
   through pipe_command "cat", both packing to byte-identical batches
   against the local load; three checkpointed one-hot passes to a
   remote PassCheckpointer root (each pass's local commit and upload),
   pass 2 resumed in a fresh process from an empty staging dir bit-equal
   to the writer's live state; a remote FleetUtil day model saved and
   loaded bit-equal; a remote serving root published to and served by a
   ServingServer staging its fetch on the card, scoring as the local
   root's server does. Prints the seconds and bytes of every upload,
   download and resume;
15. the mesh, DeepFM at full width, every training pass counted between
   a reset just before and a read just after (the sums, both ranks' in
   (b), are the kernels line's phase15_launches): (a) world 1 over NCCL:
   Trainer(mesh=make_mesh(1)) against the mesh-less trainer on the same
   16 batches of each layout, bit-equal (losses, rows, dense params;
   the one-hot pair under the deterministic scatter_accumulate engine,
   since binned_merge_acc's f32 atomics reorder sums from run to run),
   then one pass each of dense_sync_mode "kstep" (param_sync_step 4) and
   "async" on the mesh, printing losses and ms/step; (b) world 2 on the
   one card: the launcher (this script with --mesh-worker) starts two
   ranks on cuda:0 over gloo, each taking 4096 of every 8192-example
   batch, and runs the "sharded" table layout on both layouts and
   "single" on one-hot, 16 steps each, over the f32 wire: launches per
   rank (sharded: gather_pool and scatter_accumulate on multi-hot,
   scatter_accumulate on one-hot; single: binned_merge_acc and
   merge_update), 0 dropped tokens, the routed pull of a batch bit-equal
   to lookup / fused_pull_pool on the gathered table, the world's loss
   and the two shards' rows within LOSS_TOL / TABLE_TOL of a one-rank run
   of the same global batches here. Prints each rank's step ms,
   all-to-all bytes a step, the gloo exchange's host-staged ms a step
   (no NCCL number) and the routed step's share of device busy time;
16. the resilient world, DeepFM at full width, ranks started as this
   script with --resilience-worker (tests/torch_resilience_worker.py,
   no JAX) on cuda:0 with a FileStore in a temp dir, every training
   pass counted between a reset just before and a read just after (the
   sums, every rank's, are the kernels line's phase16_launches): (a)
   two ranks load halves of phase 5's one-hot records (ins_id 1..n, as
   .pbar archives) over TcpShuffleService, ins_id-routed then random:
   each round's union is the loaded multiset and every record sits on
   its route's rank; each rank trains a pass on each arrival; (b) two
   ranks write three checkpointed one-hot passes of 8 steps, rank 1's
   newest dense.npz is truncated, and fresh processes'
   Trainer.resume(collectives=) elect pass 2 on both and restore each
   rank's live pass-2 state bit for bit; (c) two ranks train member
   shards of one 2 x 16-step dataset with mid-pass snapshots every 4
   steps (steps paused 0.4 s in generation 0, lost_after 3 s); rank 1
   dies at trainer.step.pre at step 2 of pass 2; rank 0 must raise
   PeerLostError naming it, drain-snapshot mid-pass, re-form generation
   1 at world 1, resume, re-route rank 1's unconsumed tail and finish 3
   passes with every plane bit-equal to the simulated shrink (the push
   engine forced to scatter_accumulate); (d) two PSServer processes
   (python -m paddlebox_tpu_torch.distributed.ps) hold the table: three
   one-hot passes and a 4-step multi-hot pass through
   RemoteEmbeddingStore and BoxPS on the card agree with the same
   passes on a HostEmbeddingStore (LOSS_TOL / TABLE_TOL), then save ->
   shrink -> load restores the rows bit for bit. Prints each exchange's
   bytes and seconds, each save and resume, the recovery's and the
   re-formation's seconds, the heartbeat's beat gaps, and each PS pass's
   pull and write-back bytes and seconds;
17. the monitor's read side, DeepFM at full width, every kernel count
   reset just before and read just after each part (the sums, both
   ranks' in (c), are the kernels line's phase17_launches): (a) on each
   layout a 16-step pass for the step loop's wall, then
   utils.step_probe.attribute_step on one staged batch (device seconds
   by telescoping ablation, k = 1 step a timed window, 6 windows a
   stage): the launches must equal what its call counts predict
   (gather_pool 0 on one-hot), the single-step anchor within 0.5-3x of
   phase 5's profiled busy; push_floor_analysis at the card's peaks,
   the running engine's floor within 25% of phase 4's bounds of the
   same kernels, and the doctor's push-floor verdict on it; (b) five
   8-step one-hot passes over disjoint 2^19-key windows through
   BoxPS.end_pass with flags.incremental_feed off, the first four with
   the world trace, the per-pass device capture, the live doctor and
   the self-healing loop on: each capture must hold the pass's
   binned_merge_acc and merge_update launches with no capture error,
   and the boundary-wall rule's action (incremental_feed back on) must
   apply at pass 3's or 4's boundary (sustain 2; a boundary's doctor
   reads the passes before it) under the parity guard and ride its
   flight record; the fifth pass, the read side off, is the cost A/B;
   (c) two ranks on cuda:0 over gloo (this script with
   --trace-worker), one traced 8-step one-hot pass on the sharded
   layout with the heartbeat publishing every 0.2 s: the port's trace
   CLI must merge one exchange arrow a step, and the doctor CLI reads
   both roots; (d) phase 11's frontend under
   flags.serving_trace_sample = 1, 4 x 1024 requests (32 in flight a
   client) across pass 2's published delta and its swap: the serve/wait
   and serve/score spans' p50/p99, and the merged trace's publish arrow
   from the pass to the swap;
18. the serving fleet and the exported program, DeepFM one-hot at full
   width: (a) a 16-step pass publishes v1 (a base every pass, f32);
   ReplicaFleet starts two SubprocessReplica processes on the card
   (python -m paddlebox_tpu_torch.serving.fleet --serve-replica ...
   --device cuda, one CUDA context each on cuda:0) off one shared
   staging cache, behind a Router; four client threads send 128-example
   requests while a second pass publishes v2 and replica 0, armed at
   serving.fleet.replica.pre_build (after 1 hit), dies mid-swap: 0
   failed requests, 0 sheds, at least one restart, the fleet on v2, one
   verified staging copy a version, and a fleet_window record valid
   under monitor/flight.validate_fleet_record; (b) a second, shorter leg
   (4 x 100 requests) with flags.serving_hedge_factor 1.5; (c) the
   active model exported with export_stablehlo at batch 8192, loaded on
   the card, its scores equal to Predictor.predict's (rtol 1e-5, atol
   1e-6) and a torn module/meta pair rejected. Prints the router's
   p50/p99, requests, retries, hedges, the restart and convergence
   seconds, and the export's and load's seconds and a call's ms. The
   two passes are counted between a reset just before and a read just
   after (binned_merge_acc and merge_update 16 each); the serving and
   the export launch none (the sums are phase18_launches);
19. tensor, expert, sequence and pipeline parallelism, each at world 1
   over NCCL in this process and at world 2 over gloo on the one card
   (this script with --parallel-worker; NCCL refuses two ranks on one
   device), held to the port's single-device references: the TP MLP
   (dims 1024-4096-4096-1024, batch 8192), the MoE (8 experts, d_model
   1024, d_hidden 4096, 8192 tokens, top-2 at capacity factor 2.0, and
   top-1 at 0.25 whose zeroed rows must be dropped_tokens), ring and
   Ulysses attention (16 heads x 64, 16,384 causal tokens, and a bf16
   ring), GPipe (2 stages of 2 layers, width 1024, 8 microbatches of
   1024; at world 1 one stage holds all 4 layers). Forwards are held in
   f32 (bf16) at the JAX tests' tolerances; the gradients in float64
   (GRAD_DTYPE's note), attention's at 4,096 tokens (tokens cut, widths
   kept: the reference's autograd holds (S, S) scores a head). Prints
   each call's ms, the gloo staging seconds and the peak memory; no
   kernel launches (phase19_launches 0).

CHIP_SMOKE_PHASES=18,19 (comma-separated phase numbers) runs phases 1-4
and the named ones alone; phases 9, 12 and 17 read phase 5's results
and bring it with them. Unset, every phase runs. The kernels line writes
null in the launch columns of a phase that did not run.

The last lines are the kernels JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
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

# the card's peak rates and the sector size, and the device timer: one
# source with the package's step probe (its push floors use the same)
from paddlebox_tpu_torch.utils.step_probe import (FP32_OPS_PER_S,
                                                  HBM_BYTES_PER_S, SECTOR,
                                                  time_ms)

SEED = 0
B, S, DENSE = 8192, 26, 13                # bench.py's Criteo DeepFM
HIDDEN = (400, 400, 400)
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


# each layout's profiled device busy ms a step (phase 5's breakdown):
# phase 17's step attribution holds its unablated anchor against it
PHASE5_BUSY_MS: dict[str, float] = {}


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

def make_records(schema, n, keys, rng, max_len, zipf=None):
    """Criteo-shaped examples: the schema's slots (26 at full width) of
    1..max_len ids drawn from the key set, a 25%-positive label and 13
    dense floats. ``zipf``: each slot's ids a Zipf(zipf) draw over the
    keys, its ranks scattered by a permutation of its own, in place of
    uniform draws."""
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    lens = [rng.integers(1, max_len + 1, n)
            for _ in range(len(schema.sparse_slots))]
    if zipf is None:
        vals = [rng.choice(keys, int(l.sum())).astype(np.int64)
                for l in lens]
    else:
        w = 1.0 / np.arange(1, len(keys) + 1) ** zipf
        w /= w.sum()
        vals = [keys[rng.permutation(len(keys))[
            rng.choice(len(keys), int(l.sum()), p=w)]].astype(np.int64)
            for l in lens]
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


def make_trainer(torch, lay, n_batch, device, seed=SEED, storage="f32",
                 store_fn=None, steps_per_dispatch=1):
    """``store_fn(cfg)`` builds the host table (a HostEmbeddingStore by
    default)."""
    from paddlebox_tpu_torch.data import DataFeedSchema
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    cfg = EmbeddingConfig(dim=lay.dim, optimizer="adagrad",
                          learning_rate=0.05, storage=storage)
    store = (store_fn or HostEmbeddingStore)(cfg)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=n_batch, max_len=lay.max_len)
    tr = Trainer(DeepFMModel(S, lay.dim, DENSE, hidden=HIDDEN), store,
                 schema, TrainerConfig(global_batch_size=n_batch,
                                       auc_buckets=1 << 16,
                                       steps_per_dispatch=steps_per_dispatch),
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
    PHASE5_BUSY_MS[lay.name] = breakdown(torch, tr, ds,
                                         out["step_seconds"] / steps * 1e3)
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


def breakdown(torch, tr, ds, loop_ms: float) -> float:
    """Where a main-path step's time goes: the host pack of one batch
    (translate + push plan + pin, the pack thread's work), the device
    step alone on pre-staged batches, the profiler's split of the device
    time by kernel, and the step loop of a second pass with the pack
    inline instead of on its thread. Runs after the main path's launch
    counts are read, on its last working set. Returns the profiled
    device busy ms a step."""
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
    return busy_ms


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


# ---------------------------------------------------------------------------
# phase 11: the serving half and the phased loop
# ---------------------------------------------------------------------------

def request_arrays(tr, pb):
    """A packed batch as a serving request: (ids uint64, mask, dense)."""
    _, dense = tr.split_floats(pb.floats)
    return pb.ids.astype(np.uint64), pb.mask, dense


def count_pass(kernels, label, fn, want: dict):
    """Run ``fn`` with every count reset just before and read just
    after; the counts must be ``want`` (0 for a kernel it omits)."""
    reset_counts(kernels)
    out = fn()
    launches = launch_counts(kernels)
    for k, n in launches.items():
        check(n == want.get(k, 0), f"{label}: {k} launched {n} times, "
              f"expected {want.get(k, 0)}")
    return out, launches


def add_counts(total: dict, launches: dict) -> None:
    for k, n in launches.items():
        total[k] = total.get(k, 0) + n


def predict_split(torch, pred, ids, mask, dense) -> dict:
    """Predictor.predict at one batch split into its parts: the host
    lookup, the one H2D copy (host clock, synchronised), the device
    forward (CUDA events) and the whole call (host clock, D2H
    included). Medians of 5 / means of 20."""
    clock = time.perf_counter
    looks, h2ds, wholes = [], [], []
    for _ in range(5):
        t0 = clock()
        pulled = pred.table.lookup(ids, mask)
        t1 = clock()
        staged = pred.stage(pulled, mask, dense)
        torch.cuda.synchronize()
        t2 = clock()
        pred.predict(ids, mask, dense)
        t3 = clock()
        looks.append(t1 - t0)
        h2ds.append(t2 - t1)
        wholes.append(t3 - t2)
    check(all(t.is_cuda for t in staged), "predictor inputs not on cuda")
    fwd = time_ms(functools.partial(pred.forward, *staged), iters=20)
    return dict(lookup_ms=float(np.median(looks)) * 1e3,
                h2d_ms=float(np.median(h2ds)) * 1e3, forward_ms=fwd,
                predict_ms=float(np.median(wholes)) * 1e3,
                h2d_mb=sum(t.numel() * t.element_size()
                           for t in staged) / 1e6)


def frontend_load(torch, srv, tr, box, ds, pub, card) -> dict:
    """(b): a BatchingFrontend(max_batch=1024, max_wait_s=0.002) fed by 4
    client threads (each at most 256 requests in flight) with single
    examples. Once a quarter of the requests are in, pass 4's end_pass
    publishes a delta and poll_once swaps it in under the traffic; each
    client then goes on until it has sent 4096 and 256 more after the
    swap. Before the load, a light-load probe: 64 lone requests one after
    another through a frontend of their own (each scored as a one-row
    batch)."""
    import threading
    from collections import deque
    from paddlebox_tpu_torch.serving import BatchingFrontend
    it = ds.batches(B)
    reqs = [request_arrays(tr, next(it)) for _ in range(4)]
    light = BatchingFrontend(srv, max_batch=1024, max_wait_s=0.002).start()
    ids0, mask0, dense0 = reqs[0]
    light.score(ids0[0], mask0[0], dense0[0])  # first call outside timing
    lone = []
    for i in range(1, 65):
        t = time.perf_counter()
        p = light.score(ids0[i], mask0[i], dense0[i])
        lone.append((time.perf_counter() - t) * 1e3)
        check(np.isfinite(p), f"light load: non-finite score {p}")
    light.stop()
    lone_st = light.stats()
    check(lone_st["failures"] == 0 and lone_st.get("mean_batch") == 1.0,
          f"light load: {lone_st}")
    lone_p50 = float(np.median(lone))
    fe = BatchingFrontend(srv, max_batch=1024, max_wait_s=0.002).start()
    fe.score(*(a[0] for a in reqs[0]))         # first call outside timing
    swapped = threading.Event()
    sent = [0] * 4
    errors, bad = [], []
    lock = threading.Lock()

    def client(c):
        ids, mask, dense = reqs[c]
        pending, i, after = deque(), 0, 0
        deadline = time.time() + 300
        try:
            while sent[c] < 4096 or after < 256:
                check(time.time() < deadline, "frontend client timed out")
                pending.append(fe.submit(ids[i], mask[i], dense[i]))
                sent[c] += 1
                after += swapped.is_set()
                i = (i + 1) % B
                if len(pending) >= 256:
                    p = pending.popleft().result(timeout=60)
                    if not np.isfinite(p):
                        with lock:
                            bad.append(p)
            for f in pending:
                if not np.isfinite(f.result(timeout=60)):
                    with lock:
                        bad.append(f)
        except Exception as e:   # reported below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while sum(sent) < 4096 and any(t.is_alive() for t in threads):
        time.sleep(0.005)
    v_before = srv.active.version
    end = box.end_pass(trainer=tr, publisher=pub)      # pass 4: a delta
    info = end["publish"]
    check("error" not in info, f"mid-traffic publish failed: {info}")
    check(info["kind"] == "delta", f"mid-traffic publish is {info['kind']}")
    check(srv.poll_once() == 1, "mid-traffic poll_once applied nothing")
    swapped.set()
    h = srv.health()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "a client hung")
    fe.stop()
    st = fe.stats()
    n = sum(sent)
    check(not errors, f"frontend clients failed: {errors[:3]}")
    check(not bad, f"non-finite scores: {bad[:3]}")
    check(st["failures"] == 0 and st["count"] == n + 1,
          f"frontend: {st}, {n} requests sent")
    check(srv.health()["request_failures"] == 0, "server request failures")
    check(srv.active.version == info["version"] == v_before + 1,
          f"the run ended on v{srv.active.version}, published "
          f"v{info['version']}")
    check(n >= 16384, f"only {n} requests")
    print(f"  (b) light load ({card}): 64 lone requests one after another, "
          f"p50 {lone_p50:.3f} ms max {max(lone):.3f} ms (one-row batches)")
    print(f"  (b) frontend ({card}): {n} single-example requests from 4 "
          f"clients, {wall:.3f} s, {n / wall:.1f} served examples/s | "
          f"p50 {st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms max "
          f"{st['max_ms']:.3f} ms | {st['batches']} batches, mean "
          f"{st['mean_batch']} | failures {st['failures']} | mid-traffic "
          f"delta v{info['version']}: publish {info['seconds']:.3f} s "
          f"{info['bytes']} bytes ({info['keys']} keys), build "
          f"{h['last_build_seconds']:.4f} s, swap pause "
          f"{h['last_swap_pause_ms']:.3f} ms, run ended on "
          f"v{srv.active.version}")
    return dict(requests=n, seconds=wall, examples_per_s=n / wall,
                p50_ms=st["p50_ms"], p99_ms=st["p99_ms"],
                lone_p50_ms=lone_p50,
                delta_publish_s=info["seconds"],
                delta_bytes=info["bytes"],
                delta_build_s=h["last_build_seconds"],
                swap_pause_ms=h["last_swap_pause_ms"])


def serve_onehot(torch, kernels, card, total: dict) -> dict:
    """(a) and (b) on the one-hot headline."""
    import warnings
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.inference import (Predictor,
                                               save_inference_model)
    from paddlebox_tpu_torch.serving import ServingPublisher, ServingServer
    lay = ONEHOT
    keys, rng = draw_keys(lay.n_keys)
    store, schema, tr = make_trainer(torch, lay, B, None)
    ds = SlotDataset(schema)
    ds.records = make_records(schema, lay.steps * B, keys, rng, lay.max_len)
    box = BoxPS(store)
    want = {k: lay.steps for k in lay.kernels}
    numbers: dict = {}
    with tempfile.TemporaryDirectory() as d:
        root = os.path.join(d, "serve")
        pub = ServingPublisher(root, tr.model, schema, quant="int8",
                               publish_base_every=2, hot_top_k=1024)
        infos = []
        for p in range(3):
            box.begin_pass()
            out, launches = count_pass(
                kernels, f"(a) pass {p + 1}",
                functools.partial(tr.train_pass, ds), want)
            add_counts(total, launches)
            check(out["steps"] == lay.steps and np.isfinite(
                out["loss_mean"]), f"(a) pass {p + 1}: {out}")
            end = box.end_pass(trainer=tr, publisher=pub)
            info = end["publish"]
            check("error" not in info, f"publish failed: {info}")
            infos.append(info)
            print(f"  (a) pass {p + 1} ({card}): loss {out['loss_mean']:.6f}"
                  f" auc {out['auc']:.6f} | launches {launches} | publish "
                  f"v{info['version']} {info['kind']} {info['seconds']:.3f} "
                  f"s, {info['bytes']} bytes, {info['keys']} keys")
            if p == 1:
                # the export of pass 2's state, and the server loading
                # v1 (base) then v2 (delta) in one poll
                exp = os.path.join(d, "export")
                t0 = time.perf_counter()
                save_inference_model(exp, tr.model, tr.eval_params(),
                                     store, schema)
                t_exp = time.perf_counter() - t0
                pred = Predictor.load(exp)
                check(all(q.is_cuda for q in pred.model.parameters()),
                      "Predictor params are not on cuda")
                pb = next(ds.batches(B))
                ids, mask, dense = request_arrays(tr, pb)
                p_card = pred.predict(ids, mask, dense)
                p_cpu = Predictor.load(exp, device="cpu").predict(
                    ids, mask, dense)
                assert_close(f"  (a) Predictor card vs CPU, {B} one-hot",
                             torch.from_numpy(p_card),
                             torch.from_numpy(p_cpu), MLP_TOL)
                srv = ServingServer(root)
                t0 = time.perf_counter()
                check(srv.poll_once() == 2, "poll_once did not apply v1+v2")
                t_poll = time.perf_counter() - t0
                h = srv.health()
                check(h["status"] == "ok" and h["active_version"] == 2,
                      f"server health {h}")
                check(srv.active.predictor.device.type == "cuda",
                      "the server does not score on cuda")
                served = srv.predict(ids, mask, dense)
                r = float(np.corrcoef(served, p_card)[0, 1])
                check(r > 0.98, f"served vs export Pearson {r:.4f}")
                split = predict_split(torch, pred, ids, mask, dense)
                print(f"  (a) export {t_exp:.3f} s | server poll (v1 base "
                      f"+ v2 delta) {t_poll:.3f} s, build of v2 "
                      f"{h['last_build_seconds']:.4f} s | served vs "
                      f"export Pearson {r:.6f} | status {h['status']}")
                print(f"  (a) Predictor.predict at {B} one-hot ({card}): "
                      f"{split['predict_ms']:.3f} ms = host lookup "
                      f"{split['lookup_ms']:.3f} + H2D {split['h2d_ms']:.3f}"
                      f" ({split['h2d_mb']:.1f} MB) + device forward "
                      f"{split['forward_ms']:.4f} ms + D2H/overhead")
                numbers.update(export_s=t_exp, poll_s=t_poll,
                               pearson=r, predict_split_onehot=split)
            if p == 2:
                check(srv.poll_once() == 1, "the v3 base did not load")
                print(f"  (a) v3 base loaded: build "
                      f"{srv.health()['last_build_seconds']:.4f} s, swap "
                      f"pause {srv.health()['last_swap_pause_ms']:.3f} ms")
        numbers.update(base_publish_s=infos[0]["seconds"],
                       base_bytes=infos[0]["bytes"],
                       delta_publish_s_a=infos[1]["seconds"],
                       delta_bytes_a=infos[1]["bytes"])
        # (b) pass 4 trains, then its publish lands mid-traffic
        box.begin_pass()
        out, launches = count_pass(kernels, "(b) pass 4",
                                   functools.partial(tr.train_pass, ds),
                                   want)
        add_counts(total, launches)
        numbers.update(frontend_load(torch, srv, tr, box, ds, pub, card))
        # a corrupted fifth version: skipped with its CRC diagnosis while
        # the last good version keeps serving
        pb = next(ds.batches(B))
        ids, mask, dense = request_arrays(tr, pb)
        before = srv.predict(ids, mask, dense)
        good = srv.active.version
        info = pub.publish(store, tr.eval_params(), pass_id=5)
        with open(os.path.join(info["path"], "sparse.npz"), "r+b") as f:
            f.seek(4096)
            f.write(b"\xde\xad\xbe\xef")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            applied = srv.poll_once()
        h = srv.health()
        msgs = [str(w.message) for w in caught]
        check(applied == 0 and h["active_version"] == good
              and h["status"] == "degraded"
              and info["version"] in h["skipped_versions"]
              and any("crc32" in m for m in msgs),
              f"corrupt v{info['version']}: applied {applied}, health {h}, "
              f"warnings {msgs}")
        check(np.array_equal(srv.predict(ids, mask, dense), before),
              "the last good version's scores changed")
        print(f"  (a) corrupt v{info['version']} skipped: "
              f"{h['last_error'][:160]} | status {h['status']}, still "
              f"serving v{h['active_version']}")
    del tr, store, srv, pred
    torch.cuda.empty_cache()
    return numbers


def phased_check(torch, kernels, card, ds, total: dict) -> dict:
    """(d) PhasedTrainer on the one-hot layout at full width: a join
    DeepFM (use_cvm) and an update DeepFM (no CVM columns) over one
    store, 3 passes (join, update, join) driven by box.flip_phase(),
    counts reset just before and read just after each pass."""
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.fleet.boxps import JOIN_PHASE, UPDATE_PHASE
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import PhasedTrainer, TrainerConfig
    lay = ONEHOT
    store = HostEmbeddingStore(EmbeddingConfig(
        dim=lay.dim, optimizer="adagrad", learning_rate=0.05))
    cfg = TrainerConfig(global_batch_size=B, auc_buckets=1 << 16)
    pt = PhasedTrainer(DeepFMModel(S, lay.dim, DENSE, hidden=HIDDEN),
                       DeepFMModel(S, lay.dim, DENSE, hidden=HIDDEN,
                                   use_cvm=False),
                       store, ds.schema, cfg, cfg, seed=SEED)
    box = BoxPS(store)
    box.init_metric("auc_join", phase=JOIN_PHASE)
    want = {k: lay.steps for k in lay.kernels}
    outs = []
    for p in range(3):
        box.begin_pass()
        out, launches = count_pass(
            kernels, f"(d) phased pass {p + 1}",
            functools.partial(pt.train_pass, ds, box=box), want)
        add_counts(total, launches)
        box.end_pass()
        m = pt.join.feed_mgr
        print(f"  (d) pass {p + 1}, phase {out['phase']} ({card}): loss "
              f"{out['loss_mean']:.6f} auc {out['auc']:.6f} | "
              f"{out['steps'] * B / out['step_seconds']:.1f} examples/s | "
              f"fresh rows {m.last_fresh_rows} reused {m.last_reused_rows}"
              f" | launches {launches}")
        check(np.isfinite(out["loss_mean"]) and out["steps"] == lay.steps,
              f"(d) pass {p + 1}: {out}")
        if p == 1:
            check(out["phase"] == UPDATE_PHASE and m.last_fresh_rows == 0,
                  f"the flip rebuilt the working set: "
                  f"{m.last_fresh_rows} fresh rows")
        outs.append(out)
        box.flip_phase()
    check([o["phase"] for o in outs] == [JOIN_PHASE, UPDATE_PHASE,
                                         JOIN_PHASE], "phase order")
    check(box.get_metric_msg("auc_join")["size"] == 2 * lay.steps * B,
          "the join-gated metric did not see exactly the join passes")
    del pt, store
    torch.cuda.empty_cache()
    # card vs CPU at a narrow width, 2 steps a pass
    from paddlebox_tpu_torch import weights
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    nb, n_slots = 256, 4
    rng = np.random.default_rng(SEED + 20)
    keys = rng.choice(1 << 40, 3000, replace=False).astype(np.uint64)
    schema = DataFeedSchema.ctr(num_sparse=n_slots, num_float=DENSE,
                                batch_size=nb, max_len=1)
    records = make_records(schema, 2 * nb, keys,
                           np.random.default_rng(SEED + 21), 1)
    runs, start = [], None
    for device in ("cuda", "cpu"):
        st = HostEmbeddingStore(EmbeddingConfig(
            dim=lay.dim, optimizer="adagrad", learning_rate=0.05))
        c = TrainerConfig(global_batch_size=nb, auc_buckets=1 << 16)
        ptn = PhasedTrainer(DeepFMModel(n_slots, lay.dim, DENSE,
                                        hidden=(16, 16)),
                            DeepFMModel(n_slots, lay.dim, DENSE,
                                        hidden=(16, 16), use_cvm=False),
                            st, schema, c, c, seed=SEED, device=device)
        if start is None:
            start = [weights.model_params(t.model)
                     for t in (ptn.join, ptn.update)]
        for t, params in zip((ptn.join, ptn.update), start):
            weights.load_model_params(t.model, params)
        dsn = SlotDataset(schema)
        dsn.records = records
        losses = [ptn.train_pass(dsn, phase=ph)["loss_mean"]
                  for ph in (JOIN_PHASE, UPDATE_PHASE)]
        ptn.flush_sparse()
        runs.append((losses, st.peek_rows(keys)))
    (g_loss, g_rows), (c_loss, c_rows) = runs
    np.testing.assert_allclose(g_loss, c_loss, **LOSS_TOL)
    np.testing.assert_allclose(g_rows, c_rows, **TABLE_TOL)
    print(f"  (d) narrow PhasedTrainer, card vs CPU (join, update; 2 steps "
          f"each): losses {g_loss} vs {c_loss}, rows within TABLE_TOL ok")
    return dict(phased_losses=[o["loss_mean"] for o in outs])


def serve_multihot_and_auc(torch, kernels, card, total: dict) -> dict:
    """(c) the multi-hot export scored on the card and on the CPU, and (e)
    the AucRunner over a 4-batch eval set."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.inference import (Predictor,
                                               save_inference_model)
    from paddlebox_tpu_torch.metrics import AucRunner
    lay = MULTI
    keys, rng = draw_keys(lay.n_keys)
    store, schema, tr = make_trainer(torch, lay, B, None)
    store.lookup_or_init(keys)                # the whole 2^20-key table
    ds = SlotDataset(schema)
    ds.records = make_records(schema, 4 * B, keys, rng, lay.max_len)
    box = BoxPS(store)
    box.begin_pass()
    out, launches = count_pass(kernels, "(c) multi-hot pass",
                               functools.partial(tr.train_pass, ds),
                               {k: 4 for k in lay.kernels})
    add_counts(total, launches)
    box.end_pass()
    numbers: dict = {}
    with tempfile.TemporaryDirectory() as d:
        exp = os.path.join(d, "export")
        t0 = time.perf_counter()
        save_inference_model(exp, tr.model, tr.eval_params(), store, schema)
        t_exp = time.perf_counter() - t0
        pred = Predictor.load(exp)
        check(all(q.is_cuda for q in pred.model.parameters()),
              "Predictor params are not on cuda")
        check(len(pred.table) == lay.n_keys, f"export holds "
              f"{len(pred.table)} keys")
        ev = SlotDataset(schema)
        ev.records = make_records(schema, 4 * B, keys, rng, lay.max_len)
        pb = next(ev.batches(B))
        ids, mask, dense = request_arrays(tr, pb)
        p_card = pred.predict(ids, mask, dense)
        p_cpu = Predictor.load(exp, device="cpu").predict(ids, mask, dense)
        assert_close(f"  (c) Predictor card vs CPU, {B} multi-hot",
                     torch.from_numpy(p_card), torch.from_numpy(p_cpu),
                     MLP_TOL)
        split = predict_split(torch, pred, ids, mask, dense)
        print(f"  (c) multi-hot export {t_exp:.3f} s ({lay.n_keys} keys) | "
              f"Predictor.predict at {B} ({card}): "
              f"{split['predict_ms']:.3f} ms = host lookup "
              f"{split['lookup_ms']:.3f} + H2D {split['h2d_ms']:.3f} "
              f"({split['h2d_mb']:.1f} MB) + device forward "
              f"{split['forward_ms']:.4f} ms + D2H/overhead")
        numbers.update(predict_split_multihot=split)
        del pred
    # (e) the AUC runner: baseline + 26 ablations, one gather_pool launch
    # per eval batch
    runner = AucRunner(tr, seed=SEED)
    t0 = time.perf_counter()
    res, launches = count_pass(kernels, "(e) AucRunner",
                               functools.partial(runner.run, ev),
                               {"gather_pool": 27 * 4})
    t_run = time.perf_counter() - t0
    add_counts(total, launches)
    drops = {k: v["auc_drop"] for k, v in res.items() if k != "__baseline__"}
    check(len(drops) == S and all(np.isfinite(v) for v in drops.values()),
          f"AucRunner drops {drops}")
    top = sorted(drops.items(), key=lambda kv: -kv[1])[:3]
    print(f"  (e) AucRunner ({card}): baseline auc "
          f"{res['__baseline__']['auc']:.6f}, 26 ablations in {t_run:.2f} s "
          f"| gather_pool launches {launches['gather_pool']} (27 x 4 eval "
          f"batches) | largest drops " + ", ".join(
              f"{k} {v:.5f}" for k, v in top))
    numbers.update(auc_runner_s=t_run)
    del tr, store
    torch.cuda.empty_cache()
    auc_runner_reference(torch)
    return numbers


def auc_runner_reference(torch) -> None:
    """(e) at a narrow width: the card's and the CPU's AucRunner from the
    same params and table give the same per-slot AUCs (within 1e-3, the
    eval tolerance; each drop within 2e-3)."""
    from paddlebox_tpu_torch import weights
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.metrics import AucRunner
    nb, n_slots = 256, 4
    rng = np.random.default_rng(SEED + 30)
    keys = rng.choice(1 << 40, 3000, replace=False).astype(np.uint64)
    res, start = [], None
    for device in ("cuda", "cpu"):
        store, schema, tr = zoo_trainer("deepfm", MULTI, nb, device,
                                        ZOO_NARROW, num_slots=n_slots)
        if start is None:
            start = weights.model_params(tr.model)
        weights.load_model_params(tr.model, start)
        ds, ev = SlotDataset(schema), SlotDataset(schema)
        ds.records = make_records(schema, 2 * nb, keys,
                                  np.random.default_rng(SEED + 31), 4)
        ev.records = make_records(schema, 2 * nb, keys,
                                  np.random.default_rng(SEED + 32), 4)
        tr.train_pass(ds)
        res.append(AucRunner(tr, pool_size=2000, seed=SEED).run(ev))
    g, c = res
    for k in c:
        check(abs(g[k]["auc"] - c[k]["auc"]) < 1e-3, f"AucRunner {k}: "
              f"auc {g[k]['auc']} vs {c[k]['auc']}")
        if k != "__baseline__":
            check(abs(g[k]["auc_drop"] - c[k]["auc_drop"]) < 2e-3,
                  f"AucRunner {k}: drop {g[k]['auc_drop']} vs "
                  f"{c[k]['auc_drop']}")
    print("  (e) narrow AucRunner, card vs CPU: " + " | ".join(
        f"{k} {g[k]['auc_drop']:.5f} vs {c[k]['auc_drop']:.5f}"
        for k in c if k != "__baseline__") + " ok")


def serving_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 11. Returns the launches of every kernel over the phase's
    training passes and evals (each counted around its own run)."""
    from paddlebox_tpu_torch.data import SlotDataset
    print(f"== serving and the phased loop ({card}): DeepFM, {B} x {S} "
          f"slots, {DENSE} dense, MLP {HIDDEN}")
    total: dict[str, int] = {}
    numbers = serve_onehot(torch, kernels, card, total)
    keys, rng = draw_keys(ONEHOT.n_keys)
    from paddlebox_tpu_torch.data import DataFeedSchema
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=1)
    ds = SlotDataset(schema)
    ds.records = make_records(schema, ONEHOT.steps * B, keys, rng, 1)
    numbers.update(phased_check(torch, kernels, card, ds, total))
    numbers.update(serve_multihot_and_auc(torch, kernels, card, total))
    print(f"serving summary ({card}): " + json.dumps(
        numbers, default=float, sort_keys=True))
    print(f"launches in phase 11: {total}")
    return total


# ---------------------------------------------------------------------------
# phase 12: the storage tiers
# ---------------------------------------------------------------------------

def counted_pass(kernels, tr, ds, total: dict, box=None, **end_kw):
    """One train_pass with every count reset just before and read just
    after, inside BoxPS.begin_pass / end_pass(trainer=tr, **end_kw) when
    ``box`` is given; the counts add into ``total``. Returns (result,
    launches, end_pass's dict or None)."""
    if box is not None:
        box.set_date(20261017)
        box.begin_pass()
    reset_counts(kernels)
    out = tr.train_pass(ds)
    launches = launch_counts(kernels)
    add_counts(total, launches)
    end = box.end_pass(trainer=tr, **end_kw) if box is not None else None
    return out, launches, end


def expect_launches(what: str, launches: dict, want: dict) -> None:
    got = {k: launches[k] for k in SOURCES}
    full = {k: want.get(k, 0) for k in SOURCES}
    check(got == full, f"{what}: launches {got}, expected {full}")


def quant_tables(torch, kernels, card, ref, total: dict) -> None:
    """(a) One 16-step one-hot pass at int16 and at int8 through
    BoxPS.begin_pass -> train_pass -> end_pass on phase 5's records:
    binned_merge_acc 16, the other kernels 0; the device table's bytes
    against the f32 table's; loss and AUC against phase 5's f32 pass;
    device ms/step (profiler); the plain dequant-at-gather and requant
    pass timed beside binned_merge_acc on one step's tokens."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.embedding import quant, sharded
    from paddlebox_tpu_torch.embedding.working_set import device_width
    from paddlebox_tpu_torch.fleet import BoxPS
    lay = ONEHOT
    for storage in ("int16", "int8"):
        store, schema, tr = make_trainer(torch, lay, B, None,
                                         storage=storage)
        cfg = store.cfg
        ds = SlotDataset(schema)
        ds.records = ref["records"]
        out, launches, _ = counted_pass(kernels, tr, ds, total,
                                        box=BoxPS(store))
        ws = tr.last_ws
        engine = tr.resolved_push_engine(ws)
        check(quant.is_quant(ws.table)
              and ws.table.fp.device.type == "cuda"
              and ws.table.qx.dtype == getattr(torch, storage),
              f"{storage}: the card's table is not a {storage} QuantTable")
        check(engine == "binned_kernel",
              f"{storage}: the quantized one-hot push resolved {engine}, "
              f"not binned_merge_acc")
        check(out["steps"] == lay.steps and np.isfinite(out["loss_mean"]),
              f"{storage}: {out['steps']} steps, loss {out['loss_mean']}")
        expect_launches(f"{storage} pass", launches,
                        {"binned_merge_acc": lay.steps})
        q_bytes = (ws.table.fp.numel() * 4
                   + ws.table.qx.numel() * ws.table.qx.element_size())
        f32_bytes = ws.padded_rows * device_width(
            dataclasses.replace(cfg, storage="f32")) * 4
        it = ds.batches(B)
        staged = [tr.stage(tr._pack_host(ws, next(it))) for _ in range(4)]
        rows, _ = device_profile(torch, tr, staged)
        busy = sum(r[0] for r in rows)
        syncs = step_syncs(torch, tr, staged[0])
        check(not syncs, f"{storage}: {len(syncs)} host syncs in a step: "
              f"{[str(w.message)[:80] for w in syncs[:2]]}")
        f32 = ref["out"]
        print(f"  (a) {storage} pass ({card}): table {q_bytes} B (fp + qx) "
              f"vs f32 {f32_bytes} B ({q_bytes / f32_bytes:.3f}) | loss "
              f"mean {out['loss_mean']:.6f} (f32 {f32['loss_mean']:.6f}) "
              f"auc {out['auc']:.6f} (f32 {f32['auc']:.6f}) | step loop "
              f"{out['step_seconds'] / lay.steps * 1e3:.3f} ms, device "
              f"busy {busy:.3f} ms/step (profiler), host syncs/step 0 | "
              f"push {engine} | "
              f"launches {launches}")
        for ms, name in rows[:6]:
            print(f"      {ms:8.4f} ms/step  {name[:90]}")
        # one step's tokens: the binned accumulator, then the plain
        # requant pass over the planes, and the plain dequant at gather
        idx, mask, _, labels, plan, _ = staged[0]
        flat = idx.reshape(-1)
        gen = torch.Generator(device=flat.device).manual_seed(SEED)
        grads = torch.randn((flat.numel(), cfg.grad_width),
                            device=flat.device, generator=gen) * 0.01
        shows = mask.reshape(-1).to(torch.float32)
        clks = (mask * labels[:, None]).reshape(-1).to(torch.float32)
        n_rows = ws.padded_rows
        acc_ms = time_ms(lambda: kernels.binned_merge_acc(
            flat, grads, shows, clks, cfg, n_rows, plan=plan))
        acc = kernels.binned_merge_acc(flat, grads, shows, clks, cfg,
                                       n_rows, plan=plan)
        scratch = quant.QuantTable(ws.table.fp.clone(),
                                   ws.table.qx.clone())
        upd_ms = time_ms(lambda: sharded.quant_update(scratch, acc, cfg))
        pull_ms = time_ms(lambda: sharded.lookup(ws.table, idx, cfg))
        touched = int((acc[:, cfg.grad_width + 2] > 0).sum())
        print(f"  (a) {storage} push parts ({card}), one step, {touched} "
              f"touched of {n_rows} rows: binned_merge_acc {acc_ms:.4f} ms "
              f"| requant pass (plain: dequant, update, requant, where) "
              f"{upd_ms:.4f} ms | dequant at the gather (plain) "
              f"{pull_ms:.4f} ms")
        del tr, ws, staged, scratch, acc
        torch.cuda.empty_cache()
    quant_reference(torch)


def quant_reference(torch) -> None:
    """A small int8 one-hot pass on the card (binned_merge_acc, then the
    requant pass) and on the CPU (index_add_) from the same params and
    data: the decoded tables agree within TABLE_TOL plus one quantization
    step of the row (the kernel's f32 atomics reorder sums, and a code
    may round the other way)."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.embedding import quant
    nb, steps = 256, 4
    rng = np.random.default_rng(SEED + 1)
    keys = rng.choice(1 << 40, 4000, replace=False).astype(np.uint64)
    outs, rows, engines = [], [], []
    for device in ("cuda", "cpu"):
        store, schema, tr = make_trainer(torch, ONEHOT, nb, device,
                                         storage="int8")
        ds = SlotDataset(schema)
        ds.records = make_records(schema, nb * steps, keys,
                                  np.random.default_rng(SEED + 2), 1)
        outs.append(tr.train_pass(ds))
        engines.append(tr.resolved_push_engine(tr.last_ws))
        rows.append(store.get_rows(keys[np.isin(keys, store.keys())]))
    check(engines == ["binned_kernel", "xla_scatter"],
          f"int8 reference: engines {engines}")
    gpu, cpu = rows
    cfg = store.cfg
    step = np.zeros_like(cpu)
    step[:, cfg.embedx_cols] = quant.encode_rows_np(cpu, cfg)[0][:, -1:]
    err = np.abs(gpu - cpu)
    bound = TABLE_TOL["atol"] + TABLE_TOL["rtol"] * np.abs(cpu) + step
    check(gpu.shape == cpu.shape and bool((err <= bound).all()),
          f"int8 card vs CPU: decoded rows differ past TABLE_TOL plus one "
          f"quantization step (worst excess {float((err - bound).max())})")
    print(f"  (a) int8 card ({engines[0]}) vs CPU ({engines[1]}) on "
          f"{nb * steps} examples: loss {outs[0]['loss_mean']:.6f} vs "
          f"{outs[1]['loss_mean']:.6f}, decoded rows within TABLE_TOL plus "
          f"one quantization step (max abs err {float(err.max()):.3g}) ok")


def spill_tiers(torch, kernels, card, total: dict) -> None:
    """(b) Three checkpointed f32 one-hot passes on windows A, B, A
    (2^19 keys each, disjoint, each slot's ids Zipf(ZIPF_A): A's rows
    sit out pass 2 and return in pass 3) over tiering.store_from_flags with
    table_tiering="spill" and spill_cache_rows 2^16; (c) the same with
    flags.use_replica_cache. Each must agree within TABLE_TOL (losses
    LOSS_TOL) with the passes on a HostEmbeddingStore; binned_merge_acc
    and merge_update launch 16 times a pass; the replica serves pass 3's
    fresh keys."""
    import tempfile as _tf
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.embedding import tiering
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    lay, n = ONEHOT, ONEHOT.n_keys
    cache_rows = n // 8                  # 2^16 slots: an eighth of a window
    windows = (key_window(0, n, n), key_window(1, n, n),
               key_window(0, n, n))
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=1)
    # Criteo-like skew: hot keys keep their RAM and replica slots across
    # the pass they sit out (uniform keys would all rank alike)
    records = [make_records(schema, lay.steps * B, w,
                            np.random.default_rng(SEED + 40 + p), 1,
                            zipf=ZIPF_A)
               for p, w in enumerate(windows)]
    print(f"== (b, c) spill tier ({card}): {n}-key windows A, B, A "
          f"(disjoint, Zipf({ZIPF_A}) ids), spill_cache_rows {cache_rows}, "
          f"3 checkpointed passes x "
          f"{lay.steps} steps x {B}")
    saved = (flags.table_tiering, flags.spill_cache_rows, flags.spill_dir,
             flags.use_replica_cache)
    results = {}
    try:
        with _tf.TemporaryDirectory() as d:
            for name in ("host", "spill", "spill + replica"):
                flags.table_tiering = "off" if name == "host" else "spill"
                flags.spill_cache_rows = cache_rows
                flags.spill_dir = os.path.join(d, name.replace(" + ", "_"))
                flags.use_replica_cache = name == "spill + replica"
                store, _, tr = make_trainer(torch, lay, B, None,
                                            store_fn=tiering.store_from_flags)
                check((tr.table_tiering == "spill") == (name != "host"),
                      f"{name}: the trainer's table tiering is "
                      f"{tr.table_tiering}")
                box = BoxPS(store)
                ckpt = (None if name == "host" else PassCheckpointer(
                    os.path.join(d, name.replace(" + ", "_") + "_snap"),
                    base_every=2))
                losses = []
                for p, rec in enumerate(records):
                    ds = SlotDataset(schema)
                    ds.records = rec
                    f0 = tiering.fault_in_seconds(store)
                    out, launches, end = counted_pass(
                        kernels, tr, ds, total, box=box,
                        **({} if ckpt is None else {"checkpointer": ckpt,
                                                    "dataset": ds}))
                    losses.append(out["loss_mean"])
                    fm = tr.feed_mgr
                    expect_launches(f"{name}, pass {p + 1}", launches,
                                    {k: lay.steps for k in lay.kernels})
                    split = fm.last_boundary_split
                    line = (f"  ({'c' if 'replica' in name else 'b'}) {name}, "
                            f"pass {p + 1} ({card}): boundary "
                            f"{fm.last_boundary_seconds:.4f} s (build "
                            f"{split['build']:.4f} h2d {split['h2d']:.4f} "
                            f"spill_fault_in {split['spill_fault_in']:.4f})"
                            f" | fresh {fm.last_fresh_rows} reused "
                            f"{fm.last_reused_rows} replica hits "
                            f"{fm.last_replica_hits} | pass "
                            f"{out['seconds']:.3f} s, step loop "
                            f"{out['step_seconds']:.3f} s")
                    if name != "host":
                        tier = end["tiering"]
                        seen = tier["pass_hits"] + tier["pass_misses"]
                        sv = ckpt.last_save
                        line += (f" | cache hit rate "
                                 f"{tier['pass_hits'] / max(seen, 1):.4f} "
                                 f"({tier['pass_hits']}/{seen}, conflicts "
                                 f"{tier['pass_conflicts']}) | fault-in "
                                 f"{tiering.fault_in_seconds(store) - f0:.4f}"
                                 f" s over the pass and its save | spill "
                                 f"file {tier['spill_bytes']} B | save "
                                 f"{'base' if sv['rotated'] else 'delta'} "
                                 f"{sv['sparse_seconds']:.3f} s, flush "
                                 f"{sv['flush_seconds']:.3f} s")
                    print(line)
                    if name == "spill + replica" and p == 2:
                        check(fm.last_replica_hits > 0,
                              "(c) pass 3 served no fresh key from the "
                              "replica tier")
                    if name != "spill + replica":
                        check(fm.last_replica_hits == 0,
                              f"{name}: replica hits without the tier")
                tr.flush_sparse()
                keys = np.sort(store.keys())
                results[name] = (keys, store.get_rows(keys), losses)
                if name != "host":
                    print(f"  {name} totals ({card}): "
                          f"{json.dumps(tiering.spill_stats(store))} | "
                          f"replica refreshes "
                          f"{getattr(tr.replica_cache, 'refreshes', 0)}")
                del tr
                torch.cuda.empty_cache()
    finally:
        (flags.table_tiering, flags.spill_cache_rows, flags.spill_dir,
         flags.use_replica_cache) = saved
    for name, ref in (("spill", "host"), ("spill + replica", "spill")):
        keys, rows, losses = results[name]
        rkeys, rrows, rlosses = results[ref]
        check(np.array_equal(keys, rkeys),
              f"{name}: store keys differ from {ref}'s")
        np.testing.assert_allclose(rows, rrows, **TABLE_TOL)
        np.testing.assert_allclose(losses, rlosses, **LOSS_TOL)
    print(f"(b, c) spill and spill + replica agree with the host store and "
          f"each other ({len(results['host'][0])} keys, rows within rtol "
          f"1e-3, losses within rtol 2e-4) ok")


def compressed_transfer(torch, kernels, card, ref, total: dict) -> None:
    """(d) Phase 5's one-hot pass with flags.transfer_compress_embedx: the
    H2D bytes of the build and the D2H bytes of the flush equal
    transfer_bytes; the flushed host rows are the bf16 rounding of the
    card's rows; against phase 5's uncompressed rows, every column but
    embedx within TABLE_TOL and embedx within TABLE_TOL of the bf16
    rounding plus one bf16 step (the build rounded the initial rows
    too)."""
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.embedding.working_set import transfer_bytes
    from paddlebox_tpu_torch.fleet import BoxPS
    lay = ONEHOT
    saved = flags.transfer_compress_embedx
    flags.transfer_compress_embedx = True
    try:
        store, schema, tr = make_trainer(torch, lay, B, None)
        cfg = store.cfg
        ds = SlotDataset(schema)
        ds.records = ref["records"]
        out, launches, _ = counted_pass(kernels, tr, ds, total,
                                        box=BoxPS(store))
        fm, ws = tr.feed_mgr, tr.last_ws
        h2d = fm.last_h2d_bytes
        check(h2d == transfer_bytes(cfg, ws.padded_rows),
              f"(d) H2D {h2d} B, transfer_bytes says "
              f"{transfer_bytes(cfg, ws.padded_rows)}")
        expect_launches("(d) pass", launches,
                        {k: lay.steps for k in lay.kernels})
        sel = np.flatnonzero(ws.touched[1:1 + ws.num_keys]) + 1
        card_rows = ws.table[torch.from_numpy(sel).to(ws.table.device),
                             :cfg.row_width].cpu()
        t0 = time.perf_counter()
        d2h = tr.flush_sparse()
        flush_s = time.perf_counter() - t0
        want_d2h = transfer_bytes(cfg, len(sel))
    finally:
        flags.transfer_compress_embedx = saved
    check(d2h == want_d2h,
          f"(d) D2H {d2h} B, transfer_bytes says {want_d2h}")
    e = cfg.embedx_cols
    rows = store.get_rows(ws.sorted_keys[sel - 1])
    want = card_rows.numpy().copy()
    want[:, e] = card_rows[:, e].to(torch.bfloat16).float().numpy()
    check(np.array_equal(rows, want),
          "(d) flushed rows are not the bf16 rounding of the card's rows")
    check(np.array_equal(ws.sorted_keys, ref["keys"]),
          "(d) the working set differs from phase 5's")
    u = ref["rows"][sel - 1]
    rest = np.ones(cfg.row_width, bool)
    rest[e] = False
    np.testing.assert_allclose(rows[:, rest], u[:, rest], **TABLE_TOL)
    ub = torch.from_numpy(np.ascontiguousarray(u[:, e])).to(
        torch.bfloat16).float().numpy()
    err = np.abs(rows[:, e] - ub)
    bound = (TABLE_TOL["atol"] + TABLE_TOL["rtol"] * np.abs(ub)
             + np.abs(ub) * 2.0 ** -7)
    check(bool((err <= bound).all()),
          f"(d) embedx past the bf16 bound (worst excess "
          f"{float((err - bound).max())})")
    f32 = ref["out"]
    print(f"  (d) bf16 transfer ({card}): H2D {h2d} B for {ws.padded_rows} "
          f"rows (f32 {ws.padded_rows * cfg.row_width * 4} B) | flush D2H "
          f"{d2h} B for {len(sel)} rows in {flush_s:.3f} s | loss mean "
          f"{out['loss_mean']:.6f} (f32 {f32['loss_mean']:.6f}) auc "
          f"{out['auc']:.6f} (f32 {f32['auc']:.6f}) | boundary "
          f"{fm.last_boundary_seconds:.4f} s | rows: bf16 of the card's "
          f"exactly, vs phase 5's embedx max abs err {float(err.max()):.3g}"
          f" ok")


def storage_phase(torch, kernels, card, ref) -> dict[str, int]:
    """Phase 12. ``ref`` holds phase 5's one-hot pass (result, keys,
    rows). Returns the launches of every kernel over the phase's training
    passes (each counted around its own pass)."""
    from paddlebox_tpu_torch.data import DataFeedSchema
    print(f"== storage tiers ({card}): DeepFM one-hot, {B} x {S} slots, "
          f"dim {ONEHOT.dim}, {ONEHOT.n_keys} keys")
    keys, rng = draw_keys(ONEHOT.n_keys)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=1)
    ref = dict(ref, records=make_records(schema, ONEHOT.steps * B, keys,
                                         rng, 1))
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    quant_tables(torch, kernels, card, ref, total)
    t1 = time.perf_counter()
    spill_tiers(torch, kernels, card, total)
    t2 = time.perf_counter()
    compressed_transfer(torch, kernels, card, ref, total)
    t3 = time.perf_counter()
    print(f"launches in phase 12: {total} | seconds: quantized "
          f"{t1 - t0:.1f}, spill + replica {t2 - t1:.1f}, bf16 "
          f"{t3 - t2:.1f}")
    return total


# ---------------------------------------------------------------------------
# phase 13: the monitor's write side and mid-pass snapshots
# ---------------------------------------------------------------------------

MIDPASS_EVERY = 4          # (b): snapshots at steps 4, 8, 12, 16
MIDPASS_KILL_STEP = 8      # the killed process dies after this snapshot
DRAIN_STEP = 6             # the drained pass raises at the top of step 7


def monitor_job(torch, lay, n_steps=None, seed=SEED, steps_per_dispatch=1):
    """A fresh job on ``lay`` at full width: (store, schema, trainer, box
    with an "auc" metric, dataset of ``n_steps`` batches). The keys and
    records depend only on the layout, so another process rebuilds the
    same job."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    n_steps = n_steps or lay.steps
    rng = np.random.default_rng(SEED + 13)
    keys = np.unique(rng.integers(1, 1 << 50, lay.n_keys + 4096,
                                  dtype=np.uint64))[:lay.n_keys]
    store, schema, tr = make_trainer(torch, lay, B, None, seed=seed,
                                     steps_per_dispatch=steps_per_dispatch)
    box = BoxPS(store)
    box.init_metric("auc")
    ds = SlotDataset(schema)
    ds.records = make_records(schema, n_steps * B, keys,
                              np.random.default_rng(SEED + 14),
                              lay.max_len)
    return store, schema, tr, box, ds


class StopAfter:
    """A dataset whose batch stream raises after ``n`` batches: the error
    reaches the step loop from the pack thread at the top of step n+1."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def unique_keys(self):
        return self.ds.unique_keys()

    def batches(self, batch_size=None, drop_last=True):
        for i, pb in enumerate(self.ds.batches(batch_size, drop_last)):
            if i == self.n:
                raise RuntimeError(f"input stream broke at batch {i}")
            yield pb


def live_state(tr, box) -> dict:
    """The job's state read straight off the card: the working set's
    rows (D2H of the device table), the dense params and optimizer
    state, the metric state and the step."""
    from paddlebox_tpu_torch.embedding.working_set import fetch_rows
    ws = tr.last_ws
    rows, _ = fetch_rows(ws.table, np.arange(1, ws.num_keys + 1),
                         tr.store.cfg)
    return dict(keys=ws.sorted_keys.copy(), rows=rows,
                dense=flat_dense(tr), metrics=metric_state(box),
                step=tr.global_step)


def save_state(path: str, st: dict, extra: dict | None = None) -> None:
    arrays = {"keys": st["keys"], "rows": st["rows"]}
    arrays.update({"dense/" + k: v for k, v in st["dense"].items()})
    arrays.update({"metric/" + k: v for k, v in st["metrics"].items()})
    np.savez(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"step": int(st["step"]), **(extra or {})}, f)


def load_state(path: str) -> tuple[dict, dict]:
    with np.load(path + ".npz") as z:
        st = dict(keys=z["keys"], rows=z["rows"],
                  dense={k[6:]: z[k] for k in z.files
                         if k.startswith("dense/")},
                  metrics={k[7:]: z[k] for k in z.files
                           if k.startswith("metric/")})
    with open(path + ".json") as f:
        meta = json.load(f)
    st["step"] = meta["step"]
    return st, meta


def same_state(got: dict, want: dict) -> bool:
    """Bit-equality of two states, the store as a key -> row map."""
    go, wo = np.argsort(got["keys"]), np.argsort(want["keys"])
    return (np.array_equal(got["keys"][go], want["keys"][wo])
            and np.array_equal(got["rows"][go], want["rows"][wo])
            and sorted(got["dense"]) == sorted(want["dense"])
            and all(got["dense"][k].dtype == v.dtype
                    and np.array_equal(got["dense"][k], v)
                    for k, v in want["dense"].items())
            and sorted(got["metrics"]) == sorted(want["metrics"])
            and all(np.array_equal(got["metrics"][k], v)
                    for k, v in want["metrics"].items())
            and int(got["step"]) == int(want["step"]))


def midpass_worker(argv: list[str]) -> int:
    """``chip_smoke.py --midpass-worker kill ROOT`` trains the phase-13
    one-hot pass with mid-pass snapshots every MIDPASS_EVERY steps; the
    environment arms trainer.midpass.post_save, so it dies there, after
    writing its live state at the MIDPASS_KILL_STEP snapshot (read off
    the card once the snapshot committed) to ROOT.live;
    ``... resume ROOT OUT`` resumes ROOT's newest snapshot in a fresh
    job, writes the restored state to OUT, finishes the pass with
    skip_steps = the cursor's mid_steps and writes the final rows, loss
    and the tail's launches to OUT.final."""
    import torch
    from paddlebox_tpu_torch.ops import kernels
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    mode, root = argv[0], argv[1]
    # phase 14 (b) runs the same job as a superstep
    k = int(os.environ.get("CHIP_SMOKE_STEPS_PER_DISPATCH", "1"))
    store, _, tr, box, ds = monitor_job(torch, ONEHOT, seed=SEED + 7,
                                        steps_per_dispatch=k)
    ckpt = PassCheckpointer(root, base_every=2)
    if mode == "kill":
        tr.enable_midpass_snapshots(ckpt, MIDPASS_EVERY, box,
                                    metrics=box.metrics)
        inner = tr._snapshot_open_pass

        def capture(*a, **kw):
            info = inner(*a, **kw)
            if info["mid_steps"] == MIDPASS_KILL_STEP:
                save_state(root + ".live", live_state(tr, box))
            return info

        tr._snapshot_open_pass = capture
        box.set_date(20261017)
        box.begin_pass()
        tr.train_pass(ds, metrics=box.metrics)
        print("midpass worker: the pass ended without the kill")
        return 1
    out_path = argv[2]
    cursor = tr.resume(ckpt, box=box)
    keys = np.sort(ds.unique_keys())
    restored = dict(keys=keys, rows=store.get_rows(keys),
                    dense=flat_dense(tr), metrics=metric_state(box),
                    step=tr.global_step)
    save_state(out_path, restored, {
        "cursor": {k: cursor[k] for k in ("pass_id", "mid_steps",
                                          "global_step")},
        "resume_s": ckpt.last_resume["seconds"],
        "resume_bytes": ckpt.last_resume["bytes"],
        "on_card": next(tr.model.parameters()).device.type == "cuda"})
    box.begin_pass()
    reset_counts(kernels)
    out = tr.train_pass(ds, metrics=box.metrics,
                        skip_steps=cursor["mid_steps"])
    launches = launch_counts(kernels)
    box.end_pass()
    final = dict(keys=keys, rows=store.get_rows(keys), dense=flat_dense(tr),
                 metrics=metric_state(box), step=tr.global_step)
    save_state(out_path + ".final", final, {
        "launches": launches, "steps": out["steps"],
        "loss_last": out["loss_last"]})
    return 0


def run_worker(args: list[str], env_extra: dict | None = None):
    env = dict(os.environ)
    env.pop("PBTPU_FAULTPOINT", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--midpass-worker", *args],
                          capture_output=True, text=True, timeout=600,
                          env=env)


def pass_loop_syncs(torch, tr, box, ds) -> float:
    """Host syncs a step makes inside train_pass's loop, spans, timers,
    counters and the hub's sinks included: the sync-debug warnings over
    a whole pass, read at each train_step's start, from step 2's to step
    16's, per step."""
    import warnings
    marks = []
    inner = tr.train_step

    def marked(*a, **kw):
        marks.append(len(caught))
        return inner(*a, **kw)

    tr.train_step = marked
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            box.begin_pass()
            tr.train_pass(ds, metrics=box.metrics)
            box.end_pass()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del tr.train_step
    check(len(marks) == 16, f"sync probe saw {len(marks)} steps")
    return (marks[-1] - marks[1]) / (len(marks) - 2)


def hub_modes(torch, kernels, card, lay, total: dict) -> None:
    """(a) on one layout: 16-step passes through BoxPS with the hub off
    (never enabled), disabled (a session opened and closed) and on with a
    JsonlSink, alternating, 3 each after a warm-up pass."""
    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.monitor import flight
    h = monitor.hub()
    h.disable()
    store, schema, tr, box, ds = monitor_job(torch, lay)
    box.set_date(20261017)
    n_tok = 16 * B * tr.layout.total_len
    runs: dict[str, list] = {"off": [], "disabled": [], "jsonl": []}
    with tempfile.TemporaryDirectory() as d:
        for i, mode in enumerate(["warm-up"] + ["off", "disabled",
                                                "jsonl"] * 3):
            path = os.path.join(d, f"events-{i}.jsonl")
            if mode == "disabled":
                h.enable(monitor.MemorySink())
                h.disable()
            elif mode == "jsonl":
                h.enable(monitor.JsonlSink(path))
            stage0 = tr.timers.snapshot()
            box.begin_pass()
            reset_counts(kernels)
            out = tr.train_pass(ds, metrics=box.metrics)
            launches = launch_counts(kernels)
            rec = box.end_pass()["flight_record"]
            h.disable()
            add_counts(total, launches)
            expect_launches(f"(a) {lay.name} {mode} pass", launches,
                            {k: 16 for k in lay.kernels})
            check(out["steps"] == 16, f"(a) {mode}: {out['steps']} steps")
            if mode == "warm-up":
                continue
            tr_ms = (tr.timers.total["translate"] - stage0["translate"]) \
                / 16 * 1e3
            rd_ms = (tr.timers.total["read"] - stage0["read"]) / 16 * 1e3
            runs[mode].append((16 * B / out["step_seconds"], tr_ms, rd_ms))
            if mode != "jsonl":
                check(not os.path.exists(path), "a sink wrote while off")
                continue
            res = flight.validate_events_file(path)
            check(res["errors"] == [], f"(a) events file: {res['errors'][:5]}")
            fr = res["flight_records"]
            check(len(fr) == 1 and flight.validate_flight_record(rec) == []
                  and fr[0]["pass_id"] == rec["pass_id"],
                  f"(a) flight records {len(fr)}")
            fr = fr[0]
            check(fr["steps"] == 16 and fr["examples"] == 16 * B,
                  f"(a) flight record steps {fr['steps']} examples "
                  f"{fr['examples']}")
            got = fr["stats_delta"].get("trainer.tokens")
            check(got == n_tok, f"(a) trainer.tokens {got}, packed {n_tok}")
            names = collections.Counter(
                r["name"] for r in map(json.loads, open(path))
                if r["type"] in ("span", "event", "lifecycle"))
            check(names["train_step"] == 16 and names["stage/translate"] == 16,
                  f"(a) span counts {dict(names)}")
        h.enable(monitor.JsonlSink(os.path.join(d, "sync-probe.jsonl")))
        try:
            syncs = pass_loop_syncs(torch, tr, box, ds)
        finally:
            h.disable()
    check(syncs == 0, f"(a) {lay.name}: {syncs} host syncs a step with the "
          f"hub on a JsonlSink")
    print(f"  (a) {lay.name} ({card}): 16-step passes, launches "
          f"{ {k: 16 for k in lay.kernels} } in every mode, flight record "
          f"steps 16 examples {16 * B}, trainer.tokens {n_tok}, "
          f"validate_events_file 0 problems, host syncs/step with the hub "
          f"on {syncs:g}")
    for mode, rs in runs.items():
        eps = [r[0] for r in rs]
        print(f"  (a) {lay.name}, hub {mode} ({card}): step-loop ex/s "
              f"{', '.join(f'{x:.1f}' for x in eps)} (spread "
              f"{min(eps):.1f}-{max(eps):.1f}) | host translate ms/batch "
              f"{', '.join(f'{r[1]:.2f}' for r in rs)} | step-thread read "
              f"wait ms/step {', '.join(f'{r[2]:.2f}' for r in rs)}")
    del store, tr, box, ds
    torch.cuda.empty_cache()


def hold_resumed(d, root, want, skip, label, ref, total, card,
                 env_extra=None, tag="(b)") -> None:
    """Resume ``root``'s newest snapshot in a fresh process (a midpass
    worker), hold its restored state bit-equal to ``want`` (the live
    state at step ``skip``) and its finished pass against the
    uninterrupted one, ``ref`` = (keys, final rows, pass result), within
    LOSS_TOL / TABLE_TOL."""
    lay = ONEHOT
    keys, final_u, out_u = ref
    out = os.path.join(d, f"resumed-{label.replace(' ', '-')}")
    t0 = time.perf_counter()
    r = run_worker(["resume", root, out], env_extra)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{tag} {label} resume worker failed "
          f"({r.returncode}): {r.stdout[-1500:]}{r.stderr[-3000:]}")
    restored, meta = load_state(out)
    cur = meta["cursor"]
    check(cur["pass_id"] == 0 and cur["mid_steps"] == skip
          and cur["global_step"] == skip and meta["on_card"],
          f"{tag} {label}: cursor {cur}")
    check(same_state(restored, want),
          f"{tag} {label}: the restored state differs from the live one "
          f"at step {skip}")
    final, fmeta = load_state(out + ".final")
    expect_launches(f"{tag} {label} resumed tail", fmeta["launches"],
                    {k: 16 - skip for k in lay.kernels})
    add_counts(total, fmeta["launches"])
    check(fmeta["steps"] == 16 - skip, f"{tag} {label}: tail ran "
          f"{fmeta['steps']} steps")
    check(np.array_equal(final["keys"], keys), f"{tag} {label}: keys")
    np.testing.assert_allclose(final["rows"], final_u, **TABLE_TOL)
    np.testing.assert_allclose(fmeta["loss_last"], out_u["loss_last"],
                               **LOSS_TOL)
    print(f"  {tag} {label} ({card}): resumed in a fresh process "
          f"({wall:.1f} s wall) from {meta['resume_bytes']} bytes in "
          f"{meta['resume_s']:.3f} s; keys, rows, dense params, adam "
          f"state, metric state and cursor bit-equal to the live state "
          f"at step {skip} ok; tail of {16 - skip} steps launched "
          f"{fmeta['launches']}; loss last {fmeta['loss_last']:.6f} vs "
          f"{out_u['loss_last']:.6f}, rows within TABLE_TOL ok")


def midpass_snapshots(torch, kernels, card, total: dict, d: str) -> None:
    """(b) mid-pass snapshots every MIDPASS_EVERY steps on the one-hot
    layout: an uninterrupted pass, a process killed after the step-8
    snapshot and resumed in another (its restored state held bit-equal
    to the killed process's live state at that step, the finished pass
    to the uninterrupted one within LOSS_TOL / TABLE_TOL), and
    drain_and_snapshot after a pass raised at step 7, resumed the same
    way."""
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    lay = ONEHOT
    root_u = os.path.join(d, "uninterrupted")
    store, _, tr, box, ds = monitor_job(torch, lay, seed=SEED + 7)
    ckpt = PassCheckpointer(root_u, base_every=2)
    tr.enable_midpass_snapshots(ckpt, MIDPASS_EVERY, box,
                                metrics=box.metrics)
    box.set_date(20261017)
    box.begin_pass()
    reset_counts(kernels)
    out_u = tr.train_pass(ds, metrics=box.metrics)
    launches = launch_counts(kernels)
    box.end_pass()
    add_counts(total, launches)
    expect_launches("(b) uninterrupted pass", launches,
                    {k: 16 for k in lay.kernels})
    keys = np.sort(ds.unique_keys())
    final_u = store.get_rows(keys)
    saves = tr.midpass_saves
    check([s["mid_steps"] for s in saves] == [4, 8, 12, 16],
          f"(b) mid-pass saves at {[s['mid_steps'] for s in saves]}")
    for s in saves:
        print(f"  (b) mid-pass save at step {s['mid_steps']} ({card}): "
              f"{os.path.basename(s['snapshot'])} {s['bytes']} bytes in "
              f"{s['seconds']:.3f} s, stream wait {s['stream_wait_s'] * 1e3:.3f}"
              f" ms | step loop {out_u['step_seconds']:.3f} s for 16 steps "
              f"with the saves")

    root_k = os.path.join(d, "killed")
    r = run_worker(["kill", root_k], {
        "PBTPU_FAULTPOINT": "trainer.midpass.post_save",
        "PBTPU_FAULTPOINT_AFTER": str(MIDPASS_KILL_STEP // MIDPASS_EVERY
                                      - 1)})
    check(r.returncode == 137 and "FAULTPOINT KILL trainer.midpass.post_save"
          in r.stderr, f"(b) kill worker exited {r.returncode}: "
          f"{r.stdout[-1500:]}{r.stderr[-3000:]}")
    names = sorted(n for n in os.listdir(root_k) if n.startswith("pass-"))
    check(names == ["pass-00000.mid00004", "pass-00000.mid00008"],
          f"(b) the killed run left {names}")
    live, _ = load_state(root_k + ".live")
    check(live["step"] == MIDPASS_KILL_STEP, "(b) the killed run's live "
          f"state is from step {live['step']}")
    hold_resumed(d, root_k, live, MIDPASS_KILL_STEP, "killed at step 8",
                 (keys, final_u, out_u), total, card)
    del store, tr, box
    torch.cuda.empty_cache()

    # drain_and_snapshot after the pass raised at the top of step 7
    root_d = os.path.join(d, "drained")
    store, _, tr, box, ds = monitor_job(torch, lay, seed=SEED + 7)
    ckpt = PassCheckpointer(root_d, base_every=2)
    box.set_date(20261017)
    box.begin_pass()
    reset_counts(kernels)
    try:
        tr.train_pass(StopAfter(ds, DRAIN_STEP), metrics=box.metrics)
        raise SmokeFailure("(b) the drained pass did not raise")
    except RuntimeError as e:
        check("input stream broke" in str(e), f"(b) drained pass: {e!r}")
    launches = launch_counts(kernels)
    add_counts(total, launches)
    expect_launches("(b) drained pass", launches,
                    {k: DRAIN_STEP for k in lay.kernels})
    at_drain = live_state(tr, box)
    snap = tr.drain_and_snapshot(ckpt, box)
    info = tr.midpass_saves[-1]
    box.abort_pass("input stream broke")
    check(snap is not None and os.path.basename(snap)
          == f"pass-00000.mid{DRAIN_STEP:05d}", f"(b) drain snapshot {snap}")
    print(f"  (b) drain_and_snapshot after the raise at step "
          f"{DRAIN_STEP + 1} ({card}): {os.path.basename(snap)} "
          f"{info['bytes']} bytes in {info['seconds']:.3f} s, stream wait "
          f"{info['stream_wait_s'] * 1e3:.3f} ms")
    del store, tr, box
    torch.cuda.empty_cache()
    hold_resumed(d, root_d, at_drain, DRAIN_STEP, "drained at step 6",
                 (keys, final_u, out_u), total, card)


def device_trace(torch, kernels, card, total: dict, d: str) -> None:
    """(c) start_device_trace / stop_device_trace around one one-hot
    pass: the Chrome trace names the CUDA kernels and the pass markers."""
    from paddlebox_tpu_torch.utils import profiler
    store, _, tr, box, ds = monitor_job(torch, ONEHOT)
    box.set_date(20261017)
    logdir = os.path.join(d, "device-trace")
    t0 = time.perf_counter()
    profiler.start_device_trace(logdir)
    box.begin_pass()
    reset_counts(kernels)
    tr.train_pass(ds, metrics=box.metrics)
    launches = launch_counts(kernels)
    box.end_pass()
    path = profiler.stop_device_trace()
    wall = time.perf_counter() - t0
    add_counts(total, launches)
    expect_launches("(c) traced pass", launches,
                    {k: 16 for k in ONEHOT.kernels})
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    names = [str(e.get("name", "")) for e in evs]
    kern = [n for n in names if "binned_merge_acc_kernel" in n]
    mu = [n for n in names if "merge_update_kernel" in n]
    check(len(kern) >= 16 and len(mu) >= 16, f"(c) the trace holds "
          f"{len(kern)} binned_merge_acc and {len(mu)} merge_update kernels")
    check("pass_begin" in names and "pass_end" in names,
          "(c) the trace lacks the pass_begin / pass_end markers")
    print(f"  (c) device trace ({card}): {os.path.getsize(path)} bytes, "
          f"{len(evs)} events, {len(kern)} binned_merge_acc_kernel and "
          f"{len(mu)} merge_update_kernel launches, pass_begin and "
          f"pass_end markers ok ({wall:.1f} s traced pass)")


def hub_cost(card: str, d: str) -> None:
    """The hub's host cost a record on this machine: a span scope and an
    event, 20,000 each inside a pass scope, with the hub disabled and on
    a JsonlSink (queue large enough to drop nothing), and what a step's
    6 records (5 spans and the pack thread's stage/translate) cost."""
    from paddlebox_tpu_torch import monitor
    h = monitor.hub()
    n = 20000

    def per_call() -> tuple[float, float]:
        t0 = time.perf_counter()
        for _ in range(n):
            with monitor.span("train_step"):
                pass
        t1 = time.perf_counter()
        for i in range(n):
            monitor.event("pack_producer_done", batches=i)
        return (t1 - t0) / n, (time.perf_counter() - t1) / n

    h.begin_pass(0, owner="probe")
    try:
        off = per_call()
        sink = monitor.JsonlSink(os.path.join(d, "cost.jsonl"),
                                 queue_size=4 * n)
        h.enable(sink)
        on = per_call()
    finally:
        h.disable()
        h.abort_pass("probe")
    check(sink.dropped == 0 and sink.error is None and sink.written == 2 * n,
          f"hub cost probe: {sink.written} written, {sink.dropped} dropped")
    print(f"  hub cost ({card}): disabled span {off[0] * 1e6:.3f} us, event "
          f"{off[1] * 1e6:.3f} us | JsonlSink span {on[0] * 1e6:.3f} us, "
          f"event {on[1] * 1e6:.3f} us | a step's 6 records "
          f"{6 * on[0] * 1e3:.4f} ms on, {6 * off[0] * 1e3:.4f} ms "
          f"disabled")


def monitor_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 13. Returns the launches of every kernel over the phase's
    training passes."""
    print(f"== the monitor's write side and mid-pass snapshots ({card}): "
          f"DeepFM, {B} x {S} slots")
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        hub_cost(card, d)
    for lay in (ONEHOT, MULTI):
        hub_modes(torch, kernels, card, lay, total)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        midpass_snapshots(torch, kernels, card, total, d)
        t2 = time.perf_counter()
        device_trace(torch, kernels, card, total, d)
    print(f"launches in phase 13: {total} | seconds: hub modes "
          f"{t1 - t0:.1f}, mid-pass {t2 - t1:.1f}, device trace "
          f"{time.perf_counter() - t2:.1f}")
    return total

# ---------------------------------------------------------------------------
# phase 14: the step's dispatch modes and remote roots
# ---------------------------------------------------------------------------

SUPERSTEP_K = 4
HADOOP_CLI = """#!{python}
# A stand-in for the hadoop fs client: {scheme}:// paths map onto one local
# directory. It speaks the commands init_afs_api composes.
import os, shutil, sys
ROOT = {root!r}
args = [a for a in sys.argv[1:] if not a.startswith("-D")]
assert args[0] == "fs", args
op, rest = args[1], [a for a in args[2:] if a not in ("-f", "-p", "-r",
                                                      "-e")]
def local(p):
    return os.path.join(ROOT, p.split("://", 1)[1])
if op == "-cat":
    with open(local(rest[0]), "rb") as f:
        shutil.copyfileobj(f, sys.stdout.buffer)
elif op == "-ls":
    for n in sorted(os.listdir(local(rest[0]))):
        print(rest[0].rstrip("/") + "/" + n)
elif op == "-put":
    src, dst = rest[0], local(rest[1])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.isdir(src):
        shutil.copytree(src, dst)
    else:
        shutil.copyfile(src, dst)
elif op == "-get":
    src, dst = local(rest[0]), rest[1]
    if os.path.isdir(src):
        shutil.copytree(src, dst)
    else:
        shutil.copyfile(src, dst)
elif op == "-mkdir":
    os.makedirs(local(rest[0]), exist_ok=True)
elif op == "-test":
    sys.exit(0 if os.path.exists(local(rest[0])) else 1)
elif op == "-rm":
    p = local(rest[0])
    if os.path.isdir(p):
        shutil.rmtree(p)
    elif os.path.exists(p):
        os.remove(p)
else:
    sys.exit(2)
"""


def write_hadoop_cli(d: str, root: str, scheme: str = "afs") -> str:
    path = os.path.join(d, "hadoop")
    with open(path, "w") as f:
        f.write(HADOOP_CLI.format(python=sys.executable, root=root,
                                  scheme=scheme))
    os.chmod(path, 0o755)
    return path


def tree_bytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(p, f))
               for p, _, fs in os.walk(path) for f in fs)


def dispatch_job(torch, lay, overlap: str = "auto", k: int = 1):
    """monitor_job built under flags.push_overlap=``overlap`` (read when
    the Trainer is built) at steps_per_dispatch ``k``."""
    from paddlebox_tpu_torch.config import flags
    old = flags.push_overlap
    flags.push_overlap = overlap
    try:
        return monitor_job(torch, lay, steps_per_dispatch=k)
    finally:
        flags.push_overlap = old


def profiled_pass(torch, kernels, tr, box, ds, total: dict
                  ) -> tuple[float, dict]:
    """One counted pass under torch.profiler: the device kernels' busy
    ms a step (every CUDA kernel of the pass, the boundary's included;
    copies and memsets left out) and the pass's launches."""
    from torch.profiler import ProfilerActivity, profile
    box.set_date(20261017)
    box.begin_pass()
    reset_counts(kernels)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = tr.train_pass(ds, metrics=box.metrics)
        torch.cuda.synchronize()
    launches = launch_counts(kernels)
    box.end_pass()
    add_counts(total, launches)
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith(("Memcpy", "Memset")))
    return dev / 1e3 / out["steps"], launches


def mode_ab(torch, kernels, card, lay, total: dict, tag: str,
            modes: dict, applies: dict) -> None:
    """Two dispatch modes of one job (``modes``: label -> (push_overlap,
    steps_per_dispatch)), alternating after a warm-up pass each, 2 passes
    each: the layout's kernels 16 each a pass, ``applies[label]``
    deferred applies a pass, the two runs' losses and final rows within
    LOSS_TOL / TABLE_TOL (the kernels' f32 atomics reorder sums), then a
    profiled pass (device busy ms/step) and a sync-probed pass (host
    syncs a step) of each."""
    jobs = {m: dispatch_job(torch, lay, *modes[m]) for m in modes}
    for m, (overlap, k) in modes.items():
        tr = jobs[m][2]
        check(tr.push_overlap == (applies[m] > 0)
              and tr.cfg.steps_per_dispatch == k,
              f"{tag} {m}: push_overlap {tr.push_overlap}, "
              f"steps_per_dispatch {tr.cfg.steps_per_dispatch}")
    want = {k: 16 for k in lay.kernels}
    runs: dict = {m: [] for m in modes}
    losses: dict = {m: [] for m in modes}
    for i, m in enumerate(list(modes) * 3):
        _, _, tr, box, ds = jobs[m]
        a0 = tr.push_applies
        out, launches, _ = counted_pass(kernels, tr, ds, total, box=box)
        expect_launches(f"{tag} {lay.name} {m} pass", launches, want)
        check(out["steps"] == 16 and tr.push_applies - a0 == applies[m],
              f"{tag} {m}: steps {out['steps']}, push applies "
              f"{tr.push_applies - a0}")
        losses[m].append(out["loss_mean"])
        if i >= len(modes):
            runs[m].append(16 * B / out["step_seconds"])
    a, b = list(modes)
    np.testing.assert_allclose(losses[a], losses[b], **LOSS_TOL)
    keys = np.sort(jobs[a][4].unique_keys())
    rows = {m: jobs[m][0].get_rows(keys) for m in modes}
    np.testing.assert_allclose(rows[b], rows[a], **TABLE_TOL)
    err = float(np.abs(rows[b] - rows[a]).max())
    for m in modes:
        _, _, tr, box, ds = jobs[m]
        busy, launches = profiled_pass(torch, kernels, tr, box, ds, total)
        expect_launches(f"{tag} {m} profiled pass", launches, want)
        reset_counts(kernels)
        syncs = pass_loop_syncs(torch, tr, box, ds)
        add_counts(total, launch_counts(kernels))
        check(syncs == 0, f"{tag} {lay.name} {m}: {syncs} host syncs a "
              f"step")
        eps = runs[m]
        loop_ms = 16 * B / float(np.median(eps)) / 16 * 1e3
        print(f"  {tag} {lay.name}, {m} ({card}): step-loop ex/s "
              f"{', '.join(f'{x:.1f}' for x in eps)} (spread "
              f"{min(eps):.1f}-{max(eps):.1f}) | device busy {busy:.3f} "
              f"ms/step (kernels, profiled pass) against "
              f"{loop_ms:.3f} ms/step of loop: idle share "
              f"{max(0.0, 1 - busy / loop_ms):.3f} | push_applies "
              f"{applies[m]} a pass | launches {want} a pass | host syncs "
              f"a step {syncs:g} | loss means "
              f"{', '.join(f'{x:.6f}' for x in losses[m])}")
    print(f"  {tag} {lay.name}: {a} and {b} agree, loss within LOSS_TOL, "
          f"rows within TABLE_TOL (max abs diff {err:.3g}) ok")
    del jobs
    torch.cuda.empty_cache()


def superstep_midpass(torch, kernels, card, total: dict, d: str) -> None:
    """(b) mid-pass snapshots every MIDPASS_EVERY steps of a k=4
    superstep job: an uninterrupted pass, then a process killed after
    the step-8 snapshot and resumed in another at the dispatch
    boundary."""
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    lay = ONEHOT
    env = {"CHIP_SMOKE_STEPS_PER_DISPATCH": str(SUPERSTEP_K)}
    store, _, tr, box, ds = monitor_job(torch, lay, seed=SEED + 7,
                                        steps_per_dispatch=SUPERSTEP_K)
    ckpt = PassCheckpointer(os.path.join(d, "ss-uninterrupted"),
                            base_every=2)
    tr.enable_midpass_snapshots(ckpt, MIDPASS_EVERY, box,
                                metrics=box.metrics)
    box.set_date(20261017)
    box.begin_pass()
    reset_counts(kernels)
    out_u = tr.train_pass(ds, metrics=box.metrics)
    launches = launch_counts(kernels)
    box.end_pass()
    add_counts(total, launches)
    expect_launches("(b) superstep mid-pass pass", launches,
                    {k: 16 for k in lay.kernels})
    check([s["mid_steps"] for s in tr.midpass_saves] == [4, 8, 12, 16],
          f"(b) superstep mid-pass saves at "
          f"{[s['mid_steps'] for s in tr.midpass_saves]}")
    keys = np.sort(ds.unique_keys())
    final_u = store.get_rows(keys)
    del store, tr, box
    torch.cuda.empty_cache()
    root_k = os.path.join(d, "ss-killed")
    r = run_worker(["kill", root_k], {
        **env, "PBTPU_FAULTPOINT": "trainer.midpass.post_save",
        "PBTPU_FAULTPOINT_AFTER": str(MIDPASS_KILL_STEP // MIDPASS_EVERY
                                      - 1)})
    check(r.returncode == 137 and "FAULTPOINT KILL trainer.midpass.post_save"
          in r.stderr, f"(b) superstep kill worker exited {r.returncode}: "
          f"{r.stdout[-1500:]}{r.stderr[-3000:]}")
    live, _ = load_state(root_k + ".live")
    check(live["step"] == MIDPASS_KILL_STEP, "(b) the killed superstep "
          f"run's live state is from step {live['step']}")
    hold_resumed(d, root_k, live, MIDPASS_KILL_STEP,
                 f"k={SUPERSTEP_K} killed at step 8",
                 (keys, final_u, out_u), total, card, env_extra=env)


def remote_worker(argv: list[str]) -> int:
    """``chip_smoke.py --remote-worker CLI OUT``: register the stand-in
    CLI for afs:// through init_afs_api, resume afs://smoke/ckpt into a
    fresh one-hot job from an empty staging dir, and write the restored
    state, the resume's and the download's seconds and bytes to OUT."""
    import torch
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.utils import fs as fs_lib
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    cli, out_path = argv
    fs_lib.init_afs_api("afs://smoke", hadoop_bin=cli, schemes=("afs",))
    store, _, tr = make_trainer(torch, ONEHOT, B, None, seed=SEED + 21)
    box = BoxPS(store)
    box.init_metric("auc")
    with tempfile.TemporaryDirectory() as stage:
        ckpt = PassCheckpointer("afs://smoke/ckpt", base_every=2,
                                staging_dir=stage)
        cursor = tr.resume(ckpt, box=box)
    keys = store.keys()
    res = ckpt.last_resume
    save_state(out_path, dict(keys=keys, rows=store.get_rows(keys),
                              dense=flat_dense(tr),
                              metrics=metric_state(box),
                              step=tr.global_step), {
        "cursor": {k: cursor[k] for k in ("pass_id", "mid_steps",
                                          "global_step")},
        "resume_s": res["seconds"], "resume_bytes": res["bytes"],
        "download": res["remote_download"],
        "on_card": next(tr.model.parameters()).device.type == "cuda"})
    return 0


def remote_roots(torch, kernels, card, total: dict) -> None:
    """(c) every remote root through a stand-in hadoop CLI registered with
    init_afs_api."""
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS, FleetUtil
    from paddlebox_tpu_torch.serving import ServingPublisher, ServingServer
    from paddlebox_tpu_torch.utils import fs as fs_lib
    from paddlebox_tpu_torch.utils.pass_ckpt import PassCheckpointer
    lay = ONEHOT
    with tempfile.TemporaryDirectory() as d:
        remote = os.path.join(d, "remote")
        cli = write_hadoop_cli(d, remote)
        fs = fs_lib.init_afs_api("afs://smoke", hadoop_bin=cli,
                                 schemes=("afs",))
        # 1. phase 5's one-hot records from a remote filelist
        keys, rng = draw_keys(lay.n_keys)
        schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                    batch_size=B, max_len=lay.max_len)
        records = make_records(schema, lay.steps * B, keys, rng,
                               lay.max_len)
        local_dir = os.path.join(d, "local")
        os.makedirs(local_dir)
        plain, files, _, _ = write_ingest_files(local_dir, records)
        t0 = time.perf_counter()
        fs.makedirs("afs://smoke/data")
        for f in sorted(set(plain) | set(files)):
            fs.put(f, "afs://smoke/data/" + os.path.basename(f))
        up_s = time.perf_counter() - t0
        up_b = tree_bytes(os.path.join(remote, "smoke", "data"))

        def load(paths, pipe=None):
            ds = SlotDataset(schema)
            ds.with_ins_id = True
            ds.set_filelist(paths)
            ds.set_pipe_command(pipe)
            t0 = time.perf_counter()
            ds.load_into_memory(global_shuffle=False)
            return ds, time.perf_counter() - t0

        remote_of = ["afs://smoke/data/" + os.path.basename(f)
                     for f in files]
        from paddlebox_tpu_torch.native import slot_parser
        # the native parser builds at first use: not a load's time
        check(slot_parser.available(), "(c) the native parser did not build")
        ds_local, t_local = load(files)
        ds_remote, t_remote = load(remote_of)
        ds_pipe, t_pipe = load(["afs://smoke/data/" + os.path.basename(f)
                                for f in plain], "cat")
        want = batch_bytes(ds_local, B)
        check(len(want) == lay.steps, f"(c) {len(want)} local batches")
        check(batch_bytes(ds_remote, B) == want,
              "(c) the remote filelist packs to other batches")
        check(batch_bytes(ds_pipe, B) == want,
              "(c) the remote filelist through pipe_command cat packs to "
              "other batches")
        print(f"  (c) remote filelist ({card}, host numbers): upload "
              f"{len(set(plain) | set(files))} files {up_b} bytes in "
              f"{up_s:.3f} s | load local {t_local:.3f} s, remote "
              f"{t_remote:.3f} s, remote through pipe_command cat "
              f"{t_pipe:.3f} s | {lay.steps} batches of {B} byte-identical "
              f"to the local load ok")

        # 2. three checkpointed passes to a remote PassCheckpointer root
        store, _, tr = make_trainer(torch, lay, B, None, seed=SEED + 20)
        box = BoxPS(store)
        box.init_metric("auc")
        ckpt = PassCheckpointer("afs://smoke/ckpt", base_every=2,
                                staging_dir=os.path.join(d, "stage"))
        want_l = {k: lay.steps for k in lay.kernels}
        for p in (1, 2, 3):
            out, launches, _ = counted_pass(
                kernels, tr, ds_remote, total, box=box,
                checkpointer=ckpt, dataset=ds_remote)
            expect_launches(f"(c) remote-root pass {p}", launches, want_l)
            sv = ckpt.last_save
            up = sv["remote_upload"]
            print(f"  (c) pass {p} to afs://smoke/ckpt ({card}): loss "
                  f"{out['loss_mean']:.6f} | local commit "
                  f"{sv['snapshot']} {sv['bytes']} bytes in "
                  f"{sv['seconds']:.3f} s | upload {up['bytes']} bytes in "
                  f"{up['seconds']:.3f} s ({'base' if sv['rotated'] else 'delta'}"
                  f" chain member)")
            if p == 2:
                # 3. resume pass 2 in a fresh process, empty staging dir
                k2 = store.keys()
                live2 = dict(keys=k2, rows=store.get_rows(k2),
                             dense=flat_dense(tr), metrics=metric_state(box),
                             step=tr.global_step)
                out_path = os.path.join(d, "remote-resumed")
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--remote-worker", cli, out_path],
                    capture_output=True, text=True, timeout=600)
                wall = time.perf_counter() - t0
                check(r.returncode == 0, f"(c) remote resume worker failed "
                      f"({r.returncode}): {r.stdout[-1500:]}"
                      f"{r.stderr[-3000:]}")
                restored, meta = load_state(out_path)
                check(meta["cursor"]["pass_id"] == 2 and meta["on_card"]
                      and meta["cursor"]["global_step"] == 2 * lay.steps,
                      f"(c) remote resume cursor {meta['cursor']}")
                check(same_state(restored, live2), "(c) the remote resume "
                      "differs from the writer's live state after pass 2")
                dl = meta["download"]
                print(f"  (c) resume of pass 2 in a fresh process from an "
                      f"empty staging dir ({card}): {wall:.1f} s wall | "
                      f"download {dl['bytes']} bytes of "
                      f"{len(dl['snapshots'])} snapshots in "
                      f"{dl['seconds']:.3f} s | resume {meta['resume_bytes']}"
                      f" bytes in {meta['resume_s']:.3f} s | keys, rows, "
                      f"dense params, adam state, metric state and cursor "
                      f"bit-equal to the live state ok")
        lines = fs.read_lines("afs://smoke/ckpt/snapshots.donefile")
        check([json.loads(x)["pass"] for x in lines] == [1, 2, 3],
              "(c) the remote donefile does not name passes 1-3")

        # 4. a remote FleetUtil day model
        fleet = FleetUtil("afs://smoke/models")
        t0 = time.perf_counter()
        fleet.save_model(store, tr.eval_params(), day=20261017)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_store, got_dense, day = FleetUtil(
            "afs://smoke/models").load_model(tr.eval_params())
        load_s = time.perf_counter() - t0
        ks = store.keys()
        check(day == 20261017 and np.array_equal(
            got_store.get_rows(ks), store.get_rows(ks)),
              "(c) the remote day model's rows differ")
        check(all(np.array_equal(a, b) for (_, a), (_, b) in zip(
            flat_tree(got_dense), flat_tree(tr.eval_params()))),
              "(c) the remote day model's dense params differ")
        print(f"  (c) FleetUtil day model at afs://smoke/models ({card}): "
              f"save {tree_bytes(os.path.join(remote, 'smoke', 'models'))} "
              f"bytes in "
              f"{save_s:.3f} s | load {load_s:.3f} s | rows and dense "
              f"params bit-equal ok")

        # 5. publish to a remote serving root; a staged server serves it
        pubs = {"remote": ServingPublisher(
                    "afs://smoke/serve", tr.model, schema, quant="int8",
                    staging_dir=os.path.join(d, "pub-stage")),
                "local": ServingPublisher(os.path.join(d, "serve"),
                                          tr.model, schema, quant="int8")}
        infos = {m: p.publish(store, tr.eval_params(), pass_id=3)
                 for m, p in pubs.items()}
        srvs = {"remote": ServingServer(
                    "afs://smoke/serve",
                    staging_dir=os.path.join(d, "srv-stage")),
                "local": ServingServer(os.path.join(d, "serve"))}
        polls = {}
        for m, srv in srvs.items():
            t0 = time.perf_counter()
            check(srv.poll_once() == 1, f"(c) {m} server applied nothing")
            polls[m] = time.perf_counter() - t0
        pb = next(ds_remote.batches(B))
        ids, mask, dense = request_arrays(tr, pb)
        got = srvs["remote"].predict(ids, mask, dense)
        ref = srvs["local"].predict(ids, mask, dense)
        check(srvs["remote"].active.predictor.device.type == "cuda",
              "(c) the remote root's server does not score on the card")
        check(np.array_equal(got, ref), "(c) the remote root's server "
              f"scores differ from the local root's (max abs "
              f"{np.abs(got - ref).max():.3g})")
        info = infos["remote"]
        print(f"  (c) publish v{info['version']} to afs://smoke/serve "
              f"({card}): {info['bytes']} bytes, {info['seconds']:.3f} s "
              f"(upload {info['upload_seconds']:.3f} s, verify download "
              f"{info['verify_seconds']:.3f} s) | staged poll "
              f"{polls['remote']:.3f} s against the local root's "
              f"{polls['local']:.3f} s | {B} scores equal to the local "
              f"root's ok")
        fs_lib._REGISTRY.pop("afs", None)
    del store, tr, box
    torch.cuda.empty_cache()


def flat_tree(tree):
    from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
    return [(p, np.asarray(x)) for p, x in flatten_tree(tree)]


def dispatch_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 14. Returns the launches of every kernel over the phase's
    training passes."""
    print(f"== the step's dispatch modes and remote roots ({card}): "
          f"DeepFM, {B} x {S} slots")
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    for lay in (ONEHOT, MULTI):
        mode_ab(torch, kernels, card, lay, total, "(a)",
                {"overlap off": ("off", 1), "overlap on": ("on", 1)},
                {"overlap off": 0, "overlap on": 16})
    t1 = time.perf_counter()
    for lay in (ONEHOT, MULTI):
        mode_ab(torch, kernels, card, lay, total, "(b)",
                {"k=1": ("auto", 1), f"k={SUPERSTEP_K}": ("auto",
                                                         SUPERSTEP_K)},
                {"k=1": 16, f"k={SUPERSTEP_K}": 0})
    with tempfile.TemporaryDirectory() as d:
        superstep_midpass(torch, kernels, card, total, d)
    t2 = time.perf_counter()
    remote_roots(torch, kernels, card, total)
    print(f"launches in phase 14: {total} | seconds: push overlap "
          f"{t1 - t0:.1f}, supersteps {t2 - t1:.1f}, remote roots "
          f"{time.perf_counter() - t2:.1f}")
    return total


# ---------------------------------------------------------------------------
# phase 15: the mesh
# ---------------------------------------------------------------------------

# (table layout, model layout) of the world-2 runs: the sharded exchange
# on both layouts, the token-level routed path on one-hot
MESH_RUNS = (("sharded", MULTI), ("sharded", ONEHOT), ("single", ONEHOT))
MESH_WORLD = 2
KSTEP_SYNC = 4


def mesh_trainer(torch, lay, mesh=None, device=None, **cfg_kw):
    """make_trainer's DeepFM on ``mesh`` (a Trainer(mesh=...)), or on
    ``device`` without one, under the TrainerConfig fields ``cfg_kw``;
    with phase 5's records. Returns (store, tr, ds)."""
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.models import DeepFMModel
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    cfg = EmbeddingConfig(dim=lay.dim, optimizer="adagrad",
                          learning_rate=0.05)
    store = HostEmbeddingStore(cfg)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=lay.max_len)
    tr = Trainer(DeepFMModel(S, lay.dim, DENSE, hidden=HIDDEN), store,
                 schema, TrainerConfig(global_batch_size=B,
                                       auc_buckets=1 << 16, **cfg_kw),
                 seed=SEED, device=device, mesh=mesh)
    keys, rng = draw_keys(lay.n_keys)
    ds = SlotDataset(schema)
    ds.records = make_records(schema, lay.steps * B, keys, rng, lay.max_len)
    return store, tr, ds


def dense_flat(tr) -> np.ndarray:
    return np.concatenate([p.detach().float().cpu().numpy().reshape(-1)
                           for p in tr.params])


def pass_rows(tr, store) -> tuple[np.ndarray, np.ndarray]:
    """The pass's keys this trainer's store holds, sorted, and their
    flushed rows."""
    tr.flush_sparse()
    keys = np.sort(store.keys())
    return keys, store.get_rows(keys)


def world1_nccl(torch, kernels, card, total: dict) -> None:
    """(a) Trainer(mesh=make_mesh(1)) over NCCL against the mesh-less
    trainer, then kstep and async passes on the mesh."""
    import torch.distributed as dist

    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.parallel import make_mesh
    mesh = make_mesh(1)
    check(mesh.backend == "nccl" and mesh.device.type == "cuda",
          f"make_mesh(1) formed {mesh}")
    for lay in (MULTI, ONEHOT):
        # one-hot narrow rows push through binned_merge_acc by default,
        # whose f32 atomics order sums differently from run to run (two
        # mesh-less runs differ too): the pair runs the deterministic
        # premerged engine there, which the sharded exchange applies with
        old = flags.push_engine
        if lay is ONEHOT:
            flags.push_engine = "scatter_accumulate"
        try:
            got = {}
            for label, m in (("mesh", mesh), ("mesh-less", None)):
                store, tr, ds = mesh_trainer(torch, lay, mesh=m)
                out, launches, _ = counted_pass(kernels, tr, ds, total)
                keys, rows = pass_rows(tr, store)
                got[label] = (out, launches, keys, rows, dense_flat(tr))
                del store, tr, ds
                torch.cuda.empty_cache()
        finally:
            flags.push_engine = old
        (om, lm, km, rm, dm), (op, lp, kp, rp, dp) = (got["mesh"],
                                                      got["mesh-less"])
        check(lm == lp, f"(a) {lay.name}: launches {lm} vs {lp}")
        for k in ("loss_first", "loss_last", "loss_mean", "auc", "steps"):
            check(om[k] == op[k], f"(a) {lay.name}: {k} {om[k]!r} on the "
                  f"mesh vs {op[k]!r} without")
        check(np.array_equal(km, kp) and np.array_equal(rm, rp)
              and np.array_equal(dm, dp),
              f"(a) {lay.name}: rows or dense params differ")
        print(f"  (a) {lay.name}, world 1 over nccl ({card}): bit-equal to "
              f"the mesh-less trainer (losses, {len(km)} rows, "
              f"{dm.size} dense params) | loss mean {om['loss_mean']:.6f} "
              f"| step {om['step_seconds'] / om['steps'] * 1e3:.3f} ms vs "
              f"{op['step_seconds'] / op['steps'] * 1e3:.3f} ms | "
              f"launches {lm}" + (" (push engine forced to "
                                  "scatter_accumulate)" if lay is ONEHOT
                                  else ""))
        for mode, kw in (("kstep", dict(dense_sync_mode="kstep",
                                         param_sync_step=KSTEP_SYNC)),
                         ("async", dict(dense_sync_mode="async"))):
            store, tr, ds = mesh_trainer(torch, lay, mesh=mesh, **kw)
            out, launches, _ = counted_pass(kernels, tr, ds, total)
            expect_launches(f"(a) {lay.name} {mode}", launches,
                            {k: lay.steps for k in lay.kernels})
            check(np.isfinite(out["loss_mean"]), f"(a) {mode}: loss")
            extra = ""
            if mode == "async":
                check(tr.dense_table.grads_merged == lay.steps,
                      f"(a) async merged {tr.dense_table.grads_merged}")
                extra = (f" | table applies {tr.dense_table.steps_applied}"
                         f" for {tr.dense_table.grads_merged} grads")
                tr.dense_table.stop()
            print(f"  (a) {lay.name}, {mode} on the world-1 mesh ({card}): "
                  f"loss first {out['loss_first']:.6f} mean "
                  f"{out['loss_mean']:.6f} | "
                  f"{out['step_seconds'] / out['steps'] * 1e3:.3f} ms/step"
                  f"{extra} | launches {launches}")
            del store, tr, ds
            torch.cuda.empty_cache()
    dist.destroy_process_group()


def mesh_worker(argv: list[str]) -> int:
    """One rank of (b): joins the world over gloo on the current card,
    runs MESH_RUNS (a counted pass, the routed pull against lookup /
    fused_pull_pool on the gathered table, a profiled pass) and writes
    its numbers to <dir>/rank<r>.json and its rows to
    <dir>/rank<r>_<run>.npz."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.distributed import RoleMaker
    from paddlebox_tpu_torch.embedding import exchange, sharded
    from paddlebox_tpu_torch.ops import kernels
    from paddlebox_tpu_torch.parallel import make_mesh
    work = argv[0]
    rm = RoleMaker.from_env()
    rm.init_distributed(backend="gloo")
    mesh = make_mesh(backend="gloo")
    kernels.build_kernels()          # built by the parent: loads only
    info = {"rank": mesh.rank, "device": str(mesh.device),
            "jax_loaded": "jax" in sys.modules, "runs": {}}
    for layout, lay in MESH_RUNS:
        flags.table_layout = layout
        store, tr, ds = mesh_trainer(torch, lay, mesh=mesh)
        name = f"{layout}_{lay.name}"
        st0 = monitor.STATS.snapshot()
        a0, c0, s0 = mesh.a2a_bytes, mesh.a2a_calls, mesh.staged_seconds
        reset_counts(kernels)
        out = tr.train_pass(ds)
        launches = launch_counts(kernels)
        st1 = monitor.STATS.snapshot()
        steps = out["steps"]
        run = {"launches": launches, "steps": steps,
               "loss_first": out["loss_first"],
               "loss_mean": out["loss_mean"], "auc": out["auc"],
               "dropped": out["routed_dropped"],
               "step_ms": out["step_seconds"] / steps * 1e3,
               "a2a_bytes_step": (mesh.a2a_bytes - a0) / steps,
               "a2a_calls_step": (mesh.a2a_calls - c0) / steps,
               "gloo_ms_step": (mesh.staged_seconds - s0) / steps * 1e3,
               "table_layout": tr.table_layout,
               "push_engine": tr.resolved_push_engine(tr.last_ws),
               "pull_engine": tr.pull_engine,
               "wire": tr.exchange_wire}
        for k in ("pull_bytes", "push_bytes", "tokens", "unique_lanes"):
            run[f"exchange_{k}"] = (st1.get(f"exchange.{k}", 0)
                                    - st0.get(f"exchange.{k}", 0))
        keys, rows = pass_rows(tr, store)
        np.savez(os.path.join(work, f"rank{mesh.rank}_{name}.npz"),
                 keys=keys, rows=rows)
        # the routed pull of the pass's first batch against the gathered
        # table, bit for bit (the checking launches count nowhere)
        ws = tr.last_ws
        pb = tr._local_batch(next(iter(ds.batches(B, drop_last=True))))
        idx_np = ws.translate(pb.ids, pb.mask)
        idx = torch.from_numpy(idx_np).to(mesh.device)
        full = mesh.all_gather(ws.table.contiguous())
        plan = sharded.map_plan(tr.host_plan(ws, idx_np),
                                lambda a: torch.from_numpy(a).to(
                                    mesh.device))
        ecfg = store.cfg
        if tr.pull_engine == "fused_gather_pool":
            got = exchange.routed_pull_pooled(
                ws.table, idx, ecfg, mesh, mesh.axis_names, S,
                lay.max_len, tr.cfg.capacity_factor, plan=plan)
            want = sharded.fused_pull_pool(full, idx, ecfg, S, lay.max_len)
        elif layout == "sharded":
            got = exchange.routed_pull(ws.table, idx.reshape(-1), ecfg,
                                       mesh, mesh.axis_names,
                                       tr.cfg.capacity_factor, plan=plan)
            want = sharded.lookup(full, idx.reshape(-1), ecfg)
        else:
            got = sharded.routed_lookup(ws.table, idx.reshape(-1), ecfg,
                                        mesh, mesh.axis_names,
                                        tr.cfg.capacity_factor, dedup=True)
            want = sharded.lookup(full, idx.reshape(-1), ecfg)
        run["pull_bit_equal"] = bool(torch.equal(got, want))
        run["pull_checked"] = int(got.numel())
        del full
        # the routed step's share of the device's busy time
        reset_counts(kernels)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p_out = tr.train_pass(ds)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not e.key.startswith(("Memcpy", "Memset")))
        run["busy_ms_step"] = busy / 1e3 / p_out["steps"]
        run["profiled_step_ms"] = (p_out["step_seconds"] / p_out["steps"]
                                   * 1e3)
        info["runs"][name] = run
        del store, tr, ds, ws
        torch.cuda.empty_cache()
    flags.table_layout = "auto"
    with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()
    return 0


def world2_gloo(torch, kernels, card, total: dict) -> None:
    """(b) two ranks on this card over gloo (MESH_RUNS), each held to a
    one-rank run of the same global batches."""
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.distributed.launch import launch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        code = launch(MESH_WORLD, [sys.executable, os.path.abspath(__file__),
                                   "--mesh-worker", d],
                      store_dir=os.path.join(d, "store"),
                      base_env={"PBTPU_EXCHANGE_WIRE": "f32",
                                "GLOO_SOCKET_IFNAME": "lo"},
                      timeout_s=600, local_ranks=[0] * MESH_WORLD)
        check(code == 0, f"(b) a rank of the world of {MESH_WORLD} exited "
              f"{code}")
        t_world = time.perf_counter() - t0
        infos = []
        for r in range(MESH_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                infos.append(json.load(f))
        print(f"  (b) world {MESH_WORLD} on one card over gloo: "
              f"{t_world:.1f} s for the world (start, data, "
              f"{len(MESH_RUNS)} x 2 passes a rank)")
        for layout, lay in MESH_RUNS:
            name = f"{layout}_{lay.name}"
            runs = [i["runs"][name] for i in infos]
            want_k = ({"gather_pool": lay.steps,
                       "scatter_accumulate": lay.steps}
                      if layout == "sharded" and lay is MULTI else
                      {"scatter_accumulate": lay.steps}
                      if layout == "sharded" else
                      {"binned_merge_acc": lay.steps,
                       "merge_update": lay.steps})
            for r, run in enumerate(runs):
                add_counts(total, run["launches"])
                expect_launches(f"(b) {name} rank {r}", run["launches"],
                                want_k)
                check(run["dropped"] == 0 and run["steps"] == lay.steps,
                      f"(b) {name} rank {r}: dropped {run['dropped']}, "
                      f"steps {run['steps']}")
                check(run["pull_bit_equal"], f"(b) {name} rank {r}: the "
                      f"routed pull differs from the gathered table's")
                check(run["table_layout"] == layout, f"(b) {name}: layout "
                      f"{run['table_layout']}")
                check(not infos[r]["jax_loaded"], "(b) a rank loaded jax")
            check(runs[0]["loss_mean"] == runs[1]["loss_mean"],
                  f"(b) {name}: the ranks' world losses differ")
            # the one-rank run of the same global batches
            flags.table_layout = "auto"
            store, tr, ds = mesh_trainer(torch, lay)
            ref = tr.train_pass(ds)
            keys = np.concatenate([np.load(os.path.join(
                d, f"rank{r}_{name}.npz"))["keys"]
                for r in range(MESH_WORLD)])
            rows = np.concatenate([np.load(os.path.join(
                d, f"rank{r}_{name}.npz"))["rows"]
                for r in range(MESH_WORLD)])
            check(len(np.unique(keys)) == len(keys) == len(store),
                  f"(b) {name}: the shards hold {len(keys)} keys, the "
                  f"one-rank store {len(store)}")
            np.testing.assert_allclose(
                [runs[0]["loss_first"], runs[0]["loss_mean"]],
                [ref["loss_first"], ref["loss_mean"]], **LOSS_TOL)
            want_rows = store.get_rows(keys)
            np.testing.assert_allclose(rows, want_rows, **TABLE_TOL)
            err = float(np.abs(rows - want_rows).max())
            del store, tr, ds
            torch.cuda.empty_cache()
            for r, run in enumerate(runs):
                ex = ("" if layout != "sharded" else
                      f" (exchange counters: pull "
                      f"{run['exchange_pull_bytes'] / run['steps']:.0f} + "
                      f"push {run['exchange_push_bytes'] / run['steps']:.0f}"
                      f" B/step, {run['exchange_unique_lanes']} unique "
                      f"lanes of {run['exchange_tokens']} tokens)")
                share = run["busy_ms_step"] / run["profiled_step_ms"]
                print(f"  (b) {name}, rank {r} of {MESH_WORLD} ({card}): "
                      f"step {run['step_ms']:.3f} ms | launches "
                      f"{run['launches']} | dropped {run['dropped']} | "
                      f"all-to-all {run['a2a_bytes_step']:.0f} B/step in "
                      f"{run['a2a_calls_step']:g} calls{ex} | gloo "
                      f"exchange {run['gloo_ms_step']:.3f} ms/step "
                      f"(host-staged through pinned memory: no NCCL "
                      f"number) | device busy {run['busy_ms_step']:.3f} "
                      f"of {run['profiled_step_ms']:.3f} ms/step "
                      f"(profiled pass): routed step's share {share:.3f} "
                      f"| pull {run['pull_engine']}, push "
                      f"{run['push_engine']}, wire {run['wire']}")
            print(f"  (b) {name}: routed pull bit-equal to the gathered "
                  f"table's ({runs[0]['pull_checked']} values a rank) | "
                  f"0 dropped | world loss mean {runs[0]['loss_mean']:.6f} "
                  f"vs one rank {ref['loss_mean']:.6f} within LOSS_TOL | "
                  f"{len(keys)} rows within TABLE_TOL of one rank's (max "
                  f"abs diff {err:.3g}) ok")


def mesh_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 15. Returns the launches of every kernel over the phase's
    training passes (world 2: both ranks')."""
    print(f"== the mesh ({card}): DeepFM, {B} x {S} slots, world 1 over "
          f"nccl, world {MESH_WORLD} over gloo on one card")
    total: dict[str, int] = {}
    t0 = time.perf_counter()
    world1_nccl(torch, kernels, card, total)
    t1 = time.perf_counter()
    world2_gloo(torch, kernels, card, total)
    print(f"launches in phase 15: {total} | seconds: world 1 "
          f"{t1 - t0:.1f}, world {MESH_WORLD} {time.perf_counter() - t1:.1f}")
    return total

# ---------------------------------------------------------------------------
# phase 16: the resilient world
# ---------------------------------------------------------------------------

RES_STEPS = 8              # (b): steps a pass a rank
ELASTIC_STEPS = 16         # (c): steps a rank a pass at world 2
ELASTIC_LOST_S = 3.0       # (c): the watchdog's lost_after after pass 1
ELASTIC_SLEEP_S = 0.4      # (c): the generation-0 step pause that lands
                           # the survivor's detection inside its pass 2
PS_MULTI_STEPS = 4         # (d): the multi-hot pass's steps


def res_spec(lay, **kw) -> dict:
    """A torch_resilience_worker spec at bench.py's full width on the
    card."""
    spec = {"device": "cuda", "slots": S, "dense": DENSE,
            "hidden": list(HIDDEN), "dim": lay.dim, "batch": B,
            "max_len": lay.max_len, "n_keys": lay.n_keys}
    spec.update(kw)
    return spec


def res_worker():
    """tests/torch_resilience_worker.py, this checkout's rank program of
    the resilient world (no JAX); its ranks start as this script with
    --resilience-worker. It lives beside the tests on purpose: like the
    JAX package's tests/elastic_worker.py it is the elastic recovery loop
    a job writes around the package's steps, and the CPU tests and this
    phase drive that one loop."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_resilience_worker as w
    w.RANK_CMD = [sys.executable, os.path.abspath(__file__),
                  "--resilience-worker"]
    return w


def res_shuffle(torch, kernels, card, total: dict) -> None:
    """(a) two ranks load halves of phase 5's one-hot records over
    TcpShuffleService, ins_id-routed then random, and train a pass on
    each arrival."""
    from paddlebox_tpu_torch.data import DataFeedSchema
    w = res_worker()
    keys, rng = draw_keys(ONEHOT.n_keys)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=1)
    records = make_records(schema, ONEHOT.steps * B, keys, rng, 1)
    records.ins_id = np.arange(1, records.num + 1, dtype=np.uint64)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        infos = w.shuffle_drill(d, res_spec(ONEHOT, shuffle_seed=11),
                                records, device_ranks=[0, 0])
        t_world = time.perf_counter() - t0
    for r, info in enumerate(infos):
        check(not info["jax_loaded"], f"(a) rank {r} loaded jax")
        steps = sum(x["steps"] for x in info["rounds"].values())
        expect_launches(f"(a) rank {r}", info["launches"],
                        {"binned_merge_acc": steps, "merge_update": steps})
        add_counts(total, info["launches"])
        for routing, x in info["rounds"].items():
            print(f"  (a) rank {r}, {routing} routing ({card}): received "
                  f"{len(x['ins_id'])} records | exchange sent "
                  f"{x['sent_bytes']} B, received {x['received_bytes']} B "
                  f"in {x['seconds']:.3f} s (load {x['load_seconds']:.3f} "
                  f"s) | pass: {x['steps']} steps, loss mean "
                  f"{x['loss_mean']:.6f}")
    print(f"  (a) {records.num} records: each round's union is the loaded "
          f"multiset and every record sits on its route's rank ok | "
          f"world {t_world:.1f} s")


def res_resume(torch, kernels, card, total: dict) -> None:
    """(b) two ranks write three checkpointed passes; rank 1's newest
    dense.npz is truncated; fresh processes elect pass 2 through
    Trainer.resume(collectives=) and restore it bit for bit."""
    w = res_worker()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        writers, restorers = w.resume_drill(
            d, res_spec(ONEHOT, steps=RES_STEPS), device_ranks=[0, 0])
        t_world = time.perf_counter() - t0
    for r in range(2):
        expect_launches(f"(b) rank {r}", writers[r]["launches"],
                        {"binned_merge_acc": 3 * RES_STEPS,
                         "merge_update": 3 * RES_STEPS})
        add_counts(total, writers[r]["launches"])
        sv = [writers[r][f"save_{p}"] for p in (1, 2, 3)]
        saves = " ".join(f"pass {p}: {x.get('seconds', 0):.3f} s "
                         f"{x.get('bytes', 0)} B"
                         for p, x in zip((1, 2, 3), sv))
        print(f"  (b) rank {r} ({card}): saves {saves} | resume(collectives=) "
              f"elected {restorers[r]['elected']} (intact "
              f"{restorers[r]['intact']}) in "
              f"{restorers[r]['resume_seconds']:.3f} s | restored state "
              f"bit-equal to the live pass-2 state ok")
    print(f"  (b) both worlds {t_world:.1f} s")


def res_elastic(torch, kernels, card, total: dict) -> None:
    """(c) two ranks train member shards of one dataset; rank 1 dies at
    trainer.step.pre in pass 2; rank 0 names it, drain-snapshots,
    re-forms generation 1 at world 1, resumes, re-routes rank 1's tail
    and finishes; its planes against the simulated shrink, bit for bit
    (push engine forced to the deterministic scatter_accumulate)."""
    w = res_worker()
    spec = res_spec(ONEHOT, kind="elastic", n=2 * ELASTIC_STEPS * B,
                    passes=3, midpass=4, lost_s=ELASTIC_LOST_S,
                    step_sleep=ELASTIC_SLEEP_S, hb_interval=0.2,
                    reform_timeout=10.0, push_engine="scatter_accumulate")
    with tempfile.TemporaryDirectory() as d:
        live, sim = os.path.join(d, "live"), os.path.join(d, "sim")
        t0 = time.perf_counter()
        codes, errs = w.run_world(live, spec, 2, {
            "PBTPU_FAULTPOINT": "trainer.step.pre",
            "PBTPU_FAULTPOINT_AFTER": str(ELASTIC_STEPS + 1),
            "PBTPU_FAULTPOINT_ONLY_RANK": "1"}, timeout_s=600,
            device_ranks=[0, 0])
        t_live = time.perf_counter() - t0
        check(codes == [0, 137], f"(c) ranks exited {codes}: {errs}")
        info = w.read_info(live, 0)
        err = info["peer_error"] or {}
        check(err.get("type") == "PeerLostError" and err.get("ranks") == [1]
              and err.get("pass") == 2,
              f"(c) rank 0's failure {err}, expected PeerLostError [1] in "
              f"pass 2")
        drain = info["drain_snapshot"]
        check(drain is not None and 0 < drain["mid_steps"] < ELASTIC_STEPS,
              f"(c) no mid-pass drain snapshot: {drain}")
        m = drain["mid_steps"]
        check((info["gen"], info["members"]) == (1, [0]),
              f"(c) formed gen {info['gen']} members {info['members']}")
        check(info["elected"] == [1, m], f"(c) elected {info['elected']}")
        resize = info["world_resize"]
        check(len(resize) == 1 and resize[0]["departed"] == [1]
              and resize[0]["to_world"] == 1, f"(c) world_resize {resize}")
        check(not info["jax_loaded"], "(c) rank 0 loaded jax")
        t1 = time.perf_counter()
        codes, errs = w.run_world(sim, dict(spec, sim={
            "orig_members": [0, 1], "dead": [1], "elected": [1, m]}), 1,
            timeout_s=600, device_ranks=[0])
        t_sim = time.perf_counter() - t1
        check(codes == [0], f"(c) the simulated shrink exited {codes}: "
              f"{errs}")
        sinfo = w.read_info(sim, 0)
        with np.load(os.path.join(live, "out_0.npz")) as a, \
                np.load(os.path.join(sim, "out_0.npz")) as b:
            check(sorted(a.files) == sorted(b.files), "(c) planes differ")
            for k in b.files:
                check(np.array_equal(a[k], b[k]), f"(c) plane {k} of the "
                      f"recovered run differs from the simulated shrink's")
            n_rows = len(b["keys"])
    for label, launches in (("live", info["launches"]),
                            ("simulated", sinfo["launches"])):
        check(launches["scatter_accumulate"] > 0
              and launches["binned_merge_acc"] == 0,
              f"(c) {label} launches {launches}")
        add_counts(total, launches)
    j0, j1 = info["jitter"], info.get("jitter_final", {})
    print(f"  (c) elastic shrink ({card}): rank 1 killed at step 2 of pass 2 "
          f"(exit 137) | rank 0: {err['type']} naming {err['ranks']} after "
          f"{err['steps']} steps of pass 2 | drain snapshot at step {m} | "
          f"recover_world {info['recover_seconds']:.3f} s (drain, reform, "
          f"election, restore), of which the re-formation "
          f"{resize[0]['seconds']:.3f} s (world_resize, 2 -> 1, gen 1) | "
          f"elected "
          f"{info['elected']} | rank 1's tail re-routed, 3 passes finished "
          f"| {n_rows} rows, dense, metric, step and pass planes bit-equal "
          f"to the simulated shrink ok")
    print(f"  (c) heartbeat jitter ({card}): generation 0, interval "
          f"{j0.get('interval_s')} s, {j0.get('beats')} beats, gap mean "
          f"{j0.get('mean_gap_s', float('nan')):.4f} p99 "
          f"{j0.get('p99_gap_s', float('nan')):.4f} max "
          f"{j0.get('max_gap_s', float('nan')):.4f} s | generation 1: "
          f"{j1.get('beats')} beats, max gap "
          f"{j1.get('max_gap_s', float('nan')):.4f} s | launches live "
          f"{info['launches']}, simulated {sinfo['launches']} | live world "
          f"{t_live:.1f} s, simulated {t_sim:.1f} s")


def ps_pass_io(before: dict, after: dict) -> dict:
    out = {}
    for cmd in ("pull_rows", "write_rows"):
        a, b = before.get(cmd, {}), after.get(cmd, {})
        out[cmd] = {k: b.get(k, 0) - a.get(k, 0)
                    for k in ("calls", "sent_bytes", "recv_bytes",
                              "seconds")}
    return out


def res_ps(torch, kernels, card, total: dict) -> None:
    """(d) two PSServer processes hold the table: three one-hot passes
    and a multi-hot one through RemoteEmbeddingStore and BoxPS on the
    card, against the same passes on a HostEmbeddingStore; then save ->
    shrink -> load."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.distributed.ps import (PSClient,
                                                    RemoteEmbeddingStore)
    from paddlebox_tpu_torch.fleet import BoxPS
    procs, client = [], None
    try:
        for _ in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "paddlebox_tpu_torch.distributed.ps",
                 "--port", "0"], stdout=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        eps = []
        for p in procs:
            line = p.stdout.readline()
            check(line.startswith("ps server listening on "),
                  f"(d) a server printed {line!r}")
            host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
            eps.append((host, int(port)))
        client = PSClient(eps, timeout_s=300)
        for lay, passes, steps in ((ONEHOT, 3, ONEHOT.steps),
                                   (MULTI, 1, PS_MULTI_STEPS)):
            keys, _ = draw_keys(lay.n_keys)
            runs = {}
            for kind in ("remote", "host"):
                fn = ((lambda cfg, lay=lay: RemoteEmbeddingStore(
                    client, lay.name, cfg)) if kind == "remote" else None)
                store, schema, tr = make_trainer(torch, lay, B, None,
                                                 store_fn=fn)
                box = BoxPS(store)
                box.init_metric("auc")
                outs = []
                for p in range(passes):
                    ds = SlotDataset(schema)
                    ds.records = make_records(
                        schema, steps * B, keys,
                        np.random.default_rng(SEED + 40 + p), lay.max_len)
                    io0 = client.io_snapshot()
                    out, launches, _ = counted_pass(kernels, tr, ds, total,
                                                    box=box)
                    expect_launches(f"(d) {kind} {lay.name} pass {p + 1}",
                                    launches, {k: steps for k in
                                               lay.kernels})
                    io = ps_pass_io(io0, client.io_snapshot())
                    outs.append(out)
                    if kind == "remote":
                        pr, wr = io["pull_rows"], io["write_rows"]
                        print(f"  (d) {lay.name} pass {p + 1} on the PS "
                              f"({card}): loss mean {out['loss_mean']:.6f} "
                              f"| {out['steps']} steps, "
                              f"{out['step_seconds'] / out['steps'] * 1e3:.3f}"
                              f" ms/step | pull {pr['recv_bytes']} B in "
                              f"{pr['calls']} calls {pr['seconds']:.3f} s | "
                              f"push (row write-back) {wr['sent_bytes']} B "
                              f"in {wr['calls']} calls {wr['seconds']:.3f} s "
                              f"| boundary "
                              f"{tr.feed_mgr.last_boundary_seconds:.3f} s | "
                              f"launches {launches}")
                tr.flush_sparse()
                runs[kind] = (outs, store, tr)
            (ro, rstore, rtr), (ho, hstore, htr) = (runs["remote"],
                                                    runs["host"])
            for a, b in zip(ro, ho):
                np.testing.assert_allclose(
                    [a["loss_first"], a["loss_mean"]],
                    [b["loss_first"], b["loss_mean"]], **LOSS_TOL)
            all_keys = np.sort(hstore.keys())
            got = rstore.peek_rows(all_keys)
            want = hstore.get_rows(all_keys)
            np.testing.assert_allclose(got, want, **TABLE_TOL)
            check(len(rstore) == len(hstore),
                  f"(d) {lay.name}: the servers hold {len(rstore)} rows, "
                  f"the host store {len(hstore)}")
            print(f"  (d) {lay.name}: {passes} pass(es) on the PS agree with "
                  f"the HostEmbeddingStore's (LOSS_TOL; {len(all_keys)} rows "
                  f"within TABLE_TOL, max abs diff "
                  f"{float(np.abs(got - want).max()):.3g}) ok")
            if lay is ONEHOT:
                with tempfile.TemporaryDirectory() as d:
                    t0 = time.perf_counter()
                    files = rstore.save_base(os.path.join(d, "base"))
                    t_save = time.perf_counter() - t0
                    before = rstore.peek_rows(all_keys)
                    min_show = float(np.median(before[:, 0]))
                    t1 = time.perf_counter()
                    evicted = rstore.shrink(min_show)
                    t_shrink = time.perf_counter() - t1
                    left = len(rstore)
                    check(0 < evicted < len(all_keys)
                          and left == len(all_keys) - evicted,
                          f"(d) shrink evicted {evicted}, {left} left")
                    t2 = time.perf_counter()
                    rstore.load(os.path.join(d, "base"))
                    t_load = time.perf_counter() - t2
                    check(np.array_equal(rstore.peek_rows(all_keys), before)
                          and len(rstore) == len(all_keys),
                          "(d) load did not restore the saved rows")
                    nbytes = sum(os.path.getsize(os.path.join(r, f))
                                 for r, _, fs in os.walk(d) for f in fs)
                print(f"  (d) save -> shrink -> load ({card}): save_base "
                      f"{len(files)} shards {nbytes} B in {t_save:.3f} s | "
                      f"shrink(min_show {min_show:g}) evicted {evicted} in "
                      f"{t_shrink:.3f} s | load {t_load:.3f} s, rows "
                      f"bit-equal to the save ok")
            del runs, rstore, hstore, rtr, htr
            torch.cuda.empty_cache()
        check(client.stop_servers() == [], "(d) a server was gone")
        for p in procs:
            check(p.wait(timeout=60) == 0, f"(d) a server exited "
                  f"{p.returncode}")
    finally:
        if client is not None:
            client.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()


def resilience_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 16. Returns the launches of every kernel over the phase's
    training passes (every rank's)."""
    print(f"== the resilient world ({card}): DeepFM, {B} x {S} slots, "
          f"ranks on cuda:0 (torch_resilience_worker), the table on PS "
          f"processes")
    total: dict[str, int] = {}
    seconds = {}
    for name, fn in (("shuffle", res_shuffle), ("resume", res_resume),
                     ("elastic", res_elastic), ("ps", res_ps)):
        t0 = time.perf_counter()
        fn(torch, kernels, card, total)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    print(f"launches in phase 16: {total} | seconds: {seconds}")
    return total



# ---------------------------------------------------------------------------
# phase 17: the monitor's read side
# ---------------------------------------------------------------------------

PROBE_K = 1                # steps a timed window (CUDA's launch queue)
PROBE_WINDOWS = 6          # windows a stage, the fastest kept
FLOOR_TOL = 0.25           # push floor vs phase 4's bounds, relative
READ_STEPS = 8             # (b): steps a pass (the boundary-wall rule
                           # needs the boundary at 25% of the pass wall)
READ_PASSES = 4            # (b): passes with the read side on
TRACE_STEPS = 8            # (c): steps of the two-rank traced pass
SERVE_CLIENTS, SERVE_REQS = 4, 1024   # (d): requests a client
SERVE_INFLIGHT = 32        # (d): a client's requests in flight (batches
                           # of ~4 x 32: enough spans for a p99)


def probe_launches(lay, calls: dict) -> dict:
    """The launches attribute_step's calls make, from its call counts:
    the push kernels once a full step, a deferred apply and an isolated
    push; gather_pool (multi-hot) once a step that pulls — the full
    step, the push-ablated one, both deferred timings and the isolated
    lookup."""
    push = (calls["step"] + calls.get("overlap_applies", 0)
            + calls["isolated_push"])
    want = {k: 0 for k in SOURCES}
    if lay is MULTI:
        want["scatter_accumulate"] = push
        want["gather_pool"] = (calls["step"] + calls["ablate_push"]
                               + calls.get("overlap_pair", 0)
                               + calls.get("overlap_loss_path", 0)
                               + calls["isolated_lookup"])
    else:
        want["binned_merge_acc"] = want["merge_update"] = push
    return want


def step_attribution(torch, kernels, card, lay, bounds: dict,
                     total: dict) -> None:
    """(a) one layout: a 16-step pass for the step loop's wall, then
    step_probe.attribute_step on one staged batch of its working set and
    push_floor_analysis at the card's peaks, every kernel count reset
    just before the probe and read just after."""
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.monitor import doctor
    from paddlebox_tpu_torch.utils import step_probe
    keys, rng = draw_keys(lay.n_keys)
    store, schema, tr = make_trainer(torch, lay, B, None)
    ds = SlotDataset(schema)
    ds.records = make_records(schema, lay.steps * B, keys, rng, lay.max_len)
    out = tr.train_pass(ds)
    loop_s = out["step_seconds"] / out["steps"]
    ws = tr.last_ws
    pb = next(iter(ds.batches(B)))
    idx = ws.translate(pb.ids, pb.mask)
    labels, dense = tr.split_floats(pb.floats)
    staged = tr.stage(tr.pack_arrays(ws, idx, pb.mask, dense, labels))
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    att = step_probe.attribute_step(tr, ws, staged, loop_s, k=PROBE_K,
                                    windows=PROBE_WINDOWS)
    launches = launch_counts(kernels)
    wall = time.perf_counter() - t0
    add_counts(total, launches)
    want = probe_launches(lay, att["calls"])
    check(launches == want, f"(a) {lay.name}: the probe launched "
          f"{launches}, its calls {att['calls']} predict {want}")
    if lay is ONEHOT:
        check(launches["gather_pool"] == 0, "(a) one-hot launched "
              "gather_pool")
    st, iso = att["stages"], att["isolated"]
    single_ms = att["single_step_seconds"] * 1e3
    busy = PHASE5_BUSY_MS.get(lay.name)
    busy = None if busy is None else round(busy, 3)
    check(busy is None or 0.5 <= single_ms / busy <= 3.0,
          f"(a) {lay.name}: the probe's single step {single_ms:.3f} ms "
          f"against phase 5's profiled busy {busy} ms")
    check(att["coverage"] > 0.99, f"(a) {lay.name}: coverage "
          f"{att['coverage']}")

    def ms(x):
        return f"{x * 1e3:.4f}"
    print(f"  (a) {lay.name} step attribution ({card}): " + " | ".join(
        f"{k} {ms(v)} ms" for k, v in st.items())
        + f" | single step {single_ms:.4f} ms (phase 5's profiled busy "
        f"{busy} ms) | coverage {att['coverage']} | headline (step "
        f"loop wall) {att['headline_step_seconds'] * 1e3:.3f} ms, "
        f"unattributed (the host's share) "
        f"{att['unattributed_seconds'] * 1e3:.3f} ms")
    print(f"  (a) {lay.name} isolated: " + " | ".join(
        f"{k} {ms(v)} ms" for k, v in iso.items()))
    ab = att["overlap_ab"]
    if ab is not None:
        print(f"  (a) {lay.name} overlap_ab (push_overlap "
              f"{att['push_overlap']}): inline {ms(ab['inline_single_step'])}"
              f" ms | deferred apply+step "
              f"{ms(ab['deferred_step_plus_apply'])} ms | deferred loss "
              f"path {ms(ab['deferred_loss_path_step'])} ms")
    print(f"  (a) {lay.name} launches (k {PROBE_K}, {PROBE_WINDOWS} "
          f"windows a stage, calls {att['calls']}): {launches} = the "
          f"calls' prediction ok ({wall:.1f} s)")
    engine = tr.resolved_push_engine(ws)
    flat = idx.reshape(-1)
    # the rows the push touches (the premerged plan pads its unique
    # lanes to the token count; phase 4 counts the valid ones)
    lanes = int(np.unique(flat).size)
    fl = step_probe.push_floor_analysis(
        store.cfg, ws.padded_rows, int(flat.size),
        peaks=step_probe.device_peaks(),
        measured_push=st["sparse_push"], premerged=tr.push_premerged(),
        table_width=int(ws.table.shape[1]), unique_lanes=lanes)
    check(fl["engine"] == engine, f"(a) {lay.name}: the floor models "
          f"{fl['engine']}, the step ran {engine}")
    check(fl["floor_seconds"] is not None, f"(a) {lay.name}: no peaks "
          f"for {card}")
    mine = ("scatter_accumulate",) if lay is MULTI else (
        "binned_merge_acc", "merge_update")
    b4 = sum(bounds[k] for k in mine)
    floor_ms = fl["engines"][fl["engine"]]["floor_seconds"] * 1e3
    ratio = floor_ms / b4
    check(abs(ratio - 1.0) <= FLOOR_TOL, f"(a) {lay.name}: {engine} floor "
          f"{floor_ms:.4f} ms vs phase 4's bound {b4:.4f} ms")
    rep = doctor.diagnose(detail={"push_floor": fl, "push_engine": engine})
    status = {r["rule"]: r["status"] for r in rep["rules"]}["push-floor"]
    print(f"  (a) {lay.name} push floor ({card}): {engine} "
          f"{floor_ms:.4f} ms (" + ", ".join(
              f"{k} {v['bound_seconds'] * 1e3:.4f} ms"
              for k, v in fl["stages"].items()
              if v.get("bound_seconds") is not None) + f") vs phase 4's "
          f"bound {' + '.join(mine)} {b4:.4f} ms: ratio {ratio:.3f} "
          f"within {FLOOR_TOL:.0%} ok | {lanes} lanes of {flat.size} "
          f"tokens | every engine: " + ", ".join(
              f"{k} {v['floor_seconds'] * 1e3:.4f} ms"
              for k, v in fl["engines"].items())
          + f" | measured push {st['sparse_push'] * 1e3:.4f} ms, closed: "
          f"{fl['closed']} | best {fl.get('best_engine')} | doctor "
          f"push-floor: {status}")
    del store, tr, ds, ws, staged
    torch.cuda.empty_cache()


def key_windows(n: int, count: int) -> list:
    """``count`` disjoint key sets of ``n`` keys: passes over them reuse no
    resident row."""
    rng = np.random.default_rng(SEED + 17)
    keys = np.unique(rng.integers(1, 1 << 50, count * n + 8192,
                                  dtype=np.uint64))[:count * n]
    rng.shuffle(keys)
    return [keys[i * n:(i + 1) * n] for i in range(count)]


READ_FLAGS = ("trace", "trace_device", "trace_device_dir", "doctor_live",
              "self_healing", "self_healing_sustain", "incremental_feed",
              "serving_trace_sample", "table_layout")


def read_side_run(torch, kernels, card, total: dict, d: str) -> None:
    """(b) four 8-step one-hot passes through BoxPS.end_pass with the
    world trace, the per-pass device capture, the live doctor and the
    self-healing loop on, over disjoint key windows with
    flags.incremental_feed off (no resident row reused: the boundary-wall
    rule's reuse-off arm), then a fifth pass with the read side off. A
    boundary's doctor reads the passes committed before it, and the
    first pass's wall may hold the profiler's first start on this
    process, so the action lands at pass 3's boundary or pass 4's."""
    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags, set_flags
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.monitor import doctor
    from paddlebox_tpu_torch.monitor import trace as trace_lib
    store, schema, tr = make_trainer(torch, ONEHOT, B, None)
    box = BoxPS(store)
    box.init_metric("auc")
    windows = key_windows(ONEHOT.n_keys, READ_PASSES + 1)
    rng = np.random.default_rng(SEED + 18)
    datasets = []
    for w in windows:
        ds = SlotDataset(schema)
        ds.records = make_records(schema, READ_STEPS * B, w, rng, 1)
        datasets.append(ds)
    hub = monitor.hub()
    # the live doctor reads the hub's ring of flight records: this run's
    hub._flight_records.clear()
    errs0 = monitor.STATS.get("trace.device_capture_errors")
    set_flags(trace=True, trace_device=True,
              trace_device_dir=os.path.join(d, "device"), doctor_live=True,
              self_healing=True, self_healing_sustain=2,
              incremental_feed=False)
    ctl = tr.enable_self_healing()
    hub.enable(monitor.JsonlSink(os.path.join(d, "rank0", "events.jsonl")))
    rows = []
    try:
        for p in range(READ_PASSES + 1):
            if p == READ_PASSES:     # the read side off: the A/B pass
                set_flags(trace=False, trace_device=False,
                          doctor_live=False, self_healing=False)
            box.begin_pass()
            reset_counts(kernels)
            out = tr.train_pass(datasets[p], metrics=box.metrics)
            launches = launch_counts(kernels)
            add_counts(total, launches)
            expect_launches(f"(b) pass {p + 1}", launches,
                            {k: READ_STEPS for k in ONEHOT.kernels})
            t0 = time.perf_counter()
            end = box.end_pass(trainer=tr)
            end_s = time.perf_counter() - t0
            fr = end["flight_record"]
            row = {"pass": p + 1, "wall": fr["seconds"], "end_s": end_s,
                   "boundary": fr["extra"].get("boundary_seconds", 0.0),
                   "step_ms": out["step_seconds"] / out["steps"] * 1e3,
                   "findings": [f["rule"] for f in end.get("doctor", [])],
                   "remediation": end.get("remediation"),
                   "fr_remediation": fr["extra"].get("remediation")}
            if p < READ_PASSES:
                cap = trace_lib.last_device_trace
                check(cap is not None and os.path.dirname(cap).endswith(
                    f"pass-{box.pass_id:05d}"), f"(b) pass {p + 1}: no "
                    f"device capture ({cap})")
                with open(cap) as f:
                    names = [str(e.get("name", ""))
                             for e in json.load(f)["traceEvents"]]
                n_acc = sum("binned_merge_acc_kernel" in n for n in names)
                n_mu = sum("merge_update_kernel" in n for n in names)
                check(n_acc >= READ_STEPS and n_mu >= READ_STEPS,
                      f"(b) pass {p + 1}: the capture holds {n_acc} "
                      f"binned_merge_acc and {n_mu} merge_update launches")
                row.update(capture_bytes=os.path.getsize(cap),
                           capture_acc=n_acc, capture_mu=n_mu)
                t0 = time.perf_counter()
                doctor.diagnose_hub(hub)
                row["doctor_ms"] = (time.perf_counter() - t0) * 1e3
            rows.append(row)
    finally:
        hub.disable()
        for k in ("trace", "trace_device", "doctor_live", "self_healing"):
            flags.set(k, False)
        flags.set("incremental_feed", True)
        flags.set("trace_device_dir", "")
    errs = monitor.STATS.get("trace.device_capture_errors") - errs0
    check(errs == 0, f"(b) trace.device_capture_errors {errs}")
    for r in rows:
        share = r["boundary"] / r["wall"] if r["wall"] else 0.0
        print(f"  (b) pass {r['pass']} ({card}): wall {r['wall']:.3f} s, "
              f"boundary {r['boundary']:.3f} s (share {share:.3f}), step "
              f"loop {r['step_ms']:.3f} ms/step, end_pass "
              f"{r['end_s']:.3f} s | findings {r['findings']} | "
              f"remediation {r['remediation']}"
              + (f" | capture {r['capture_bytes']} bytes, "
                 f"{r['capture_acc']} binned_merge_acc_kernel and "
                 f"{r['capture_mu']} merge_update_kernel launches | doctor "
                 f"{r['doctor_ms']:.2f} ms" if "capture_bytes" in r
                 else " | read side off"))
    hist = [(r["findings"], r["remediation"]) for r in rows]
    i = next((i for i, r in enumerate(rows) if r["remediation"]), None)
    rem = rows[i]["remediation"] if i is not None else None
    check(i in (2, 3) and rem.get("status") == "applied"
          and rem.get("rule") == "boundary-wall"
          and rem.get("action") == "enable-incremental-feed",
          f"(b) no applied boundary-wall action at pass 3 or 4: {hist}")
    check(rows[i]["fr_remediation"] == rem, "(b) the flight record's "
          "extra['remediation'] is not the applied action")
    if i + 1 < READ_PASSES:
        after = rows[i + 1]["remediation"]
        check(after and after.get("after") is not None,
              f"(b) the settling pass carries no after-window: {after}")
    check(flags.incremental_feed and not ctl.quarantined,
          f"(b) the parity guard reverted: quarantined {ctl.quarantined}")
    on = rows[READ_PASSES - 1]
    off = rows[READ_PASSES]
    fired = [r["pass"] for r in rows if "boundary-wall" in r["findings"]]
    print(f"  (b) self-healing ({card}): boundary-wall in the live "
          f"doctor's findings after passes {fired}, "
          f"enable-incremental-feed applied at pass {i + 1}'s boundary "
          f"(sustain 2) with the parity guard holding (the dense params' "
          f"bytes equal across the apply), extra['remediation'] on pass "
          f"{i + 1}'s flight record: {rem} ok")
    print(f"  (b) read side cost per pass ({card}): end_pass {on['end_s']:.3f}"
          f" s on (live doctor {on['doctor_ms']:.2f} ms, device capture "
          f"stop + write {on['capture_bytes']} bytes) vs {off['end_s']:.3f} "
          f"s off | pass wall {on['wall']:.3f} s on vs {off['wall']:.3f} s "
          f"off | step loop {on['step_ms']:.3f} vs {off['step_ms']:.3f} "
          f"ms/step")


def trace_worker(argv: list[str]) -> int:
    """One rank of (c): joins the world over gloo on the current card and
    trains one traced one-hot pass of TRACE_STEPS steps on the sharded
    layout, its heartbeat publishing every 0.2 s (the clock probes) and
    its hub writing <dir>/rank<r>/events.jsonl; writes <dir>/rank<r>.json."""
    import torch

    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.distributed import RoleMaker
    from paddlebox_tpu_torch.distributed.resilience import HeartbeatMonitor
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.ops import kernels
    from paddlebox_tpu_torch.parallel import make_mesh
    work = argv[0]
    rm = RoleMaker.from_env()
    rm.init_distributed(backend="gloo")
    mesh = make_mesh(backend="gloo")
    kernels.build_kernels()          # built by the parent: loads only
    flags.table_layout = "sharded"
    flags.trace = True
    store, tr, _ = mesh_trainer(torch, ONEHOT, mesh=mesh)
    keys, rng = draw_keys(ONEHOT.n_keys)
    ds = SlotDataset(tr.schema)
    ds.records = make_records(tr.schema, TRACE_STEPS * B, keys, rng, 1)
    hb = HeartbeatMonitor(rm.base_store(), mesh.rank, mesh.world,
                          run_id="trace", interval_s=0.2)
    box = BoxPS(store)
    box.attach_collectives(rm.collectives(), heartbeat=hb)
    hub = monitor.hub()
    hub.enable(monitor.JsonlSink(os.path.join(work, f"rank{mesh.rank}",
                                              "events.jsonl")))
    try:
        box.begin_pass()
        reset_counts(kernels)
        out = tr.train_pass(ds)
        launches = launch_counts(kernels)
        box.end_pass(trainer=tr)
        time.sleep(1.0)              # a few more beats: the clock probes
    finally:
        hub.disable()
        hb.close()
    with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({"launches": launches, "steps": out["steps"],
                   "loss_mean": out["loss_mean"],
                   "table_layout": tr.table_layout,
                   "jax_loaded": "jax" in sys.modules}, f)
    torch.distributed.destroy_process_group()
    return 0


def two_rank_trace(torch, kernels, card, total: dict, d: str) -> None:
    """(c) two ranks on this card over gloo (trace_worker), their streams
    merged by the port's trace CLI and diagnosed by its doctor CLI."""
    from paddlebox_tpu_torch.distributed.launch import launch
    torch.cuda.empty_cache()
    work = os.path.join(d, "world")
    os.makedirs(work)
    t0 = time.perf_counter()
    code = launch(2, [sys.executable, os.path.abspath(__file__),
                      "--trace-worker", work],
                  store_dir=os.path.join(work, "store"),
                  base_env={"PBTPU_EXCHANGE_WIRE": "f32",
                            "GLOO_SOCKET_IFNAME": "lo"},
                  timeout_s=600, local_ranks=[0, 0])
    check(code == 0, f"(c) a rank exited {code}")
    t_world = time.perf_counter() - t0
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            info = json.load(f)
        add_counts(total, info["launches"])
        expect_launches(f"(c) rank {r}", info["launches"],
                        {"scatter_accumulate": TRACE_STEPS})
        check(info["steps"] == TRACE_STEPS and not info["jax_loaded"]
              and info["table_layout"] == "sharded", f"(c) rank {r}: {info}")
    roots = [os.path.join(work, f"rank{r}") for r in range(2)]
    out = os.path.join(work, "world_trace.json")
    proc = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu_torch.monitor.trace", *roots,
         "-o", out, "--json"], capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"(c) trace CLI: {proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    edges = [e for e in summary["flow_edges"] if e["kind"] == "exchange"]
    keys = sorted(e["key"] for e in edges)
    check(len(edges) == TRACE_STEPS and len(set(keys)) == TRACE_STEPS
          and all({e["src_rank"], e["dst_rank"]} == {0, 1} for e in edges),
          f"(c) {len(edges)} exchange arrows ({keys}) for {TRACE_STEPS} "
          f"steps")
    with open(out) as f:
        tr_json = json.load(f)
    s_ids = {e["id"] for e in tr_json["traceEvents"] if e.get("ph") == "s"}
    f_ids = {e["id"] for e in tr_json["traceEvents"] if e.get("ph") == "f"}
    check(s_ids == f_ids and len(s_ids) >= TRACE_STEPS,
          "(c) the Chrome flow events do not pair")
    lat = [e["latency_s"] * 1e3 for e in edges]
    probes = []
    for root in roots:
        with open(os.path.join(root, "events.jsonl")) as f:
            probes += [json.loads(line)["fields"] for line in f
                       if '"trace.clock_probe"' in line]
    rtt = [p["rtt_s"] * 1e3 for p in probes]
    print(f"  (c) two ranks over gloo on cuda:0 ({card}): {t_world:.1f} s "
          f"for the world | merged trace {os.path.getsize(out)} bytes, "
          f"{summary['spans']} spans, {len(edges)} exchange arrows (one a "
          f"step) ok | clock offsets {summary['clock_offsets_s']} s "
          f"(corrected ranks {summary['clock_corrected_ranks']}) from "
          f"{len(probes)} heartbeat probes, rtt ms median "
          f"{float(np.median(rtt)) if rtt else float('nan'):.3f} max "
          f"{max(rtt) if rtt else float('nan'):.3f} (one host: the true "
          f"offset is 0, the estimate's error is within rtt/2) | edge "
          f"latency ms min {min(lat):.3f} median {float(np.median(lat)):.3f}"
          f" max {max(lat):.3f}")
    proc = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu_torch.monitor.doctor", *roots],
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"(c) doctor CLI: {proc.stderr[-2000:]}")
    print("  (c) doctor CLI over both roots:")
    for line in proc.stdout.strip().splitlines():
        print(f"    {line[:300]}")


def span_stats(records: list, name: str) -> tuple[int, float, float]:
    ms = np.array([r["dur_s"] * 1e3 for r in records
                   if r.get("type") == "span" and r.get("name") == name])
    check(ms.size > 0, f"(d) no {name} span in the stream")
    return int(ms.size), float(np.percentile(ms, 50)), float(
        np.percentile(ms, 99))


def serving_spans(torch, kernels, card, total: dict, d: str) -> None:
    """(d) phase 11's frontend (max_batch 1024, max_wait_s 0.002) under
    flags.serving_trace_sample = 1, SERVE_CLIENTS clients of SERVE_REQS
    single-example requests, across pass 2's published delta and its
    swap: the serve/wait and serve/score spans' p50/p99, and the merged
    trace's publish arrow from the pass to the swap."""
    import threading

    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.monitor import trace as trace_lib
    from paddlebox_tpu_torch.serving import (BatchingFrontend,
                                             ServingPublisher,
                                             ServingServer)
    store, schema, tr, box, ds = monitor_job(torch, ONEHOT)
    root = os.path.join(d, "serve")
    pub = ServingPublisher(root, tr.model, schema, quant="int8",
                           publish_base_every=2, hot_top_k=1024)
    sdir = os.path.join(d, "serve_rank0")
    hub = monitor.hub()
    flags.trace = True
    flags.serving_trace_sample = 1
    hub.enable(monitor.JsonlSink(os.path.join(sdir, "events.jsonl")))
    try:
        box.begin_pass()
        reset_counts(kernels)
        tr.train_pass(ds, metrics=box.metrics)
        add_counts(total, launch_counts(kernels))
        box.end_pass(trainer=tr, publisher=pub)          # v1, a base
        srv = ServingServer(root)
        check(srv.poll_once() == 1, "(d) the first poll loaded nothing")
        box.begin_pass()
        reset_counts(kernels)
        tr.train_pass(ds, metrics=box.metrics)
        add_counts(total, launch_counts(kernels))
        it = ds.batches(B)
        reqs = [request_arrays(tr, next(it)) for _ in range(SERVE_CLIENTS)]
        fe = BatchingFrontend(srv, max_batch=1024, max_wait_s=0.002).start()
        sent = [0] * SERVE_CLIENTS
        errors = []

        def client(c):
            ids, mask, dense = reqs[c]
            try:
                futs = []
                for i in range(SERVE_REQS):
                    futs.append(fe.submit(ids[i], mask[i], dense[i]))
                    sent[c] += 1
                    if len(futs) >= SERVE_INFLIGHT:
                        check(np.isfinite(futs.pop(0).result(timeout=60)),
                              "(d) non-finite score")
                for f in futs:
                    check(np.isfinite(f.result(timeout=60)),
                          "(d) non-finite score")
            except Exception as e:   # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while sum(sent) < SERVE_CLIENTS * SERVE_REQS // 4 and any(
                t.is_alive() for t in threads):
            time.sleep(0.005)
        end = box.end_pass(trainer=tr, publisher=pub)    # v2, a delta
        info = end["publish"]
        check("error" not in info, f"(d) publish failed: {info}")
        check(srv.poll_once() == 1, "(d) the swap applied nothing")
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        fe.stop()
        st = fe.stats()
    finally:
        hub.disable()
        flags.trace = False
        flags.serving_trace_sample = 0
    check(not errors, f"(d) clients failed: {errors[:3]}")
    n = sum(sent)
    check(st["failures"] == 0 and n == SERVE_CLIENTS * SERVE_REQS,
          f"(d) frontend {st}, {n} sent")
    check(srv.active.version == info["version"], f"(d) serving "
          f"v{srv.active.version}, published v{info['version']}")
    with open(os.path.join(sdir, "events.jsonl")) as f:
        records = [json.loads(line) for line in f]
    n_w, w50, w99 = span_stats(records, "serve/wait")
    n_s, s50, s99 = span_stats(records, "serve/score")
    summary = trace_lib.summarize(trace_lib.merge_roots([sdir]))
    pub_edges = [e for e in summary["flow_edges"] if e["kind"] == "publish"
                 and e["key"] == f"v{info['version']}"]
    check(len(pub_edges) == 1, f"(d) publish edges "
          f"{[e for e in summary['flow_edges'] if e['kind'] == 'publish']}")
    e = pub_edges[0]
    print(f"  (d) serving spans ({card}): {n} requests from "
          f"{SERVE_CLIENTS} clients in {wall:.3f} s, frontend p50 "
          f"{st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms, "
          f"{st['batches']} batches (mean {st['mean_batch']}) | serve/wait "
          f"{n_w} spans p50 {w50:.3f} ms p99 {w99:.3f} ms | serve/score "
          f"{n_s} spans p50 {s50:.3f} ms p99 {s99:.3f} ms | publish "
          f"v{info['version']} ({info['kind']}) -> swap arrow, latency "
          f"{e['latency_s'] * 1e3:.3f} ms, parent span "
          f"{e['fields'].get('parent_span_id')} ok")


def read_side_phase(torch, kernels, card, bounds: dict) -> dict[str, int]:
    """Phase 17. Returns the launches of every kernel over the phase
    (the probe's calls, the training passes, both ranks of (c))."""
    print(f"== the monitor's read side ({card}): DeepFM, {B} x {S} slots")
    total: dict[str, int] = {}
    seconds = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for lay in (MULTI, ONEHOT):
            step_attribution(torch, kernels, card, lay, bounds, total)
        seconds["attribution"] = round(time.perf_counter() - t0, 1)
        for name, fn in (("read side", read_side_run),
                         ("two ranks", two_rank_trace),
                         ("serving", serving_spans)):
            t0 = time.perf_counter()
            fn(torch, kernels, card, total, os.path.join(d, name[:5]))
            seconds[name] = round(time.perf_counter() - t0, 1)
            torch.cuda.empty_cache()
    print(f"launches in phase 17: {total} | seconds: {seconds}")
    return total


# ---------------------------------------------------------------------------
# phase 18: the serving fleet and the exported program
# ---------------------------------------------------------------------------

FLEET_REQ = 128            # examples a request
FLEET_CLIENTS = 4          # client threads hammering the router
FLEET_HEDGE_REQS = 100     # requests a client in the hedged leg
FLEET_HEDGE_FACTOR = 1.5   # flags.serving_hedge_factor in that leg
FWD_TOL = dict(rtol=1e-5, atol=1e-6)      # tests/test_inference.py


def fleet_health(rep) -> dict:
    try:
        return rep.health()
    except Exception:   # a replica between its spawn and its bind
        return {}


def wait_for(cond, timeout_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if cond():
            return time.perf_counter() - t0
        time.sleep(0.05)
    raise SmokeFailure(f"(18) timed out after {timeout_s} s waiting for "
                       f"{what}")


def hammer(router, reqs, stop, errors, count, limit=None) -> None:
    """One client: router.score on the requests in turn until ``stop``
    (or ``limit`` requests); failures land in ``errors``."""
    i = 0
    while not stop.is_set() and (limit is None or i < limit):
        ids, mask, dense = reqs[i % len(reqs)]
        try:
            out = router.score(ids, mask, dense)
            if out.shape != (len(ids),) or not np.all(np.isfinite(out)):
                errors.append(f"bad scores {out.shape}")
        except Exception as e:   # reported by the caller
            errors.append(repr(e))
        i += 1
        count[0] += 1


def run_clients(router, reqs, limit=None):
    """FLEET_CLIENTS client threads; returns (stop event, threads,
    errors, count)."""
    import threading
    stop, errors, count = threading.Event(), [], [0]
    threads = [threading.Thread(target=hammer,
                                args=(router, reqs, stop, errors, count,
                                      limit))
               for _ in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    return stop, threads, errors, count


def fleet_serving(torch, kernels, card, total: dict, d: str) -> str:
    """(a) two SubprocessReplicas on cuda:0 behind a Router under four
    client threads, across a publish that kills replica 0 mid-swap;
    (b) the hedged leg. Returns the serving root."""
    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags
    from paddlebox_tpu_torch.data import SlotDataset
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.monitor import flight
    from paddlebox_tpu_torch.serving import ServingPublisher
    from paddlebox_tpu_torch.serving.fleet import ReplicaFleet
    from paddlebox_tpu_torch.serving.router import Router
    lay = ONEHOT
    keys, rng = draw_keys(lay.n_keys)
    store, schema, tr = make_trainer(torch, lay, B, None)
    ds = SlotDataset(schema)
    ds.records = make_records(schema, lay.steps * B, keys, rng, lay.max_len)
    box = BoxPS(store)
    root = os.path.join(d, "serve")
    # a base every pass: a restarted replica cold-starts onto the newest
    # version in one build (the reference test's setting)
    pub = ServingPublisher(root, tr.model, schema, quant="f32",
                           publish_base_every=1, hot_top_k=1024)
    want = {k: lay.steps for k in lay.kernels}

    def publish_pass(p):
        box.begin_pass()
        out, launches = count_pass(kernels, f"(18) pass {p}",
                                   functools.partial(tr.train_pass, ds),
                                   want)
        add_counts(total, launches)
        check(out["steps"] == lay.steps and np.isfinite(out["loss_mean"]),
              f"(18) pass {p}: {out}")
        t0 = time.perf_counter()
        info = box.end_pass(trainer=tr, publisher=pub)["publish"]
        check("error" not in info, f"(18) publish failed: {info}")
        print(f"  (a) pass {p} ({card}): loss {out['loss_mean']:.6f} | "
              f"launches {launches} | publish v{info['version']} "
              f"{info['kind']} {info['bytes']} bytes, end_pass "
              f"{time.perf_counter() - t0:.3f} s")
        return info

    publish_pass(1)                                       # v1
    repo = os.path.dirname(os.path.abspath(__file__))
    base_env = {"PYTHONPATH": repo}
    kill_env = dict(base_env,
                    PBTPU_FAULTPOINT="serving.fleet.replica.pre_build",
                    PBTPU_FAULTPOINT_AFTER="1")   # hit 2 = the v2 build
    fleet = ReplicaFleet(root, replicas=2, workdir=os.path.join(d, "fw"),
                         poll_s=0.1, backoff0_s=0.2, supervise_tick_s=0.05,
                         window_s=0, replica_env=lambda i: (
                             kill_env if i == 0 else base_env))
    check(fleet.device == "cuda", f"(18) fleet device {fleet.device}")
    router = Router(fleet.replicas, timeout_s=120.0, health_ttl_s=0.5,
                    hedge_factor=0.0)
    fleet.attach_router(router)
    sink = monitor.MemorySink()
    monitor.hub().enable(sink)
    procs = []
    try:
        t0 = time.perf_counter()
        fleet.start()
        procs += [r.proc for r in fleet.replicas]
        wait_for(lambda: all(fleet_health(r).get("active_version") == 1
                             for r in fleet.replicas), 300,
                 "both replicas on v1")
        ids, mask, dense = request_arrays(tr, next(iter(ds.batches(B))))
        reqs = [(ids[i:i + FLEET_REQ], mask[i:i + FLEET_REQ],
                 dense[i:i + FLEET_REQ]) for i in range(0, B, FLEET_REQ)]
        router.score(*reqs[0])
        print(f"  (a) two replica processes on {fleet.device} ({card}): "
              f"spawned and serving v1 in {time.perf_counter() - t0:.1f} s")
        stop, threads, errors, count = run_clients(router, reqs)
        try:
            t_pub = time.perf_counter()
            info = publish_pass(2)                         # v2: replica 0
            wait_for(lambda: 137 in fleet.replicas[0].exits, 300,
                     "replica 0's fault-point kill")
            t_restart = wait_for(lambda: fleet.replicas[0].alive()
                                 and fleet_health(fleet.replicas[0]).get(
                                     "active_version") == 2, 300,
                                 "replica 0 restarted on v2")
            wait_for(lambda: all(
                r.alive() and fleet_health(r).get("active_version") == 2
                and fleet_health(r).get("status") == "ok"
                for r in fleet.replicas), 300, "the fleet on v2")
            t_conv = time.perf_counter() - t_pub
            router.score(*reqs[0])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        rs = router.stats()
        check(not errors, f"(18) failed requests: {errors[:3]}")
        check(rs["failures"] == 0 and rs["sheds"] == 0,
              f"(18) router {rs}")
        check(fleet.restarts >= 1 and not fleet.replicas[0].quarantined,
              f"(18) restarts {fleet.restarts}")
        staged = sorted(os.listdir(os.path.join(fleet.staging_root,
                                                "versions")))
        check(staged == ["v-000001", "v-000002"],
              f"(18) staging holds {staged}")
        fields = fleet.commit_window(force=True)
        rec = sink.find("fleet_window")[-1]
        errs = flight.validate_fleet_record(rec)
        check(errs == [], f"(18) fleet_window: {errs}")
        check(fields["healthy"] == 2 and fields["restarts"] >= 1,
              f"(18) fleet_window {fields}")
        print(f"  (a) replica 0 killed mid-swap ({card}): exits "
              f"{fleet.replicas[0].exits}, back on v2 {t_restart:.3f} s "
              f"after its kill was seen, the fleet on v{info['version']} "
              f"{t_conv:.3f} s after pass 2 began | {count[0]} requests "
              f"of {FLEET_REQ} from {FLEET_CLIENTS} clients, 0 failed, 0 "
              f"shed | router requests {rs['requests']} retries "
              f"{rs['retries']} timeouts {rs['timeouts']} degraded "
              f"{rs['degraded_dispatches']} | p50 {rs['p50_ms']:.3f} ms "
              f"p99 {rs['p99_ms']:.3f} ms | staging {staged} (one "
              f"verified copy a version) | fleet_window valid: {fields}")
        # (b) the hedged leg: the flag's factor, a fresh window
        old = flags.serving_hedge_factor
        flags.serving_hedge_factor = FLEET_HEDGE_FACTOR
        try:
            hedged = Router(fleet.replicas, timeout_s=120.0,
                            health_ttl_s=0.5)
        finally:
            flags.serving_hedge_factor = old
        check(hedged.hedge_factor == FLEET_HEDGE_FACTOR,
              f"(18) hedge factor {hedged.hedge_factor}")
        t0 = time.perf_counter()
        stop, threads, errors, count = run_clients(
            hedged, reqs, limit=FLEET_HEDGE_REQS)
        for t in threads:
            t.join(timeout=300)
        hs = hedged.stats()
        check(not errors and hs["failures"] == 0
              and hs["requests"] == FLEET_CLIENTS * FLEET_HEDGE_REQS,
              f"(18) hedged leg: {errors[:3]} {hs}")
        print(f"  (b) hedged leg, serving_hedge_factor "
              f"{FLEET_HEDGE_FACTOR} ({card}): {hs['requests']} requests "
              f"in {time.perf_counter() - t0:.3f} s | hedges "
              f"{hs['hedges']} won {hs['hedges_won']} discarded "
              f"{hs['hedge_discards']} | retries {hs['retries']} | p50 "
              f"{hs['p50_ms']:.3f} ms p99 {hs['p99_ms']:.3f} ms")
    finally:
        monitor.hub().disable()
        fleet.stop()
    check(all(p.poll() is not None for p in procs),
          "(18) a replica process outlived the fleet")
    del store, tr, ds, box
    torch.cuda.empty_cache()
    return root


def fleet_export(torch, card, root: str, d: str) -> None:
    """(c) the active model exported at B with export_stablehlo, loaded
    on the card, held to Predictor.predict; a torn pair rejected."""
    from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
    from paddlebox_tpu_torch.inference.stablehlo import (META_FILE,
                                                         MODULE_FILE,
                                                         export_stablehlo,
                                                         load_stablehlo)
    from paddlebox_tpu_torch.serving import ServingServer
    from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError
    srv = ServingServer(root)
    check(srv.poll_once() >= 1, "(18) the server loaded nothing")
    m = srv.active
    pred = m.predictor
    path = os.path.join(d, "program")
    t0 = time.perf_counter()
    export_stablehlo(path, pred.model, pred.params, pred.schema,
                     batch_size=B, pull_width=pred.table.pull_width)
    t_exp = time.perf_counter() - t0
    t0 = time.perf_counter()
    call = load_stablehlo(path)
    t_load = time.perf_counter() - t0
    check(call.device.type == "cuda", f"(18) program on {call.device}")
    lay = ONEHOT
    keys, _ = draw_keys(lay.n_keys)
    schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                batch_size=B, max_len=lay.max_len)
    ds = SlotDataset(schema)
    ds.records = make_records(schema, B, keys,
                              np.random.default_rng(SEED + 18),
                              lay.max_len)
    pb = next(iter(ds.batches(B)))
    lc, lw, _ = schema.float_split_cols("label")
    dense = np.ascontiguousarray(np.concatenate(
        [pb.floats[:, :lc], pb.floats[:, lc + lw:]], axis=1), np.float32)
    ids, mask = pb.ids.astype(np.uint64), pb.mask
    want = pred.predict(ids, mask, dense)
    pulled = pred.table.lookup(ids, mask)
    got = call(pulled, mask, dense)
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, **FWD_TOL)
    staged = [torch.as_tensor(a, device=call.device)
              for a in (pulled, mask, dense)]
    with torch.no_grad():
        ms = time_ms(lambda: call.program(*staged), iters=20)
        ms_eager = time_ms(lambda: pred.forward(*staged), iters=20)
    t0 = time.perf_counter()
    call(pulled, mask, dense)
    host_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(os.path.join(path, MODULE_FILE))
    meta_p = os.path.join(path, META_FILE)
    with open(meta_p) as f:
        meta = json.load(f)
    meta["module_crc32"] = (meta["module_crc32"] + 1) & 0xFFFFFFFF
    with open(meta_p, "w") as f:
        json.dump(meta, f)
    try:
        load_stablehlo(path)
        raise SmokeFailure("(18) a torn program/meta pair loaded")
    except CheckpointCorruptError:
        pass
    print(f"  (c) export_stablehlo of v{m.version} at batch {B} ({card}): "
          f"export {t_exp:.3f} s, {size} bytes | load on the card "
          f"{t_load:.3f} s | program {ms:.4f} ms a call on staged inputs "
          f"(the eager forward {ms_eager:.4f} ms), {host_ms:.3f} ms with "
          f"H2D and D2H | max abs err vs Predictor.predict {err:.3g} "
          f"(rtol {FWD_TOL['rtol']:g} atol {FWD_TOL['atol']:g}) ok | torn "
          f"pair rejected ok")
    srv.stop()


def fleet_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 18. Returns the launches of every kernel over the phase (the
    two publishing passes; serving and the export launch none)."""
    print(f"== the serving fleet and the exported program ({card}): "
          f"DeepFM one-hot, {B} x {S} slots, two replica processes on "
          f"the card")
    total: dict[str, int] = {}
    seconds = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        root = fleet_serving(torch, kernels, card, total, d)
        seconds["fleet"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        _, launches = count_pass(
            kernels, "(c) export",
            functools.partial(fleet_export, torch, card, root, d), {})
        add_counts(total, launches)
        seconds["export"] = round(time.perf_counter() - t0, 1)
    print(f"launches in phase 18: {total} | seconds: {seconds}")
    return total


# ---------------------------------------------------------------------------
# phase 19: tensor, expert, sequence and pipeline parallelism
# ---------------------------------------------------------------------------

PAR_TP_DIMS = (1024, 4096, 4096, 1024)
PAR_TP_BATCH = 8192
PAR_MOE = dict(experts=8, d_model=1024, d_hidden=4096, tokens=8192, top_k=2,
               capacity=2.0, drop_capacity=0.25)
PAR_ATTN = dict(heads=16, head_dim=64, seq=16384, grad_seq=4096)
PAR_PP = dict(stages=2, width=1024, layers=2, micro=8, micro_batch=1024)
PAR_WORLD = 2
# the dtype of the gradient checks: at these widths two f32 reductions
# of the same sum in different orders (a 2048-lane expert group against
# an 8192-row dense einsum) differ by f32 rounding near the JAX tests'
# atol where the sum cancels (2 of 33.5M MoE elements past it on the
# card), so the gradients are held in float64, where the modules'
# own arithmetic is all that can differ; forwards are held in f32
GRAD_DTYPE = "float64"
PAR_TOL = {"tp": dict(rtol=2e-5, atol=2e-5),   # tests/test_tensor_parallel
           "tp_grad": dict(rtol=2e-4, atol=2e-5),
           "ep": dict(rtol=2e-4, atol=2e-5),   # tests/test_expert_parallel
           "sp": dict(rtol=2e-4, atol=2e-5),   # test_sequence_parallel
           "sp_grad": dict(rtol=5e-4, atol=5e-4),
           "sp_bf16": dict(rtol=0.06, atol=0.06),
           "pp": dict(rtol=2e-5, atol=2e-5),   # tests/test_pipeline.py
           "pp_grad": dict(rtol=1e-4, atol=1e-5)}


def par_close(name, got, want, tol, errs: dict) -> None:
    import torch
    dt = torch.promote_types(torch.promote_types(got.dtype, want.dtype),
                             torch.float32)
    got, want = got.detach().to(dt), want.detach().to(dt)
    err = max_err(got, want)
    errs[name] = max(errs.get(name, 0.0), err)
    try:
        torch.testing.assert_close(got, want, **tol)
    except AssertionError as e:
        raise SmokeFailure(f"(19) {name}: max abs err {err:.3g} past rtol "
                           f"{tol['rtol']:g} atol {tol['atol']:g}: "
                           f"{e}") from e


def wall_ms(torch, fn) -> float:
    """One call's wall ms, the card synchronised on both sides (at world
    2 it includes the call's host-staged collectives)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def seeded(torch, shape, seed, scale=1.0):
    """A seeded normal tensor made on the host (the same on every rank)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def par_tp(torch, mesh, rec: dict) -> None:
    """The TP MLP against mlp_reference, forward in f32 and gradients in
    GRAD_DTYPE (the output is replicated over tp: every rank's loss is
    the whole one)."""
    from paddlebox_tpu_torch.parallel import tensor as tp
    dev = mesh.device
    dims = PAR_TP_DIMS
    params = [{k: v.to(dev) for k, v in p.items()}
              for p in tp.init_tp_mlp(SEED, dims, device="cpu")]
    x = seeded(torch, (PAR_TP_BATCH, dims[0]), SEED + 1).to(dev)
    errs = rec.setdefault("err", {})
    n, i = mesh.axis_size("tp"), mesh.axis_index("tp")
    modes = tp.plan_modes(dims, n)
    fn = tp.make_tp_mlp(mesh, dims)
    shards = tp.shard_tp_params(mesh, params)
    with torch.no_grad():
        par_close("tp forward", fn(shards, x), tp.mlp_reference(params, x),
                  PAR_TOL["tp"], errs)
        staged0 = mesh.staged_seconds
        rec["tp_ms"] = wall_ms(torch, lambda: fn(shards, x))
        rec["tp_staged_s"] = mesh.staged_seconds - staged0
    rec["tp_modes"] = modes
    gd = getattr(torch, GRAD_DTYPE)
    params = [{k: v.to(gd) for k, v in p.items()} for p in params]
    x = x.to(gd)
    ref = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
           for p in params]
    (tp.mlp_reference(ref, x) ** 2).sum().backward()
    shards = tp.shard_tp_params(mesh, params)
    for p in shards:
        for v in p.values():
            v.requires_grad_(True)
    (fn(shards, x) ** 2).sum().backward()
    for mode, p, r in zip(modes, shards, ref):
        gw, gb = r["w"].grad, r["b"].grad
        if mode == "col":
            k = gw.shape[1] // n
            gw, gb = gw[:, i * k:(i + 1) * k], gb[i * k:(i + 1) * k]
        elif mode == "row":
            k = gw.shape[0] // n
            gw = gw[i * k:(i + 1) * k]
        par_close("tp grads", p["w"].grad, gw, PAR_TOL["tp_grad"], errs)
        par_close("tp grads", p["b"].grad, gb, PAR_TOL["tp_grad"], errs)


def par_moe(torch, mesh, rec: dict) -> None:
    """The MoE against moe_reference: top-2 at capacity factor 2.0,
    forward in f32 and gradients in GRAD_DTYPE (each rank's loss is its
    rows: the experts' gradients sum every rank's, the replicated
    gate's are this rank's), then top-1 at 0.25 in f32, whose zeroed
    rows must be dropped_tokens."""
    from paddlebox_tpu_torch.parallel import expert as ep
    dev = mesh.device
    c = PAR_MOE
    params = {k: v.to(dev) for k, v in ep.init_moe(
        SEED, c["experts"], c["d_model"], c["d_hidden"],
        device="cpu").items()}
    x = seeded(torch, (c["tokens"], c["d_model"]), SEED + 2).to(dev)
    n, i = mesh.axis_size("ep"), mesh.axis_index("ep")
    b, e = c["tokens"] // n, c["experts"] // n
    rows = slice(i * b, (i + 1) * b)
    errs = rec.setdefault("err", {})
    check(ep.dropped_tokens(params, x, n, c["top_k"], c["capacity"]) == 0,
          f"(19) moe: capacity factor {c['capacity']} dropped tokens")
    fn = ep.make_moe(mesh, c["experts"], top_k=c["top_k"],
                     capacity_factor=c["capacity"])
    shards = ep.shard_moe_params(mesh, params)
    with torch.no_grad():
        par_close("moe forward", fn(shards, x[rows]),
                  ep.moe_reference(params, x, top_k=c["top_k"])[rows],
                  PAR_TOL["ep"], errs)
        torch.cuda.empty_cache()
        staged0 = mesh.staged_seconds
        rec["moe_ms"] = wall_ms(torch, lambda: fn(shards, x[rows]))
        rec["moe_staged_s"] = mesh.staged_seconds - staged0
    gd = getattr(torch, GRAD_DTYPE)
    p64 = {k: v.to(gd) for k, v in params.items()}
    ref = {k: v.clone().requires_grad_(True) for k, v in p64.items()}
    (ep.moe_reference(ref, x.to(gd), top_k=c["top_k"])[rows] ** 2).sum() \
        .backward()
    mine = ep.shard_moe_params(mesh, p64)
    for v in mine.values():
        v.requires_grad_(True)
    (fn(mine, x[rows].to(gd)) ** 2).sum().backward()
    par_close("moe grads", mine["gate"].grad, ref["gate"].grad,
              PAR_TOL["ep"], errs)
    for k in ("w1", "b1", "w2", "b2"):
        g = mesh.psum(ref[k].grad.contiguous(), "ep")[i * e:(i + 1) * e]
        par_close("moe grads", mine[k].grad, g, PAR_TOL["ep"], errs)
    del ref, mine, p64
    torch.cuda.empty_cache()
    fn1 = ep.make_moe(mesh, c["experts"], top_k=1,
                      capacity_factor=c["drop_capacity"])
    with torch.no_grad():
        y1 = fn1(shards, x[rows])
        want1 = ep.moe_reference(params, x, top_k=1)[rows]
    zero = (y1 == 0).all(dim=1)
    match = torch.isclose(y1, want1, **PAR_TOL["ep"]).all(dim=1)
    dropped = ep.dropped_tokens(params, x[rows], 1, 1, c["drop_capacity"])
    check(bool((zero | match).all()), "(19) moe drops: a kept row differs")
    check(int(zero.sum()) == dropped > 0,
          f"(19) moe drops: {int(zero.sum())} zeroed rows, {dropped} "
          f"dropped")
    rec["moe_dropped"] = dropped
    rec["moe_dropped_world"] = ep.dropped_tokens(params, x, n, 1,
                                                 c["drop_capacity"])


def par_attention(torch, mesh, rec: dict) -> None:
    """Ring and Ulysses (causal) and a bf16 ring against
    attention_reference at PAR_ATTN's sequence, forward in f32 (bf16);
    the gradients in GRAD_DTYPE at grad_seq tokens (tokens cut, widths
    kept: the reference's autograd holds (S, S) scores per head)."""
    from paddlebox_tpu_torch.parallel import sequence as sp
    dev = mesh.device
    c = PAR_ATTN
    axis = "dp"
    errs = rec.setdefault("err", {})
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def qkv(seq, seed):
        return [seeded(torch, (1, seq, c["heads"], c["head_dim"]),
                       seed + j, 0.5).to(dev) for j in range(3)]

    def reference_rows(q, k, v, rows, chunk=2):
        """The full reference's rows, two heads at a time."""
        out = []
        with torch.no_grad():
            for h in range(0, c["heads"], chunk):
                hs = slice(h, h + chunk)
                out.append(sp.attention_reference(
                    q[:, :, hs], k[:, :, hs], v[:, :, hs],
                    causal=True)[:, rows])
                torch.cuda.empty_cache()
        return torch.cat(out, dim=2)

    q, k, v = qkv(c["seq"], SEED + 3)
    shards = [sp.seq_shard(t, mesh, axis) for t in (q, k, v)]
    s_l = c["seq"] // n
    want = reference_rows(q, k, v, slice(i * s_l, (i + 1) * s_l))
    for mode in ("ring", "ulysses"):
        fn = sp.make_sequence_parallel_attention(mesh, axis, mode=mode,
                                                 causal=True)
        staged0 = mesh.staged_seconds
        with torch.no_grad():
            par_close(f"{mode} forward", fn(*shards), want, PAR_TOL["sp"],
                      errs)
            torch.cuda.empty_cache()
            rec[f"{mode}_ms"] = wall_ms(torch, lambda: fn(*shards))
        rec[f"{mode}_staged_s"] = mesh.staged_seconds - staged0
        torch.cuda.empty_cache()
    fn = sp.make_sequence_parallel_attention(mesh, axis, mode="ring",
                                             causal=True)
    half = [t.to(torch.bfloat16) for t in shards]
    with torch.no_grad():
        y = fn(*half)
        check(y.dtype == torch.bfloat16, f"(19) bf16 ring gave {y.dtype}")
        par_close("ring bf16 forward", y, want, PAR_TOL["sp_bf16"], errs)
        del y
        torch.cuda.empty_cache()
        rec["ring_bf16_ms"] = wall_ms(torch, lambda: fn(*half))
    del q, k, v, shards, half, want
    torch.cuda.empty_cache()
    gd = getattr(torch, GRAD_DTYPE)
    q, k, v = (t.to(gd) for t in qkv(c["grad_seq"], SEED + 6))
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    s_l = c["grad_seq"] // n
    rows = slice(i * s_l, (i + 1) * s_l)
    # this rank's rows of the loss; the ranks' gradients sum
    (sp.attention_reference(*ref, causal=True)[:, rows] ** 2).sum() \
        .backward()
    g_ref = [mesh.psum(t.grad.contiguous(), axis)[:, rows] for t in ref]
    del ref
    for mode in ("ring", "ulysses"):
        fn = sp.make_sequence_parallel_attention(mesh, axis, mode=mode,
                                                 causal=True)
        mine = [sp.seq_shard(t, mesh, axis).clone().requires_grad_(True)
                for t in (q, k, v)]
        (fn(*mine) ** 2).sum().backward()
        for t, g in zip(mine, g_ref):
            par_close(f"{mode} grads", t.grad, g, PAR_TOL["sp_grad"], errs)
    torch.cuda.empty_cache()


def par_pipeline(torch, mesh, rec: dict) -> None:
    """GPipe against the stages run back to back, forward in f32 and
    the gradients of the mean squared error in GRAD_DTYPE. At pp = 1 one
    stage holds both stages' layers."""
    from paddlebox_tpu_torch.parallel import pipeline as pp
    dev = mesh.device
    c = PAR_PP
    n, i = mesh.axis_size("pp"), mesh.axis_index("pp")
    errs = rec.setdefault("err", {})
    w = seeded(torch, (c["stages"], c["layers"], c["width"], c["width"]),
               SEED + 7, 1.0 / c["width"] ** 0.5).to(dev)
    bias = seeded(torch, (c["stages"], c["layers"], c["width"]), SEED + 8,
                  0.01).to(dev)
    batch = c["micro"] * c["micro_batch"]
    x = seeded(torch, (batch, c["width"]), SEED + 9).to(dev)
    tgt = seeded(torch, (batch, c["width"]), SEED + 10).to(dev)
    stage_fn = pp.mlp_stage_fn(torch.tanh)
    per = c["stages"] // n
    fn = pp.make_pipeline(mesh, stage_fn, c["micro"])

    def run(w, bias, x, grads):
        ref_w = w.clone().requires_grad_(grads)
        ref_b = bias.clone().requires_grad_(grads)
        h = x
        for s in range(c["stages"]):
            h = stage_fn({"w": ref_w[s], "b": ref_b[s]}, h)
        stacked = {"w": w.reshape(n, per * c["layers"], c["width"],
                                  c["width"]),
                   "b": bias.reshape(n, per * c["layers"], c["width"])}
        mine = pp.shard_stage_params(mesh, stacked)
        for t in mine.values():
            t.requires_grad_(grads)
        y = fn(mine, x)
        if grads:
            ((h - tgt.to(h.dtype)) ** 2).mean().backward()
            ((y - tgt.to(y.dtype)) ** 2).mean().backward()
        return h, y, ref_w, ref_b, mine

    with torch.no_grad():
        h, y, _, _, mine = run(w, bias, x, False)
        par_close("pipeline forward", y, h, PAR_TOL["pp"], errs)
        staged0 = mesh.staged_seconds
        rec["pp_ms"] = wall_ms(torch, lambda: fn(mine, x))
        rec["pp_staged_s"] = mesh.staged_seconds - staged0
    gd = getattr(torch, GRAD_DTYPE)
    _, _, ref_w, ref_b, mine = run(w.to(gd), bias.to(gd), x.to(gd), True)
    gw = ref_w.grad.reshape(n, -1, c["width"], c["width"])[i:i + 1]
    gb = ref_b.grad.reshape(n, -1, c["width"])[i:i + 1]
    par_close("pipeline grads", mine["w"].grad, gw, PAR_TOL["pp_grad"],
              errs)
    par_close("pipeline grads", mine["b"].grad, gb, PAR_TOL["pp_grad"],
              errs)
    rec["pp_stages_here"] = per


def par_modules(torch, backend: str) -> dict:
    """The four modules on this world's meshes; returns the numbers."""
    import torch.distributed as dist

    from paddlebox_tpu_torch.parallel import expert as ep
    from paddlebox_tpu_torch.parallel import pipeline as pp
    from paddlebox_tpu_torch.parallel import tensor as tp
    from paddlebox_tpu_torch.parallel.mesh import make_mesh
    rec: dict = {}
    world = dist.get_world_size() if dist.is_initialized() else 1
    for name, build, fn in (
            ("tp", lambda: tp.make_tp_mesh(world, backend=backend),
             par_tp),
            ("moe", lambda: ep.make_ep_mesh(world, backend=backend),
             par_moe),
            ("attention", lambda: make_mesh(backend=backend),
             par_attention),
            ("pipeline", lambda: pp.make_pp_mesh(world, backend=backend),
             par_pipeline)):
        mesh = build()
        check(mesh.backend == backend and mesh.device.type == "cuda",
              f"(19) {name}: {mesh}")
        t0 = time.perf_counter()
        fn(torch, mesh, rec)
        rec[f"{name}_s"] = round(time.perf_counter() - t0, 3)
        torch.cuda.empty_cache()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rec


def par_line(card, label, rec) -> str:
    errs = ", ".join(f"{k} {v:.3g}" for k, v in sorted(rec["err"].items()))
    return (f"  {label} ({card}): tp {rec['tp_ms']:.3f} ms (modes "
            f"{rec['tp_modes']}) | moe top-2 {rec['moe_ms']:.3f} ms, "
            f"capacity {PAR_MOE['drop_capacity']} top-1 dropped "
            f"{rec['moe_dropped']} here of "
            f"{rec['moe_dropped_world']} | ring {rec['ring_ms']:.3f} ms, "
            f"ulysses {rec['ulysses_ms']:.3f} ms, bf16 ring "
            f"{rec['ring_bf16_ms']:.3f} ms | gpipe {rec['pp_ms']:.3f} ms "
            f"({rec['pp_stages_here']} stage(s) a rank) | gloo staging s: "
            f"tp {rec['tp_staged_s']:.3f} moe {rec['moe_staged_s']:.3f} "
            f"ring {rec['ring_staged_s']:.3f} ulysses "
            f"{rec['ulysses_staged_s']:.3f} pp {rec['pp_staged_s']:.3f} | "
            f"module seconds tp {rec['tp_s']} moe {rec['moe_s']} "
            f"attention {rec['attention_s']} pipeline {rec['pipeline_s']} "
            f"| peak {rec['peak_gib']:.1f} GiB | max abs err: {errs} ok")


def parallel_worker(argv: list[str]) -> int:
    """One rank of phase 19's world 2: joins over gloo on the current
    card, runs the four modules and writes <dir>/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from paddlebox_tpu_torch.distributed import RoleMaker
    d = argv[0]
    RoleMaker.from_env().init_distributed(backend="gloo", device="cuda")
    rec = par_modules(torch, "gloo")
    rec["jax_loaded"] = "jax" in sys.modules
    with open(os.path.join(d, f"rank{dist.get_rank()}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def parallel_phase(torch, kernels, card) -> dict[str, int]:
    """Phase 19. Returns the launches of every kernel over the phase
    (none: the modules reach no custom kernel)."""
    import torch.distributed as dist

    from paddlebox_tpu_torch.distributed.launch import launch
    print(f"== tensor, expert, sequence and pipeline parallelism ({card}):"
          f" world 1 over nccl, world {PAR_WORLD} over gloo on one card")
    reset_counts(kernels)
    t0 = time.perf_counter()
    check(not dist.is_initialized(), "(19) a process group is open")
    torch.cuda.reset_peak_memory_stats()
    rec = par_modules(torch, "nccl")
    dist.destroy_process_group()
    print(par_line(card, "(a) world 1 over nccl", rec))
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        code = launch(PAR_WORLD, [sys.executable, os.path.abspath(__file__),
                                  "--parallel-worker", d],
                      store_dir=os.path.join(d, "store"),
                      base_env={"GLOO_SOCKET_IFNAME": "lo"},
                      timeout_s=600, local_ranks=[0] * PAR_WORLD)
        check(code == 0, f"(19) a rank of the world of {PAR_WORLD} exited "
              f"{code}")
        for r in range(PAR_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                rr = json.load(f)
            check(not rr["jax_loaded"], "(19) a rank loaded jax")
            print(par_line(card, f"(b) rank {r} of world {PAR_WORLD} over "
                                 f"gloo", rr))
    total = launch_counts(kernels)
    expect_launches("(19)", total, {})
    print(f"launches in phase 19: {total} | seconds: world 1 "
          f"{t1 - t0:.1f}, world {PAR_WORLD} {time.perf_counter() - t1:.1f}")
    return total


PHASES_ENV = "CHIP_SMOKE_PHASES"
ALL_PHASES = tuple(range(5, 20))
# phases that read phase 5's one-hot pass or its profiled busy time
NEEDS_PHASE5 = (9, 12, 17)


def selected_phases() -> set[int]:
    """Phases 5-19 to run: all of them, or those CHIP_SMOKE_PHASES names
    (comma-separated numbers; 1-4 always run, and a phase that reads
    phase 5's results brings phase 5 with it)."""
    raw = os.environ.get(PHASES_ENV, "").strip()
    if not raw:
        return set(ALL_PHASES)
    try:
        want = {int(p) for p in raw.split(",") if p.strip()}
    except ValueError:
        raise SmokeFailure(f"{PHASES_ENV}={raw!r}: want comma-separated "
                           f"phase numbers") from None
    bad = sorted(p for p in want if p not in range(1, 20))
    check(not bad, f"{PHASES_ENV}: no phase {bad} (1-19)")
    want = {p for p in want if p >= 5}
    if want & set(NEEDS_PHASE5):
        want.add(5)
    return want


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paddlebox_tpu_torch.ops import kernels

    sel = selected_phases()
    t_start = time.perf_counter()
    print(f"phases: 1-4, {', '.join(map(str, sorted(sel)))}"
          + (f" ({PHASES_ENV}={os.environ[PHASES_ENV]})"
             if os.environ.get(PHASES_ENV, "").strip() else " (all)"))
    header(torch)
    build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = kernel_phase(torch, kernels, dev, gen)
    seconds = {"1-4": round(time.perf_counter() - t_start, 1)}
    launches = None
    onehot_pass: dict = {}
    card = smi_line()
    phase_launches: dict[int, dict] = {}

    def timed(n, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[str(n)] = round(time.perf_counter() - t0, 1)
        return out

    def main_paths():
        out = {}
        for lay in (MULTI, ONEHOT):
            out.update(main_path(torch, kernels, lay,
                                 onehot_pass if lay is ONEHOT else None))
            torch.cuda.empty_cache()
        return out

    def boundary():
        boundary_drill(torch, card)
        boundary_trainer(torch, kernels, card)

    if 5 in sel:
        launches = timed(5, main_paths)
    if 6 in sel:
        timed(6, lambda: [reference_check(torch, lay)
                          for lay in (MULTI, ONEHOT)])
    if 7 in sel:
        timed(7, persistence_phase, torch, kernels)
    if 8 in sel:
        timed(8, boundary)
    if 9 in sel:
        timed(9, ingest_phase, torch, kernels, card, onehot_pass)
    if 10 in sel:
        timed(10, zoo_phase, torch, kernels, card)
    counted = {11: lambda: serving_phase(torch, kernels, card),
               12: lambda: storage_phase(torch, kernels, card, onehot_pass),
               13: lambda: monitor_phase(torch, kernels, card),
               14: lambda: dispatch_phase(torch, kernels, card),
               15: lambda: mesh_phase(torch, kernels, card),
               16: lambda: resilience_phase(torch, kernels, card),
               17: lambda: read_side_phase(
                   torch, kernels, card,
                   {r["name"]: r["bound_ms"] for r in rows}),
               18: lambda: fleet_phase(torch, kernels, card),
               19: lambda: parallel_phase(torch, kernels, card)}
    for n, fn in counted.items():
        if n in sel:
            phase_launches[n] = timed(n, fn)
    # launch columns of the phases that did not run are null
    for r in rows:
        r["launches"] = None if launches is None else launches[r["name"]]
        for n in counted:
            r[f"phase{n}_launches"] = (phase_launches[n].get(r["name"], 0)
                                       if n in phase_launches else None)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            *(f"phase{n}_launches" for n in counted))
    print(f"seconds by phase: {seconds} | whole script "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--midpass-worker"]:
        sys.exit(midpass_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--remote-worker"]:
        sys.exit(remote_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--trace-worker"]:
        sys.exit(trace_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--resilience-worker"]:
        sys.exit(res_worker().main())
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    sys.exit(main())
