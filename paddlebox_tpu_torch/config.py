"""Flag registry — the port's copy of ``paddlebox_tpu.config``.

Only the flags this package reads, under the same names, defaults and
``PBTPU_<NAME>`` environment overrides as the JAX package, so a forced
value means the same thing in both.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class Flags:
    # parse/download threads of SlotDataset.load_into_memory
    dataset_load_thread_num: int = 8
    # pack-pipeline depth: translate + host plan for batch k+1 run on a
    # background thread while step k trains. 0 = synchronous.
    prefetch_batches: int = 2
    # physical column count of the f32 device table: 0 = logical row
    # width, "auto" = 64 for widths in [14, 64), N = explicit width
    table_pad_width: Any = 0
    # host-plan dedup pre-merge: "auto" | "on" | "off" (see
    # train.trainer.Trainer._dedup_premerge)
    push_dedup_premerge: str = "auto"
    # fused gather-pool pull: "auto" | "on" | "off" (see
    # train.trainer.Trainer._select_pull_engine)
    fused_gather_pool: str = "auto"
    # deferred sparse push (train.trainer.Trainer._select_push_overlap):
    # each step's push operands are staged and applied just before the
    # next step (and at every pass boundary, eval, save and flush), so
    # the push leaves the loss path; the apply lands in stream order
    # before the next pull, which keeps it the same computation as the
    # inline push. "auto" = on at steps_per_dispatch == 1, off above it;
    # "on" / "off" force ("on" with steps_per_dispatch > 1 raises)
    push_overlap: str = "auto"
    # push merge-engine override: "auto" or one of ops.kernels.PUSH_ENGINES
    # (legacy "kernel"/"scatter"/"fused" spellings normalize)
    push_engine: str = "auto"
    # enable knob of the binned push engine: "auto" sends narrow raw
    # token streams on the card to binned_kernel only while this is set
    # (a forced flags.push_engine="binned_kernel" ignores it)
    binned_push: bool = True
    # PassCheckpointer retention: snapshots kept (at least 2, so a torn
    # newest one has a predecessor to fall back to)
    ckpt_keep_last_n: int = 3
    # CommandFS resilience (utils/fs.py): put/get/ls/rm and mkdir -p
    # retry with exponential backoff (the first sleep doubles each
    # attempt); append and test never retry; every non-streaming command
    # is bounded by the timeout (0 = none)
    fs_retry_attempts: int = 3
    fs_retry_backoff_s: float = 0.2
    fs_command_timeout_s: float = 0.0
    # a fresh sparse base chain every N passes (bounds the delta replay at
    # resume and lets retention reclaim old chains); deltas between
    ckpt_base_every: int = 8
    # incremental delta feeds (embedding/feed_pass.py): a store mutation
    # whose reach the stale-key log can prove re-fetches only the rows it
    # touched, and a background staging it overtook is patched, not
    # discarded. Off = any mutation forces the full rebuild (the A/B knob)
    incremental_feed: bool = True
    # FLAGS_check_nan_inf: every step reads its loss back and raises
    # FloatingPointError on nan/inf (as TrainerConfig.check_nan_inf)
    check_nan_inf: bool = False
    # version-split traffic: the share of live request batches the
    # serving server routes to the CANDIDATE version (the newest one,
    # held beside the stable one). 0.0 = every new version swaps in.
    serving_split_fraction: float = 0.0
    # shadow mode: score every request on both versions, serve the
    # stable answer
    serving_shadow: bool = False
    # seconds of traffic a serving window covers (the latency window of
    # stats() and the per-version records); 0 = no windowed records
    serving_window_s: float = 30.0
    # serving latency SLO (ms), stamped into every window record
    serving_slo_ms: float = 50.0
    # the HBM replica hot tier (FLAGS_use_gpu_replica_cache): at every
    # pass boundary the trainer mirrors the rows the spill tier ranks
    # hottest onto the card, and the feed manager fills a pass's fresh
    # keys from it instead of the RAM/disk path. Placement only: training
    # is bit-identical on or off (embedding/replica_cache.py)
    use_replica_cache: bool = False
    # embedx crosses host<->device as bfloat16 at the pass boundary
    # (counters, w and optimizer state stay f32); the device table stays
    # f32. Rounds embedx to 8 mantissa bits once per boundary. Opt-in
    transfer_compress_embedx: bool = False
    # storage tier of a table built by embedding.tiering.store_from_flags:
    # "off" = the in-RAM HostEmbeddingStore, "spill" = SpillEmbeddingStore
    # (a memory-mapped row file under a RAM row cache). A storage choice,
    # never a math change
    table_tiering: str = "off"
    # RAM row-cache slots of a spill store (its host-DRAM hot tier)
    spill_cache_rows: int = 1 << 16
    # RAM row-cache ways per set (set = row_id % n_sets; the coldest way by
    # the TierManager score is the victim); 1 = direct-mapped
    spill_cache_assoc: int = 4
    # root directory of spill row files ("" = a fresh temp dir per store)
    spill_dir: str = ""
    # re-budget each spill cache at the pass boundary off its hit rate and
    # eviction churn (tiering.autotune_cache_rows), within [256, 1<<22]
    spill_cache_autotune: bool = False
    # madvise(WILLNEED) readahead of the spill rows a working-set build is
    # about to fault in, before it reads them
    spill_prefetch: bool = True
    # mid-pass snapshot cadence (steps) of Trainer.enable_midpass_snapshots
    # when called without every_steps; 0 = pass-boundary snapshots only
    ckpt_midpass_every_steps: int = 0
    # RecordEvent span ring capacity of utils.profiler: at most this many
    # spans are kept, oldest dropped first (profiler.dropped_spans counts
    # them); 0 = unbounded
    profiler_max_events: int = 200_000
    # JsonlSink bounded queue: a slow or failed writer drops events
    # (counted) instead of ever blocking the training thread
    telemetry_queue_size: int = 8192
    # JsonlSink size-based rotation: past this many MB the writer opens
    # the next numbered segment (events.jsonl -> events.00001.jsonl);
    # 0 = one unbounded file
    telemetry_rotate_mb: int = 0
    # the monitor's read side, off as in the JAX package: the live doctor
    # and the world trace (host records and the per-pass device capture)
    # are not ported yet, and the hub refuses them when set (ROADMAP
    # queue 1 item 7)
    doctor_live: bool = False
    trace: bool = False
    trace_device: bool = False

    def set(self, name: str, value: Any) -> None:
        if not hasattr(self, name):
            raise KeyError(f"unknown flag {name!r}")
        setattr(self, name, value)

    @classmethod
    def from_env(cls) -> "Flags":
        f = cls()
        for field in dataclasses.fields(cls):
            env_key = "PBTPU_" + field.name.upper()
            if env_key in os.environ:
                raw = os.environ[env_key]
                if field.type in ("int", int):
                    f.set(field.name, int(raw))
                elif field.type in ("float", float):
                    f.set(field.name, float(raw))
                elif field.type in ("bool", bool):
                    f.set(field.name, raw.lower() in ("1", "true", "yes"))
                else:
                    f.set(field.name, raw)
        return f


flags = Flags.from_env()
