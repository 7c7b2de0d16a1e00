"""Closed registry of hub event and span names — the port's copy of
``paddlebox_tpu/monitor/names.py``, kept identical so one dashboard or
doctor rule reads both packages' streams.

The set of names the telemetry plane can emit is CLOSED and therefore
greppable: pblint's ``event-registry`` rule fails the tree when a
literal ``monitor.event("...")`` / ``monitor.span("...")`` site names
something not listed in the JAX package's registry, which this copy
mirrors. The port emits a subset of these names; the rest belong to
subsystems it has not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

# event names (monitor.event / hub.event emissions across the tree)
EVENT_NAMES: tuple[str, ...] = (
    # pass lifecycle (hub / boxps)
    "pass_begin",
    "pass_aborted",
    "flip_phase",
    "eval_pass",
    # trainer hot loop + guards
    "pack_producer_done",
    "nan_guard",
    "routed_dropped",
    "exchange_overflow",
    "exchange_overflow_retry",
    # adaptive wire controller (embedding/exchange.WireController via
    # Trainer._adapt_wire): a per-pass exchange_wire switch, carrying
    # prev/next wire, the winning streak, and the modeled wire costs
    "exchange_wire_adapted",
    "drain_snapshot",
    "drain_snapshot_skipped",
    "elastic_min_world_exit",
    # feed pass (embedding/feed_pass.py)
    "feed_pass_staged",
    "feed_pass_flush",
    # HBM replica hot tier (embedding/replica_cache.TrainerReplicaCache,
    # flags.use_replica_cache): per-boundary rebuild, carrying the
    # replica row count + the pass's flushed hit delta
    "replica_refresh",
    # data plane
    "reader_malformed_line",
    "reader_close_error",
    # resilience (distributed/resilience.py)
    "peer_lost",
    "peer_stalled",
    "resume_election",
    "reform_escalated",
    "reform_sealed",
    "world_resize",
    "world_grow",
    # self-healing runtime (runtime/remediation.py)
    "remediation_applied",
    "remediation_reverted",
    # serving (publisher + server + boxps degrade arm)
    "serving_publish",
    "serving_publish_failed",
    "serving_compaction_error",
    "serving_donefile_compacted",
    "serving_artifact_prune_error",
    "serving_swap",
    "serving_version_fallback",
    # serving observability (serving/obs.py via server.commit_window):
    # the per-window serving flight record — requests, per-version
    # p50/p99 + score stats, version lag, swap count, replica-cache hits
    "serving_window",
    # serving fleet (serving/fleet.py + serving/router.py):
    # replica supervision (restart with backoff, crash-loop quarantine),
    # the shared staging lease (expiry retake), the router's all-stale
    # degrade, and verdict-guarded auto-promotion (promote after K clean
    # windows / HOLD + version quarantine on a critical verdict). The
    # per-window fleet flight record rides fleet_window.
    "fleet_window",
    "fleet_replica_restart",
    "fleet_replica_quarantined",
    "fleet_lease_retaken",
    "fleet.serving_stale",
    "fleet_promoted",
    "fleet_promote_hold",
    "fleet_version_quarantined",
    "fleet_supervise_error",
    # fleet / donefile discipline
    "donefile_compacted",
    "donefile_repaired",
    "donefile_malformed_line",
    "fleet_base_fetch_fallback",
    # checkpoints (utils/pass_ckpt.py)
    "checkpoint_save",
    "checkpoint_resume",
    "checkpoint_remote_upload",
    "checkpoint_remote_download",
    "checkpoint_remote_fallback",
    "checkpoint_torn_fallback",
    "checkpoint_timeline_reset",
    # fs / faultpoints / dumps
    "fs_exhausted",
    "faultpoint_armed",
    "faultpoint_trip",
    "dump_fields_written",
    # doctor live mode
    "doctor.finding",
    # sink bookkeeping (JsonlSink meta lines — emitted via the writer
    # thread's _meta, read back by monitor/aggregate.py)
    "sink_rotated",
    "sink_dropped",
    # world trace (monitor/trace.py)
    "trace.flow",
    "trace.clock_probe",
    "trace.device_capture",
)

# span names (monitor.span scopes + the StageTimers "stage/<name>"
# emissions — the trainer's emit_stages set)
SPAN_NAMES: tuple[str, ...] = (
    "pack_batch",
    "train_step",
    "auc_update",
    "push_apply",
    "h2d_stage",
    "publish",
    "stage/read",
    "stage/translate",
    "stage/drain",
    # serving request spans (serving/frontend.py + server.py, sampled by
    # flags.serving_trace_sample): batch-coalesce wait vs. score time
    "serve/wait",
    "serve/score",
)

ALL_NAMES: frozenset = frozenset(EVENT_NAMES) | frozenset(SPAN_NAMES)

# the mesh's counters (train/trainer.py on a multi-rank mesh), under the
# JAX package's names (it emits them without a registry): the sharded
# exchange's traffic a pass — tokens routed, unique lanes on the wire
# (the dedup rate), modeled pull / push wire bytes — and the overflow
# policy's drops, eval retries and wire switches; the routed drops and
# preplanned capacity growths of either table layout
EXCHANGE_COUNTERS: tuple[str, ...] = (
    "exchange.tokens",
    "exchange.unique_lanes",
    "exchange.pull_bytes",
    "exchange.push_bytes",
    "exchange.overflow_dropped",
    "exchange.overflow_retries",
    "exchange.wire_switches",
    "trainer.routed_dropped",
    "trainer.capacity_preplanned",
    "trainer.capacity_preplanned_eval",
)


def is_registered(name: str) -> bool:
    return name in ALL_NAMES
