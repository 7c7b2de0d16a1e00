"""The trainer — the port of ``train/trainer.py``'s single-device step
and ``train_pass``.

One step (the JAX package's ``core``, trainer.py:476-532): pull the
batch's rows from the pass table (the fused gather-pool kernel for
multi-hot layouts, a plain gather otherwise), run the model, take the
mean sigmoid cross-entropy, differentiate with respect to the dense
params and the pulled tensor, expand the pulled cotangent per token, push
the sparse grads into the table (in-table optimizer), and apply the
dense optimizer. A host thread translates and plans batch k+1 while the
card runs step k.

Around the passes (``trainer.py:1315-2443``): ``train_pass`` feeds a
``MetricRegistry`` per batch and skips the first ``skip_steps`` batches
of a resumed pass; ``eval_pass`` scores a dataset in test mode (no push,
no dense update, the store neither grown nor dirtied, the tail batch
padded and masked out of the AUC) through the same pull engine as
training; ``dense_state`` / ``restore_dense`` / ``save_checkpoint`` /
``resume`` carry the dense params and the optimizer state through a
``PassCheckpointer`` in the JAX package's file format.

The pass boundary is a ``FeedPassManager`` (``trainer.py:226`` in the
JAX package): each pass's working set reuses the rows already on the
card, write-back is lazy (rows reach the host store when they retire or
when ``flush_sparse`` / a store save, shrink or ``get_rows`` flushes),
and ``train_pass(preload_keys=...)`` stages the next pass's fresh rows on
a background thread while this pass trains. Read the store with
``get_rows`` (or after ``flush_sparse``), never ``peek_rows``, to see a
pass's updates.

The model is any of the zoo (``models.MODEL_REGISTRY``). A model that
declares ``batch_extras(pb, n_shards)`` (PV-rank's rank_offset) has it
called on the pack thread per batch, beside translate and the push
plan; its arrays are pinned and copied with the batch and passed to the
model after the standard arguments, in training and in eval (one card:
``n_shards = 1``). The dense optimizer is any of
``optimizers.NAMES``, built with ``dense_optimizer_kwargs``.

Trainer options (``TrainerConfig``, as the JAX package's):
``check_nan_inf`` (or ``flags.check_nan_inf``) reads each step's loss
back — the one host sync a step makes with it on, none with it off — and
on nan/inf raises FloatingPointError naming the non-finite leaves of
{params, loss, preds, labels}, dumped to ``nan_dump_dir`` when set;
``dump_fields_path`` streams ``step i pred label [field:value ...]``
lines of each batch (``dump_fields``: ins_id, float slots, sparse slots)
and, at pass end, ``param <path> v,v,...`` for the dense params matching
``dump_param``, written on a writer thread (``utils/profiler.py``).

Storage tiers (the JAX trainer's :273-289): the store may be a
``SpillEmbeddingStore`` (``tiering.store_from_flags`` under
``flags.table_tiering="spill"``), the table may be quantized
(``EmbeddingConfig.storage`` int8 / int16: a ``QuantTable`` on the card,
pushed through ``binned_merge_acc`` and the requant pass), and under
``flags.use_replica_cache`` the trainer owns a ``TrainerReplicaCache``
attached to its feed manager. At the end of a pass no ``BoxPS`` pass
scope holds (``store.boundary_owner`` is None) ``train_pass`` runs the
boundary itself: ``tiering.end_pass_rebalance`` then
``refresh_replica_boundary``; under a BoxPS pass ``BoxPS.end_pass`` runs
both.

Telemetry (``monitor``): ``train_pass`` runs inside the hub's pass
scope — BoxPS's, or its own (``open_pass_auto``) — and contributes the
stage split of ``self.timers`` (read, translate, train, auc, drain:
``FLIGHT_STAGES``), the steps, examples and seconds, and the boundary
account to the pass's flight record (``hub.record_train``). Each step
emits the ``pack_batch``, ``h2d_stage``, ``train_step`` and
``auc_update`` spans; the pack thread, spawned through
``monitor.context``, counts ``trainer.tokens`` / ``pull_bytes`` /
``push_bytes`` (and the dedup plan's ``trainer.plan_tokens`` /
``plan_unique_tokens``) from the host arrays it already holds. No
counter, span or timer reads a CUDA tensor: with the hub on, a step
still makes no host sync. ``self.timers`` also times, with no hub
event, the main thread's work between those spans: the pass's key set
(``pass_keys``, sorted on the card for a CUDA trainer), the boundary
(``feed_begin``, ``feed_wait``, ``writeback``: the feed manager's
scopes), ``preload``, ``pass_close``, the pass's AUC
(``auc_compute``), and the step's phases as ``utils.step_probe`` names
them (``lookup``, ``dense_fwd_bwd``, ``sparse_push``, ``dense_update``:
host dispatch time). While a torch.profiler session runs every scope
and span opens the range ``pbt/<name>``, so a device trace names what
the host did in each of the device's idle gaps.

Mid-pass snapshots (``enable_midpass_snapshots``): every
``every_steps`` trained steps of a pass the loop commits a
``pass-PPPPP.midSSSSS`` snapshot — after waiting for the steps' kernels
on the stream that launched them (``midpass_saves`` records that wait
with each save's seconds and bytes) — so a crash resumes through
``train_pass(skip_steps=mid_steps)`` instead of replaying the pass.
``drain_and_snapshot`` commits the same kind of snapshot after a pass
raised. The dense optimizer updates the model in place, so the live
dense state at any step is ``dense_state()`` (async dense sync flushes
the host table first; a kstep cadence must land on a sync boundary, and
a kstep drain between syncs is skipped with ``drain_snapshot_skipped``).

Resilience (``distributed/resilience.py``): ``peer_check`` (an
``ElasticWorld.check``) is polled before each dispatch, so a dead or
hung peer aborts the pass at a step boundary; ``recover_world`` then
drain-snapshots, re-forms the world without the dead ranks and reruns
the coordinated resume election; ``resume(collectives=)`` is that
election on a fixed world.

The monitor's read side: ``train_step(..., ablate=...)`` replaces
stages with shape-preserving stand-ins for ``utils.step_probe``'s stage
attribution (never in training); ``enable_self_healing`` binds a
``runtime.remediation.RemediationController`` whose pass-boundary step
(``remediation_boundary``) runs before the flight record commits, in
``train_pass``'s own scope or ``BoxPS.end_pass``;
``note_flow_attribution`` feeds the adaptive wire controller's veto; on
the sharded layout a traced pass (``flags.trace``) stamps one
``exchange`` flow point a step, keyed by pass and step so every rank
stamps the same key.

Dispatch modes, the reference's two other ways to run the same step
(they exclude each other, ``_select_push_overlap``):

- push overlap (``flags.push_overlap``; "auto" turns it on at
  ``steps_per_dispatch == 1``, as the reference does for its one-device
  step): a step returns its push operands to a ``PushOperandStager``
  instead of pushing (``sharded.deferred_push_operands``), and the apply
  (``sharded.apply_deferred``, the inline step's very push) launches
  just before the next step, on the step's own stream, in a
  ``push_apply`` span counted by ``trainer.push_applies``. The pending
  apply lands at pass end (in the loop's ``finally``, so also after a
  batch raised), before ``eval_pass``, before every sparse flush
  (``flush_push`` is the feed manager's pre-flush hook, so saves,
  exports and ``get_rows`` land it) and before each mid-pass snapshot.
  Stream order puts the apply before the next pull, so overlap on is the
  same computation as overlap off;
- supersteps (``TrainerConfig.steps_per_dispatch = k``): the pack thread
  groups k batches and stacks each fixed-shape array (idx, mask, dense,
  labels, the model's extras) into one pinned ``(k, ...)`` buffer, one
  H2D copy each (the push plans, ragged across batches, stay per batch);
  the loop runs the k steps back to back with no host sync, and a tail
  shorter than k trains as single steps. A resume's ``skip_steps`` and a
  mid-pass cadence must be multiples of k.

Precision: the reference computes in f32, so TF32 is turned off for
matmuls and convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) when a Trainer is built.

The mesh (``Trainer(..., mesh=make_mesh(...))``, JAX trainer.py:411-945,
1180-1207, 1800-1975): one rank per card. Every rank iterates the same
global batches and takes its contiguous slice (``Mesh.batch_slice``);
its table is its shard of the pass working set (``feed_pass`` lays the
keys out by owner). A step pulls through the routed exchange of the
table layout (``flags.table_layout``: "sharded" = ``embedding/
exchange.py``, the plan-keyed unique-row all-to-all with the
wire-compressed push and ``gather_pool`` on the received lanes; "single"
= the token-level ``sharded.routed_lookup`` / ``routed_push``; "auto"
picks "sharded" on a multi-rank mesh on the card), runs the model on its
slice, scales the sparse grads by 1/world
(``scale_sparse_grad_by_global_mean``: the global-mean loss's gradient)
and pushes them back through the same exchange. The dense parameters
follow ``dense_sync_mode``: "allreduce" (the global mean of the grads,
one flat all-reduce a step), "kstep" (local updates, parameters averaged
every ``param_sync_step`` steps and at pass end, the optimizer's moments
too with ``sync_dense_moment``) or "async" (the host
``parallel.dense_sync.AsyncDenseTable``: params pulled before and the
global-mean grad pushed after every step); kstep and async also run
without a mesh. Losses, the AUC histograms and drop counts reduce over
the mesh once a pass. Capacity overflow is never silent
(``_preplan_capacity`` sizes the factor from the pass's own routing
histogram before the first step; ``_check_dropped`` counts
``exchange.overflow_dropped``, emits ``exchange_overflow``, and doubles
the factor for the next pass; an eval pass that dropped re-runs in
place).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
import warnings
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch import monitor, weights
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import PackedBatch, SparseLayout
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding import exchange, quant, sharded, tiering
from paddlebox_tpu_torch.embedding.feed_pass import (FEED_STAGES,
                                                     FeedPassManager)
from paddlebox_tpu_torch.embedding.replica_cache import TrainerReplicaCache
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.working_set import (PassWorkingSet,
                                                        PushOperandStager)
from paddlebox_tpu_torch.metrics.auc import AucAccumulator
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor import trace as mon_trace
from paddlebox_tpu_torch.monitor.timers import StageTimers
from paddlebox_tpu_torch.native.key_index import block_plan, dedup_plan
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots
from paddlebox_tpu_torch.parallel import dense_sync
from paddlebox_tpu_torch.train import optimizers
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
from paddlebox_tpu_torch.utils.profiler import (DumpStream, dump_tree,
                                                find_nonfinite)

# the stages of the flight record's stage split, and no others:
# monitor.critical_path attributes the pass wall over exactly these
FLIGHT_STAGES = ("read", "translate", "train", "auc", "drain")
# train_step's phases, as utils.step_probe names them (dense_update has
# no ablation of its own there)
STEP_PHASES = ("lookup", "dense_fwd_bwd", "sparse_push", "dense_update")


@dataclasses.dataclass
class TrainerConfig:
    dense_lr: float = 1e-3
    dense_optimizer: str = "adam"  # adam|sgd|momentum|adagrad|rmsprop|ftrl
    dense_optimizer_kwargs: dict = dataclasses.field(default_factory=dict)
    global_batch_size: int = 256
    auc_buckets: int = 1 << 16
    label_slot: str = "label"
    check_nan_inf: bool = False            # FLAGS_check_nan_inf
    nan_dump_dir: str | None = None        # dump-all-scope dir on nan trip
    dump_fields_path: str | None = None    # DumpField per-instance stream
    # extra per-instance dump columns beyond (step, pred, label):
    # "ins_id", any float slot name, or any sparse slot name (ids joined
    # by ","). dump_param names dense-param path substrings; matched
    # leaves are written to the stream at the end of each pass.
    dump_fields: tuple = ()
    dump_param: tuple = ()
    # batches trained per dispatch (a superstep): the pack thread stacks
    # this many batches into one pinned buffer per array, one H2D copy
    # each, and the loop runs them back to back; the same computation as
    # k single steps. A tail shorter than k trains as single steps
    steps_per_dispatch: int = 1
    # the routed all-to-all's capacity slack (lanes per destination =
    # ceil(tokens * factor / shards)); preplanned and grown, never silent
    capacity_factor: float = 2.0
    # the sparse grads of a mesh step are the local-mean loss's; divide
    # by the world to make them the global mean's, as the dense grads are
    scale_sparse_grad_by_global_mean: bool = True
    # dense sync (BoxPSWorkerParameter.sync_mode, trainer_desc.proto:
    # 100-108): allreduce | kstep | async
    dense_sync_mode: str = "allreduce"
    param_sync_step: int = 1               # K of kstep
    sync_dense_moment: bool = False        # FLAGS_enable_sync_dense_moment
    async_merge_limit: int = 4             # async table grad-merge bound
    async_betas: tuple = (0.99, 0.9999)    # the reference's betas


class _PackError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Trainer:
    """Pass-oriented trainer on one device (the card unless
    ``device="cpu"``), or one rank of a mesh (``mesh=``; the device is
    then the mesh's)."""

    def __init__(self, model, store: HostEmbeddingStore,
                 schema: DataFeedSchema, config: TrainerConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 feed_mgr: FeedPassManager | None = None, mesh=None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device} but the mesh's rank "
                                 f"runs on {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.store = store
        self.schema = schema
        self.cfg = config or TrainerConfig()
        self.layout = SparseLayout.from_schema(schema)
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.world
        self.axes = None if mesh is None else tuple(mesh.axis_names)
        if self.cfg.global_batch_size % self.n_shards:
            raise ValueError("global_batch_size must divide by mesh size")
        if self.cfg.dense_sync_mode not in ("allreduce", "kstep", "async"):
            raise ValueError(self.cfg.dense_sync_mode)
        if self.cfg.param_sync_step < 1:
            raise ValueError(f"param_sync_step must be >= 1, got "
                             f"{self.cfg.param_sync_step}")
        model_dim = getattr(model, "emb_dim", None)
        if model_dim is not None and model_dim != store.cfg.total_dim:
            raise ValueError(
                f"model emb_dim={model_dim} must equal the table's trained "
                f"vector width total_dim={store.cfg.total_dim}")
        model.init(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        if int(self.cfg.steps_per_dispatch) < 1:
            raise ValueError(f"steps_per_dispatch="
                             f"{self.cfg.steps_per_dispatch} must be >= 1")
        self.dense_opt = optimizers.make(
            self.cfg.dense_optimizer, self.cfg.dense_lr, self.params,
            **self.cfg.dense_optimizer_kwargs)
        # async dense sync: the host table owns the dense update
        # (BoxPSAsynDenseTable); its state is the optimizer state
        self.dense_table = None
        if self.cfg.dense_sync_mode == "async":
            self.dense_table = dense_sync.AsyncDenseTable(
                dense_sync.flatten_dense(self.params), lr=self.cfg.dense_lr,
                betas=self.cfg.async_betas,
                merge_limit=self.cfg.async_merge_limit)
        # the mesh's embedding exchange (flags.table_layout), its push
        # wire and all-to-all decomposition (sharded layout only)
        self.table_layout = self._select_table_layout()
        sharded_x = self.table_layout == "sharded"
        self.exchange_wire = (exchange.select_wire(store.cfg) if sharded_x
                              else None)
        self.exchange_topology = (exchange.select_topology(mesh.shape)
                                  if sharded_x else None)
        self._wire_controller = (
            exchange.WireController(store.cfg, self.exchange_wire)
            if sharded_x and flags.exchange_adaptive else None)
        self._wire_stats0: dict | None = None
        self._last_wire_decision: dict | None = None
        if sharded_x and flags.exchange_capacity_factor > 0:
            self.cfg.capacity_factor = max(
                self.cfg.capacity_factor,
                float(flags.exchange_capacity_factor))
        # eval capacity grows apart from the train factor (a skewed eval
        # set must not pad the train step's lanes)
        self._eval_capacity = self.cfg.capacity_factor
        # this pass's over-capacity tokens so far (a device scalar)
        self._dropped: torch.Tensor | None = None
        # the model-extras protocol: a host-side pack stage whose arrays
        # the step passes to the model after the standard arguments
        self._extras_fn = getattr(model, "batch_extras", None)
        self.pull_engine = self._select_pull_engine()
        # host push plans (block or dedup plan, built on the pack thread):
        # on the card while the binned engine is enabled, and wherever a
        # plan-consuming engine is forced (the CPU-parity knob), as in the
        # JAX package with the card in place of the TPU
        # — on one shard; on a mesh the sharded layout's exchange is
        # keyed off the dedup plan (its unique lanes premerge before
        # routing), and the single layout's routed tokens carry none
        forced = kernels.push_engine_flag()
        self._use_plan = (
            (self.n_shards == 1
             and ((self.device.type == "cuda" and flags.binned_push)
                  or forced in ("scatter_accumulate", "binned_kernel")))
            or (sharded_x and flags.pullpush_dedup_keys))
        self._seg = torch.as_tensor(self.layout.segment_ids,
                                    dtype=torch.int64, device=self.device)
        self.global_step = 0
        self.last_ws: PassWorkingSet | None = None
        # "train"/"auc" scopes are the train_step/auc_update spans; of
        # the rest only the flight record's stages emit hub events
        self.timers = StageTimers(
            [*FLIGHT_STAGES, "pass_keys", *FEED_STAGES, "preload",
             "pass_close", "auc_compute", *STEP_PHASES],
            emit_stages={"read", "translate", "drain"},
            spans={"train": "train_step", "auc": "auc_update"})
        # the mid-pass snapshot hook (enable_midpass_snapshots):
        # (checkpointer, every_steps, box, metrics). midpass_cursor_extra
        # carries caller-supplied cursor fields — the shuffle state taken
        # before the pass's permutation draw, so a resume replays the
        # pass order
        self._midpass: tuple | None = None
        self.midpass_cursor_extra: dict = {}
        # each mid-pass save of the last pass: {snapshot, mid_steps,
        # seconds, bytes, stream_wait_s}
        self.midpass_saves: list[dict] = []
        # crumbs of the last (possibly aborted) pass, which
        # drain_and_snapshot reads after the exception landed: the steps
        # it got through (skipped ones included) and whether it raised
        self.last_pass_steps = 0
        self._pass_aborted = False
        # the elastic watchdog (ElasticWorld.check, set by the training
        # loop or recover_world): polled before each dispatch, so a dead
        # or hung peer aborts the pass at a step boundary (the loop's
        # finally then lands the pending push), not at the next barrier
        self.peer_check = None
        # the self-healing loop (enable_self_healing; flags.self_healing)
        # and the newest clock-corrected flow-edge attribution, the wire
        # controller's veto (note_flow_attribution)
        self._remediation = None
        self._flow_attribution: tuple | None = None
        # the world trace's per-pass device capture follows this trainer
        mon_trace.note_device(self.device)
        # the deferred sparse push (flags.push_overlap): the pending
        # step's operands, the working set they apply to while a pass is
        # open or a push is pending, and the applies launched
        self.push_overlap = self._select_push_overlap()
        self._push_stager = PushOperandStager()
        self._overlap_ws: PassWorkingSet | None = None
        self.push_applies = 0
        # the incremental, overlapped pass boundary: resident rows reused
        # across passes, write-back lazy. Pass a shared manager when
        # several trainers drive one table.
        self.feed_mgr = feed_mgr or FeedPassManager(store, self.device,
                                                    mesh=mesh,
                                                    timers=self.timers)
        self.feed_mgr.register_pre_flush(self.flush_push)
        # the host table's storage tier: "spill" or None (in RAM)
        self.table_tiering = tiering.describe(store)
        # the replica hot tier (flags.use_replica_cache): rows the tier
        # manager ranks hottest, on the card, refreshed at every pass
        # boundary and serving the feed manager's fresh keys. Placement
        # only: bit-identical on or off.
        self.replica_cache = None
        if flags.use_replica_cache:
            self.replica_cache = TrainerReplicaCache(store,
                                                     device=self.device)
            self.feed_mgr.set_replica(self.replica_cache)

    # ------------------------------------------------------------------
    # engine selection
    # ------------------------------------------------------------------
    def _select_table_layout(self) -> str:
        """The mesh's embedding exchange (``flags.table_layout``, JAX
        trainer.py:1180): "sharded" = ``embedding/exchange.py`` (the
        dedup plan keys the all-to-all, the push crosses in
        ``flags.exchange_wire``, the pooled pull runs per shard after
        routing); "single" = the token-level routed path. "auto" picks
        "sharded" on a multi-rank mesh on the card (the card in the
        TPU's place) and "single" elsewhere; "sharded" forced on one
        shard raises."""
        tl = flags.table_layout
        if tl not in ("auto", "single", "sharded"):
            raise ValueError(f"table_layout={tl!r}")
        if tl == "sharded":
            if self.n_shards == 1:
                raise ValueError(
                    "flags.table_layout='sharded' needs a multi-device "
                    "mesh — on one shard there is nothing to exchange")
            return "sharded"
        if tl == "single":
            return "single"
        return ("sharded" if self.n_shards > 1 and self.device.type == "cuda"
                else "single")

    def _select_pull_engine(self) -> str:
        """"fused_gather_pool" — rows pool per (example, slot) inside the
        pull (the gather_pool kernel) and the model consumes the
        (B, S, P) sums via PooledSlots; "auto" picks it for multi-hot
        layouts and wide rows (total_dim >= 64) given a uniform slot
        layout, a pooled-pull-capable model and no create-threshold
        gating. "gather_seqpool" — a plain gather + in-model pooling."""
        fg = flags.fused_gather_pool
        if fg not in ("auto", "on", "off"):
            raise ValueError(f"fused_gather_pool={fg!r}")
        if fg == "off":
            return "gather_seqpool"
        lay = self.layout
        cfg = self.store.cfg
        uniform = (lay.num_slots > 0 and len(lay.slot_lens)
                   and np.all(lay.slot_lens == lay.slot_lens[0]))
        # a multi-shard mesh pools through the sharded exchange only
        # (routed_pull_pooled: gather_pool on the received lanes)
        compatible = (uniform
                      and (self.n_shards == 1
                           or self.table_layout == "sharded")
                      and getattr(self.model, "pooled_pull_ok", False)
                      and sharded.fused_pull_supported(cfg))
        if not compatible:
            if fg == "on":
                raise ValueError(
                    "flags.fused_gather_pool='on' needs a uniform slot "
                    "layout, a pooled-pull-capable model (pooled_pull_ok) "
                    "and no create-threshold pull gating")
            return "gather_seqpool"
        if fg == "on":
            return "fused_gather_pool"
        multi_hot = lay.total_len > lay.num_slots
        wide = cfg.total_dim >= 64
        return "fused_gather_pool" if (multi_hot or wide) else "gather_seqpool"

    def _select_push_overlap(self) -> bool:
        """Whether training runs the deferred sparse push
        (``flags.push_overlap``, read when the Trainer is built; JAX
        trainer.py:835). "auto" = on at ``steps_per_dispatch == 1`` (the
        superstep runs its k steps' pushes inline), "on" / "off" force;
        "on" with a superstep or a kstep / async dense sync raises (those
        run the inline push, as in the JAX package)."""
        po = flags.push_overlap
        if po not in ("auto", "on", "off"):
            raise ValueError(f"push_overlap={po!r}")
        if po == "off":
            return False
        ok = (self.cfg.steps_per_dispatch == 1
              and self.cfg.dense_sync_mode == "allreduce")
        if po == "on" and not ok:
            raise ValueError(
                "flags.push_overlap='on' needs the allreduce dense-sync "
                "mode with steps_per_dispatch=1 (the deferred apply is "
                "sequenced between single steps)")
        return ok

    def _dedup_premerge(self) -> bool:
        """Whether the host plan carries the dedup pre-merge
        (flags.push_dedup_premerge). "auto" follows the JAX rule:
        premerge multi-hot batches (duplicate-heavy) and wide rows
        (kernels.wide_rows), and always under a forced fused engine,
        which consumes premerged lanes only; one-hot narrow batches push
        their raw tokens."""
        dd = flags.push_dedup_premerge
        if dd not in ("auto", "on", "off"):
            raise ValueError(f"push_dedup_premerge={dd!r}")
        if dd != "auto":
            return dd == "on"
        if kernels.push_engine_flag() == "scatter_accumulate":
            return True
        multi_hot = self.layout.total_len > self.layout.num_slots
        return multi_hot or kernels.wide_rows(self.store.cfg)

    def push_premerged(self) -> bool:
        """Whether the push engine sees one lane per unique row: always
        on the sharded exchange (premerged per source, merged across
        sources on the owner), else iff the host plan premerges."""
        return (self.table_layout == "sharded"
                or (self._use_plan and self._dedup_premerge()))

    def resolved_push_engine(self, ws: PassWorkingSet) -> str:
        """The push engine the steps run for this working set (for a
        quantized table, the engine of its accumulator)."""
        width = (None if quant.is_quant(ws.table)
                 else int(ws.table.shape[1]))
        return kernels.resolve_push_engine(
            self.store.cfg, ws.padded_rows, premerged=self.push_premerged(),
            device_type=self.device.type, table_width=width)

    # ------------------------------------------------------------------
    # host pack → device
    # ------------------------------------------------------------------
    def split_floats(self, floats: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Packed float columns → (labels (B,), dense (B, F))."""
        lc, lw, _ = self.schema.float_split_cols(self.cfg.label_slot)
        if lc < 0:
            raise ValueError(f"label slot {self.cfg.label_slot!r} not found")
        labels = floats[:, lc:lc + lw].reshape(-1)
        dense = np.concatenate([floats[:, :lc], floats[:, lc + lw:]], axis=1)
        return labels, dense

    def host_plan(self, ws: PassWorkingSet, idx: np.ndarray
                  ) -> sharded.BlockPlan | sharded.DedupPlan | None:
        """The push plan of one batch's translated ids, as numpy arrays: a
        DedupPlan when the batch premerges (with lane windows at the
        binned geometry when the binned engine consumes them), a
        BlockPlan when the binned engine takes the raw tokens, else
        None."""
        if not self._use_plan:
            return None
        flat = idx.reshape(-1)
        if self.table_layout == "sharded":
            return self._exchange_plan(ws, flat)
        n_rows = ws.padded_rows
        geom = None
        if self.resolved_push_engine(ws) == "binned_kernel":
            geom = kernels.binned_geometry(self.store.cfg, n_rows)
        if self.push_premerged():
            # the counting sort needs a block granularity even without
            # windows: one whole-table block
            o, u, s, r, e = dedup_plan(flat, n_rows, *(geom or (n_rows, 1)))
            # the per-pass dedup rate: unique lanes against tokens
            monitor.counter_add("trainer.plan_tokens", idx.size)
            monitor.counter_add("trainer.plan_unique_tokens", len(u))
            return (sharded.DedupPlan(o, u, s, r, e) if geom
                    else sharded.DedupPlan(o, u, s))
        if geom is None:
            return None
        return sharded.BlockPlan(*block_plan(flat, *geom))

    def _exchange_plan(self, ws: PassWorkingSet, flat: np.ndarray
                       ) -> sharded.DedupPlan:
        """The sharded exchange's plan over this rank's batch slice: the
        dedup counting sort over the global rows (no kernel windows —
        tokens after the all-to-all have no host plan), and the exchange
        counters (its unique lanes, less the null row's, are the wire's
        lanes)."""
        rows = ws.global_rows
        o, u, s, _r, _e = dedup_plan(flat, rows, rows, 1)
        n_u = int(np.searchsorted(u, rows)) - int(len(u) > 0 and u[0] == 0)
        ecfg = self.store.cfg
        monitor.counter_add("exchange.tokens", flat.size)
        monitor.counter_add("exchange.unique_lanes", n_u)
        monitor.counter_add("exchange.pull_bytes",
                            exchange.pull_wire_bytes(ecfg, n_u))
        monitor.counter_add("exchange.push_bytes",
                            exchange.push_wire_bytes(ecfg, n_u,
                                                     self.exchange_wire))
        monitor.counter_add("trainer.plan_tokens", flat.size)
        monitor.counter_add("trainer.plan_unique_tokens", n_u)
        return sharded.DedupPlan(o, u, s)

    def _local_batch(self, pb: PackedBatch) -> PackedBatch:
        """This rank's contiguous slice of a global batch (the batch
        itself off a mesh); ``num`` becomes the slice's valid count."""
        if self.mesh is None:
            return pb
        sl = self.mesh.batch_slice(len(pb.floats))

        def cut(a):
            return None if a is None else a[sl]

        return PackedBatch(
            schema=pb.schema,
            num=int(np.clip(pb.num - sl.start, 0, sl.stop - sl.start)),
            ids=pb.ids[sl], mask=pb.mask[sl], floats=pb.floats[sl],
            rank=pb.rank[sl], cmatch=pb.cmatch[sl], ins_id=cut(pb.ins_id),
            search_id=cut(pb.search_id))

    def pack_arrays(self, ws: PassWorkingSet, idx: np.ndarray,
                    mask: np.ndarray, dense: np.ndarray,
                    labels: np.ndarray, with_plan: bool = True,
                    extras: tuple = (), pin: bool = True) -> tuple:
        """Host tensors for one step: (idx, mask, dense, labels, plan,
        extras); plan is host_plan's (None without ``with_plan``: eval
        never pushes), extras the model's batch_extras arrays (a tuple,
        empty for most models). Pinned when the step runs on the card,
        so the copy can overlap compute; ``pin=False`` leaves the
        fixed-shape arrays unpinned (a superstep stacks them into one
        pinned buffer instead)."""
        arrays = (np.ascontiguousarray(idx, np.int32),
                  np.ascontiguousarray(mask, bool),
                  np.ascontiguousarray(dense, np.float32),
                  np.ascontiguousarray(labels, np.float32))
        host = [torch.from_numpy(a) for a in arrays]
        ext = [torch.from_numpy(np.ascontiguousarray(a)) for a in extras]
        plan = sharded.map_plan(
            self.host_plan(ws, idx) if with_plan else None,
            torch.from_numpy)
        if self.device.type == "cuda":
            plan = sharded.map_plan(plan, torch.Tensor.pin_memory)
        out = (*host, plan, tuple(ext))
        return self._pin_host(out) if pin else out

    def _pin_host(self, host: tuple) -> tuple:
        """A pack's fixed-shape tensors pinned (on the card only)."""
        if self.device.type != "cuda":
            return host
        *arrays, plan, extras = host
        return (*(t.pin_memory() for t in arrays), plan,
                tuple(t.pin_memory() for t in extras))

    def _stack_host(self, hosts: list[tuple]) -> tuple:
        """k packs → one superstep's host tensors: each fixed-shape array
        (idx, mask, dense, labels, every extra) stacked into one (k, ...)
        buffer, pinned on the card, and the k push plans as a list (their
        unique-lane arrays are ragged across batches)."""
        pin = self.device.type == "cuda"

        def stack(cols):
            out = torch.empty((len(cols), *cols[0].shape),
                              dtype=cols[0].dtype, pin_memory=pin)
            return torch.stack(cols, out=out)

        n_arrays = len(hosts[0]) - 2
        arrays = [stack([h[j] for h in hosts]) for j in range(n_arrays)]
        extras = []
        for j in range(len(hosts[0][-1])):
            cols = [h[-1][j] for h in hosts]
            if cols[0].dim() < 1 or cols[0].shape[0] != hosts[0][0].shape[0]:
                # the extras protocol's arrays are batch-leading; anything
                # else cannot be sliced per step out of the stacked buffer
                raise ValueError(
                    "steps_per_dispatch>1 requires every model batch_extras "
                    f"array to be batch-leading; got shape "
                    f"{tuple(cols[0].shape)}")
            extras.append(stack(cols))
        return (*arrays, [h[-2] for h in hosts], tuple(extras))

    @staticmethod
    def _step_args(staged: tuple, stacked: bool, i: int) -> tuple:
        """Step ``i``'s tensors out of a staged pack: the pack itself for a
        single step, the i-th slice of every stacked array (no copy, no
        sync) and the i-th plan for a superstep."""
        if not stacked:
            return staged
        *arrays, plans, extras = staged
        return (*(a[i] for a in arrays), plans[i],
                tuple(e[i] for e in extras))

    def _pack_host(self, ws: PassWorkingSet, pb: PackedBatch,
                   with_plan: bool = True, pin: bool = True) -> tuple:
        faultpoint.hit("trainer.pack.pre")
        with self.timers("translate"):
            idx = ws.translate(pb.ids, pb.mask)
            labels, dense = self.split_floats(pb.floats)
            extras = (self._extras_fn(pb, 1) if self._extras_fn is not None
                      else ())
            out = self.pack_arrays(ws, idx, pb.mask, dense, labels,
                                   with_plan, extras, pin=pin)
            # embedding-plane traffic (flight-record deltas), from the
            # host array's size: tokens * pull_width rows out, grad +
            # show/clk lanes back
            ecfg = self.store.cfg
            monitor.counter_add("trainer.tokens", idx.size)
            monitor.counter_add("trainer.pull_bytes",
                                idx.size * 4 * ecfg.pull_width)
            if with_plan:
                monitor.counter_add("trainer.push_bytes",
                                    idx.size * 4 * (ecfg.grad_width + 2))
        return out

    def stage(self, host: tuple) -> tuple:
        """Host tensors from pack_arrays (or a superstep's _stack_host)
        → the step's device tensors: one H2D copy a tensor."""
        dev = self.device

        def put(t):
            return t.to(dev, non_blocking=True)

        with monitor.span("h2d_stage"):
            *arrays, plan, extras = host
            plan = ([sharded.map_plan(p, put) for p in plan]
                    if isinstance(plan, list)
                    else sharded.map_plan(plan, put))
            return (*(put(t) for t in arrays), plan,
                    tuple(put(t) for t in extras))

    def _pack_iter(self, dataset, ws: PassWorkingSet, batch_size: int,
                   test_mode: bool = False, group: int = 1):
        """Yield (packed batches, their staged tensors, stacked), with the
        pack (translate + plan + pin) running on a host thread
        ``flags.prefetch_batches`` items ahead of the step; the step
        thread's wait on it is the "read" stage (starvation = a
        host-bound pass). ``group=k`` > 1 yields full groups of k batches
        stacked into one superstep (``stacked`` True; see _stack_host),
        then the tail as single batches. ``test_mode`` (eval) packs no
        push plan and pads the tail batch instead of dropping it
        (``pb.num`` keeps the valid count)."""
        with_plan = not test_mode

        def source():
            buf: list = []
            for pb in dataset.batches(batch_size, drop_last=not test_mode):
                if len(pb.floats) < batch_size:
                    pb = pb.pad_to(batch_size)
                pb = self._local_batch(pb)
                if group <= 1:
                    yield [pb], self._pack_host(ws, pb, with_plan), False
                    continue
                buf.append((pb, self._pack_host(ws, pb, with_plan,
                                                pin=False)))
                if len(buf) == group:
                    yield ([p for p, _ in buf],
                           self._stack_host([h for _, h in buf]), True)
                    buf = []
            for pb, host in buf:          # the tail: single steps
                yield [pb], self._pin_host(host), False

        depth = flags.prefetch_batches
        if depth <= 0:
            for pbs, host, stacked in source():
                yield pbs, self.stage(host), stacked
            return
        q: Any = queue.Queue(maxsize=depth)
        done = object()
        cancel = threading.Event()

        def producer():
            n_packed = 0
            try:
                for item in source():
                    if cancel.is_set():
                        return
                    q.put(item)
                    n_packed += 1
                # emitted from this thread: it inherits the pass/step
                # context (monitor.context.spawn below)
                monitor.event("pack_producer_done", batches=n_packed)
                q.put(done)
            except BaseException as e:  # re-raised on the consumer side
                q.put(_PackError(e))

        t = mon_ctx.spawn(producer, name="pbt-pack")
        t.start()
        try:
            while True:
                with self.timers("read"):
                    item = q.get()
                if item is done:
                    break
                if isinstance(item, _PackError):
                    raise item.exc
                yield item[0], self.stage(item[1]), item[2]
        finally:
            # an abandoned consumer: stop the producer after its current
            # batch, and drain so a blocked put() wakes to see the event
            cancel.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
            t.join()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _pull(self, table: torch.Tensor, idx: torch.Tensor,
              requires_grad: bool = False, plan=None,
              capacity: float | None = None):
        """One batch's pull and the model input it makes: for the fused
        engine the gather_pool kernel's (B, S, P) sums (PooledSlots), else
        the gathered (B, T, P) rows; on a mesh through the layout's
        routed exchange. Returns (pulled, model input, dropped), dropped
        this rank's count of tokens over capacity (a device scalar, or
        None on one shard)."""
        lay = self.layout
        S = lay.num_slots
        ecfg = self.store.cfg
        fused = self.pull_engine == "fused_gather_pool"
        dropped = None
        capf = self.cfg.capacity_factor if capacity is None else capacity
        if self.n_shards > 1:
            mesh, axes = self.mesh, self.axes
            dedup = flags.pullpush_dedup_keys
            if fused:       # the sharded layout (_select_pull_engine)
                pulled, dropped = exchange.routed_pull_pooled(
                    table, idx, ecfg, mesh, axes, S, lay.total_len // S,
                    capf, plan=plan, return_dropped=True)
            elif self.table_layout == "sharded":
                pulled, dropped = exchange.routed_pull(
                    table, idx.reshape(-1), ecfg, mesh, axes, capf,
                    plan=plan, dedup=dedup, return_dropped=True)
            else:
                pulled, dropped = sharded.routed_lookup(
                    table, idx.reshape(-1), ecfg, mesh, axes, capf,
                    dedup=dedup, return_dropped=True)
            if not fused:
                pulled = pulled.reshape(*idx.shape, ecfg.pull_width)
        elif fused:
            pulled = sharded.fused_pull_pool(table, idx, ecfg, S,
                                             lay.total_len // S)
        else:
            pulled = sharded.lookup(table, idx, ecfg)
        if requires_grad:
            pulled.requires_grad_()
        return pulled, (PooledSlots(pulled) if fused else pulled), dropped

    def _push(self, table, flat_idx: torch.Tensor, grads: torch.Tensor,
              shows: torch.Tensor, clks: torch.Tensor, plan=None,
              premerged: bool = False) -> str:
        """The sparse push into the table, in place: the layout's routed
        exchange on a mesh, ``sharded.push`` on one shard. Returns the
        engine the (owner) shard ran."""
        ecfg = self.store.cfg
        if self.table_layout == "sharded":
            return exchange.routed_push(
                table, flat_idx, grads, shows, clks, ecfg, self.mesh,
                self.axes, self.cfg.capacity_factor,
                wire=self.exchange_wire, plan=plan, premerged=premerged,
                topology=self.exchange_topology)
        if self.n_shards > 1:
            return sharded.routed_push(
                table, flat_idx, grads, shows, clks, ecfg, self.mesh,
                self.axes, self.cfg.capacity_factor,
                dedup=flags.pullpush_dedup_keys, plan=plan)
        return sharded.push(table, flat_idx, grads, shows, clks, ecfg,
                            plan=plan)

    def _mean_dense_grads(self, gp: list[torch.Tensor]) -> list:
        """The global mean of the ranks' dense grads (one flat all-reduce;
        the grads themselves off a mesh)."""
        if self.mesh is None:
            return gp
        flat = self.mesh.pmean(dense_sync.flat_tensor(gp))
        out = [torch.empty_like(g) for g in gp]
        dense_sync.unflatten_into(flat, out)
        return out

    def _opt_moments(self) -> list[torch.Tensor]:
        """The dense optimizer's float state tensors (its moments)."""
        out: list[torch.Tensor] = []

        def walk(x):
            if isinstance(x, (tuple, list)):
                for v in x:
                    walk(v)
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, torch.Tensor) and x.is_floating_point():
                out.append(x)

        walk(self.dense_opt.state_leaves())
        return out

    @torch.no_grad()
    def param_sync(self) -> None:
        """kstep's parameter averaging (SyncParam, boxps_worker.cc:
        481-521): one mean over the mesh of the flat dense parameters,
        and with ``sync_dense_moment`` of the optimizer's moments."""
        if self.mesh is None:
            return
        groups = [self.params]
        if self.cfg.sync_dense_moment:
            groups.append(self._opt_moments())
        for ts in groups:
            if ts:
                dense_sync.unflatten_into(
                    self.mesh.pmean(dense_sync.flat_tensor(ts)), ts)

    @torch.no_grad()
    def _pull_async_params(self) -> None:
        """Async dense sync: the step trains on the table's latest
        parameters (the pull of BoxPSAsynDenseTable)."""
        flat = torch.from_numpy(self.dense_table.pull())
        dense_sync.unflatten_into(flat.to(self.device), self.params)

    def train_step(self, table: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor, dense: torch.Tensor,
                   labels: torch.Tensor, plan=None, extras: tuple = (),
                   defer: bool = False, ablate: tuple = ()):
        """One training step on device tensors. Updates the dense params
        in place (per ``dense_sync_mode``) and ``table`` too, unless
        ``defer``: the push operands then go to the push stager and the
        table changes when ``_dispatch_pending_apply`` launches them.
        Returns (loss, preds) without a host sync; on a mesh they are this
        rank's slice's, and the pull's over-capacity count adds to
        ``_dropped`` (a device scalar, read once a pass).

        ``ablate`` (a subset of {"lookup", "fwdbwd", "push"}, JAX
        trainer.py:410-580) replaces that stage with a shape-preserving
        stand-in, for ``utils.step_probe.attribute_step``: "push" leaves
        the table untouched; "lookup" feeds zeros of the pulled (or
        pooled) shape; "fwdbwd" runs no model — zero dense grads, a zero
        sparse grad of the push's shape and ``loss = sum(pulled) *
        1e-8``. The dense optimizer still steps in every variant, as in
        the reference. Never set in training."""
        lay = self.layout
        S, T = lay.num_slots, lay.total_len
        ecfg = self.store.cfg
        B = idx.shape[0]
        fused = self.pull_engine == "fused_gather_pool"
        mode = self.cfg.dense_sync_mode
        if ablate and defer:
            raise ValueError("ablate instruments the inline step: "
                             "defer must be off")
        timers = self.timers
        if mode == "async":
            self._pull_async_params()
        with timers("lookup"):
            if "lookup" in ablate:
                shape = ((B, S, ecfg.pull_width) if fused
                         else (B, T, ecfg.pull_width))
                pulled = torch.zeros(shape, dtype=torch.float32,
                                     device=idx.device)
                model_in = PooledSlots(pulled) if fused else pulled
                dropped = None
                if "fwdbwd" not in ablate:
                    pulled.requires_grad_()
            else:
                pulled, model_in, dropped = self._pull(
                    table, idx, requires_grad="fwdbwd" not in ablate,
                    plan=plan)
        with timers("dense_fwd_bwd"):
            if "fwdbwd" in ablate:
                loss = pulled.detach().sum() * 1e-8
                preds = torch.zeros(B, dtype=torch.float32,
                                    device=idx.device)
                gp = [torch.zeros_like(p) for p in self.params]
                sgrad = torch.zeros((B * T, ecfg.grad_width),
                                    dtype=torch.float32, device=idx.device)
            else:
                logits = self.model(model_in, mask, dense, lay.segment_ids,
                                    S, *extras)
                loss = F.binary_cross_entropy_with_logits(logits, labels)
                preds = torch.sigmoid(logits.detach())
                # a parameter the loss does not reach (MMoE's other task
                # heads) gets a zero gradient, as jax.grad gives it
                *gp, gpulled = torch.autograd.grad(
                    loss, [*self.params, pulled], allow_unused=True)
                gp = [torch.zeros_like(p) if g is None else g
                      for p, g in zip(self.params, gp)]
                # only the (w, embedx) columns train; show/clk are
                # counters
                if fused:
                    sgrad = sharded.pooled_grad_tokens(gpulled, mask,
                                                       self._seg, S)
                else:
                    sgrad = gpulled[..., 2:].reshape(B * T,
                                                     ecfg.grad_width)
                if (self.n_shards > 1
                        and self.cfg.scale_sparse_grad_by_global_mean):
                    sgrad = sgrad / self.n_shards
        with timers("sparse_push"):
            maskf = mask.to(torch.float32)
            show_inc = maskf.reshape(-1)
            clk_inc = (maskf * labels[:, None]).reshape(-1)
            if defer:
                ops = sharded.deferred_push_operands(
                    idx.reshape(-1), sgrad, show_inc, clk_inc, plan)
                self._push_stager.put((idx, mask, labels, plan, ops))
            elif "push" not in ablate:
                self._push(table, idx.reshape(-1), sgrad, show_inc,
                           clk_inc, plan=plan)
        with timers("dense_update"):
            if mode == "kstep":
                self.dense_opt.step(gp)      # local copy; param_sync later
            elif mode == "async":
                flat = dense_sync.flat_tensor(self._mean_dense_grads(gp))
                self.dense_table.push(flat.detach().cpu().numpy())
            else:
                self.dense_opt.step(self._mean_dense_grads(gp))
        self._note_dropped(dropped)
        return loss.detach(), preds

    def _note_dropped(self, dropped) -> None:
        if dropped is not None:
            self._dropped = (dropped if self._dropped is None
                             else self._dropped + dropped)

    def _take_dropped(self) -> int:
        """The pass's dropped tokens over the whole mesh (one host read
        and one reduction), and reset the count."""
        d, self._dropped = self._dropped, None
        local = 0 if d is None else int(d.item())
        if self.mesh is None:
            return local
        return int(self.mesh.host_psum(np.array([local], np.int64))[0])

    @torch.no_grad()
    def eval_step(self, table: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor, dense: torch.Tensor,
                  extras: tuple = ()):
        """Predictions of one batch (the JAX eval step, trainer.py:894):
        the training step's pull (on a mesh routed without a plan, at the
        eval capacity) and the model's forward; nothing is pushed or
        updated; the over-capacity count adds to ``_dropped``."""
        lay = self.layout
        _, model_in, dropped = self._pull(table, idx,
                                          capacity=self._eval_capacity)
        logits = self.model(model_in, mask, dense, lay.segment_ids,
                            lay.num_slots, *extras)
        self._note_dropped(dropped)
        return torch.sigmoid(logits)

    # ------------------------------------------------------------------
    # the pass
    # ------------------------------------------------------------------
    def train_pass(self, dataset, metrics=None,
                   preload_keys: np.ndarray | None = None,
                   skip_steps: int = 0) -> dict[str, float]:
        """One pass over the dataset: the feed manager builds the working
        set from the dataset's keys (reusing resident rows), every full
        batch trains, and the pass's touched rows are marked for the lazy
        write-back. Returns AUC stats plus loss_first/last/mean, steps,
        step_seconds (the step loop's wall time, device work included)
        and seconds (the whole pass); the boundary's own numbers are the
        feed manager's ``last_*`` attributes. Outside a BoxPS pass the
        pass-boundary tier work runs at the end (``tiering`` in the
        result for a spill store).

        ``metrics``: a MetricRegistry; every registered metric gets each
        batch's (preds, labels, cmatch, rank). ``preload_keys``: the next
        pass's keys; its key diff, host fetch and H2D copy run on the
        feed thread while this pass trains, and the next ``train_pass``
        consumes the staging at its boundary. ``skip_steps``: a resumed
        pass — the first ``skip_steps`` batches are packed (their rows
        stay in the working set) but not trained, since the restored
        state already holds their effect (a snapshot cursor's
        ``mid_steps``); the stats cover the trained tail.

        Telemetry: the pass runs inside the hub's pass scope (opened here
        when no BoxPS pass has one, and then committed here too), so
        every event and span, the pack and feed threads' included,
        carries pass_id/step; the stage split, throughput and boundary
        account go to the pass's flight record."""
        hub = monitor.hub()
        owned_pass = hub.open_pass_auto()
        pass_t0 = time.perf_counter()
        stage0 = self.timers.snapshot()
        applies0 = self.push_applies
        if self._wire_controller is not None and self._wire_stats0 is None:
            # the controller observes whole passes' counter deltas
            self._wire_stats0 = monitor.STATS.snapshot()
        try:
            out = self._train_pass_impl(dataset, metrics, preload_keys,
                                        skip_steps)
        except BaseException as e:
            if owned_pass:
                hub.abort_pass(reason=repr(e))
            raise
        fm = self.feed_mgr
        hub.record_train(
            stage_seconds={k: self.timers.total[k] - stage0[k]
                           for k in FLIGHT_STAGES},
            steps=out["steps"],
            examples=out["steps"] * self.cfg.global_batch_size,
            seconds=time.perf_counter() - pass_t0,
            loss_mean=out.get("loss_mean"), auc=out.get("auc"),
            routed_dropped=out.get("routed_dropped"),
            push_applies=(self.push_applies - applies0) or None,
            pull_engine=self.pull_engine,
            push_engine=(self.resolved_push_engine(self.last_ws)
                         if self.last_ws is not None else None),
            boundary_seconds=round(fm.last_boundary_seconds, 6),
            boundary_split={k: round(v, 6) for k, v
                            in fm.last_boundary_split.items()},
            table_layout=self.table_layout,
            exchange_wire=self.exchange_wire,
            exchange_topology=self.exchange_topology,
            table_tiering=self.table_tiering)
        if owned_pass:
            self.adapt_wire_boundary()
            self.remediation_boundary()
            hub.end_pass(metrics=metrics)
        return out

    def enable_self_healing(self, controller=None):
        """Bind the doctor-driven remediation loop (JAX trainer.py:1401):
        with ``flags.self_healing`` on, every pass boundary consumes the
        live doctor findings and applies at most one action under the
        parity guard (``runtime/remediation.py``). Pass ``controller`` to
        inject a customized one; returns the bound controller."""
        if controller is None:
            from paddlebox_tpu_torch.runtime.remediation import \
                RemediationController
            controller = RemediationController(self)
        self._remediation = controller
        return controller

    def remediation_boundary(self, findings=None):
        """Run the bound RemediationController's pass-boundary step, once
        a pass before the flight record commits (``train_pass`` for a
        trainer-owned scope, ``BoxPS.end_pass`` for a BoxPS one), so the
        remediation record lands in the ending pass's record. None when
        no controller is bound or ``flags.self_healing`` is off; a broken
        controller is counted (``remediation.errors``) and never aborts
        the pass boundary."""
        ctl = self._remediation
        if ctl is None or not flags.self_healing:
            return None
        try:
            return ctl.boundary(findings=findings)
        except Exception:
            monitor.counter_add("remediation.errors")
            return None

    def note_flow_attribution(self, attribution: dict | None,
                              wall_seconds: float | None = None) -> None:
        """Feed the adaptive wire controller a clock-corrected flow-edge
        attribution (``critical_path.attribute_flow_edges`` over a merged
        world trace) and the wall it attributes against. In-process
        records cannot form cross-rank exchange edges, so this evidence
        comes from whoever holds the merged timeline (the remediation
        controller reads the doctor's cross-rank-flow finding); the
        controller uses it as a veto — when the exchange edge is not the
        limiter, the wire holds."""
        self._flow_attribution = (
            (attribution, wall_seconds) if attribution else None)

    def adapt_wire_boundary(self) -> str | None:
        """The pass-boundary wire adaptation (``flags.exchange_adaptive``,
        JAX trainer.py:1480): the controller costs the wires on this
        pass's own exchange counter deltas and, on a switch, the next
        pass's steps push in the new wire. Returns the next pass's wire,
        or None when the controller is off or saw no pass."""
        ctl = self._wire_controller
        stats0, self._wire_stats0 = self._wire_stats0, None
        if ctl is None or stats0 is None:
            return None
        now = monitor.STATS.snapshot()

        def delta(name):
            return int(now.get(name, 0.0) - stats0.get(name, 0.0))

        # every rank adapts on the world's counters, so all switch alike
        tot = self.mesh.host_psum(np.array(
            [delta("exchange.tokens"), delta("exchange.unique_lanes"),
             delta("exchange.overflow_retries")
             + delta("exchange.overflow_dropped")], np.int64))
        flow, wall = self._flow_attribution or (None, None)
        decision = ctl.observe(tokens=int(tot[0]), unique_lanes=int(tot[1]),
                               overflow_retries=int(tot[2]),
                               flow=flow, wall_seconds=wall)
        self._last_wire_decision = decision
        if decision["switched"]:
            monitor.event(
                "exchange_wire_adapted", type="exchange",
                prev=decision["prev_wire"], wire=decision["wire"],
                streak=decision["streak"], reason=decision["reason"],
                costs={w: round(c, 1)
                       for w, c in decision["costs"].items()})
            monitor.counter_add("exchange.wire_switches")
            self.exchange_wire = decision["wire"]
        monitor.hub().record_train(exchange_wire_next=decision["wire"])
        return decision["wire"]

    def _train_pass_impl(self, dataset, metrics,
                         preload_keys: np.ndarray | None,
                         skip_steps: int) -> dict[str, float]:
        cfg = self.cfg
        k = int(cfg.steps_per_dispatch)
        if k > 1 and int(skip_steps) % k:
            # a superstep commits k steps at once: a resume can only land
            # between dispatches
            raise NotImplementedError(
                f"mid-pass resume with steps_per_dispatch={k} needs the "
                f"cursor on a dispatch boundary: skip_steps={skip_steps} "
                f"is not a multiple of {k}")
        if k > 1 and self._midpass is not None and self._midpass[1] % k:
            raise NotImplementedError(
                f"mid-pass snapshots with steps_per_dispatch={k} need a "
                f"cadence on the dispatch boundary: every_steps="
                f"{self._midpass[1]} is not a multiple of {k}")
        t0 = time.perf_counter()
        fm = self.feed_mgr
        with self.timers("pass_keys"):
            keys = dataset.unique_keys(device=self.device)
        ws = fm.begin_pass(keys)
        self.last_ws = ws
        self._overlap_ws = ws if self.push_overlap else None
        self.midpass_saves = []
        self._preplan_capacity(dataset, ws)
        self._dropped = None
        mode = cfg.dense_sync_mode
        if mode == "async":
            self.dense_table.start()
        auc = AucAccumulator(cfg.auc_buckets, device=self.device)
        losses: list[torch.Tensor] = []
        skip = int(skip_steps)
        # the pass's steps so far, skipped ones included: the mid-pass
        # cadence and a snapshot's mid_steps count them
        pass_step = 0
        # DumpField stream: the previous batch's (step, preds, labels) is
        # written each iteration, once the step after it is queued, and
        # the writer thread formats and writes
        dump_stream = (DumpStream(cfg.dump_fields_path, mode="a")
                       if cfg.dump_fields_path else None)
        dump_pending: tuple | None = None
        fm.pass_opened()
        pack_it = None
        try:
            if preload_keys is not None:
                self.preload_pass(preload_keys)
            t_loop = time.perf_counter()
            pack_it = self._pack_iter(dataset, ws, cfg.global_batch_size,
                                      group=k)
            for pbs, staged, stacked in pack_it:
                if skip > 0:
                    # a resumed pass: these batches' effects live in the
                    # restored state (a superstep group skips whole: the
                    # boundary check above makes skip cover it)
                    skip -= len(pbs)
                    pass_step += len(pbs)
                    continue
                # the elastic watchdog, once a dispatch (a superstep
                # group is one, as in the JAX package): a dead or stalled
                # peer aborts here, before this batch launches
                mon_ctx.set_step(self.global_step)
                if self.peer_check is not None:
                    self.peer_check()
                faultpoint.hit("trainer.step.pre")
                # a superstep's k steps run back to back, no host sync
                for i, pb in enumerate(pbs):
                    mon_ctx.set_step(self.global_step)
                    with monitor.span("pack_batch"):
                        (idx, mask, dense, labels, plan,
                         extras) = self._step_args(staged, stacked, i)
                    if mon_trace._ACTIVE and self.table_layout == "sharded":
                        # the world trace's flow point of this step's
                        # all-to-all: every rank stamps the same key (the
                        # ranks step in lockstep), so the merger draws
                        # the cross-rank edge with no trace bytes on the
                        # wire
                        mon_trace.flow(
                            "exchange",
                            f"p{mon_ctx.current().pass_id}"
                            f".s{self.global_step}",
                            **exchange.flow_fields(self.store.cfg,
                                                   self.exchange_wire,
                                                   int(idx.numel())))
                    with self.timers("train"):
                        if self.push_overlap:
                            # the previous step's apply first: the pull
                            # below reads the table it updates, in
                            # stream order
                            self._dispatch_pending_apply(ws.table)
                        loss, preds = self.train_step(
                            ws.table, idx, mask, dense, labels, plan,
                            extras, defer=self.push_overlap)
                        pass_step += 1
                        if (mode == "kstep"
                                and pass_step % cfg.param_sync_step == 0):
                            self.param_sync()
                    with self.timers("auc"):
                        auc.update(preds, labels)
                        if metrics is not None:
                            metrics.add_batch(preds, labels,
                                              cmatch=pb.cmatch, rank=pb.rank)
                    if dump_stream is not None:
                        if dump_pending is not None:
                            dump_stream.write_fields(*dump_pending)
                        dump_pending = (self.global_step, preds, labels,
                                        self._dump_extra_fields(pb))
                    if cfg.check_nan_inf or flags.check_nan_inf:
                        self._nan_guard(loss, preds, labels)
                    losses.append(loss)
                    self.global_step += 1
                    mp = self._midpass
                    if (mp is not None and mp[1] > 0
                            and pass_step % mp[1] == 0):
                        self._midpass_save(ws, pass_step)
            if self.device.type == "cuda":
                # the steps' stream only: a staging copy of the next pass
                # on the feed manager's stream is not step time
                torch.cuda.current_stream(self.device).synchronize()
            step_seconds = time.perf_counter() - t_loop
        finally:
            # drain crumbs: how far this pass got and whether it raised,
            # for drain_and_snapshot after the exception lands
            self.last_pass_steps = pass_step
            self._pass_aborted = sys.exc_info()[0] is not None
            with self.timers("pass_close"):
                if pack_it is not None:
                    # close the pack generator now, so its producer stops
                    # before anything reads or persists the table (the
                    # exception's traceback would keep it alive otherwise)
                    pack_it.close()
                if self.push_overlap:
                    # the pass boundary: the last step's apply is still
                    # pending — land it before anything reads or persists
                    # the table, also when a batch raised
                    self._dispatch_pending_apply(ws.table)
                if mode == "async":
                    # every pushed grad applied; the model holds the
                    # table's parameters
                    self.dense_table.flush()
                    self._pull_async_params()
                elif mode == "kstep" and not self._pass_aborted:
                    self.param_sync()        # the end-of-pass sync
                fm.pass_closed()
                if dump_stream is not None:
                    # flush the tail batch even when the pass raised (a
                    # nan trip must keep its debug stream); a dump failure
                    # is reported but never masks the training exception
                    try:
                        if dump_pending is not None:
                            dump_stream.write_fields(*dump_pending)
                        if cfg.dump_param:
                            self._dump_params(dump_stream)
                        dump_stream.close()
                    except Exception as e:
                        warnings.warn(f"dump stream failed: {e}")
                if not self._pass_aborted:
                    fm.end_pass(ws, ws.table)
        with self.timers("drain"):
            lv = (torch.stack(losses).cpu().numpy().astype(np.float64)
                  if losses else np.zeros(0))
        if self.mesh is not None:
            # the global-mean loss of each step (the JAX step's pmean)
            lv = self.mesh.host_psum(lv) / self.n_shards
        # every launched apply has drained: release the retired slot
        self._push_stager.clear()
        with self.timers("auc_compute"):
            out = self._auc_out(auc)
        out["loss_first"] = float(lv[0]) if len(lv) else float("nan")
        out["loss_last"] = float(lv[-1]) if len(lv) else float("nan")
        out["loss_mean"] = float(np.mean(lv)) if len(lv) else float("nan")
        out["steps"] = len(lv)
        out["step_seconds"] = step_seconds
        out["routed_dropped"] = self._check_dropped(self._take_dropped())
        if self.store.boundary_owner is None:
            # a trainer-owned pass: no BoxPS.end_pass will run the tier
            # re-scoring and the replica refresh, so they run here, the
            # rebalance first (the refresh reads its ranking)
            tier = tiering.end_pass_rebalance(self.store)
            if tier is not None:
                out["tiering"] = tier
            self.refresh_replica_boundary()
        out["seconds"] = time.perf_counter() - t0
        return out

    def refresh_replica_boundary(self) -> int | None:
        """Rebuild the replica hot tier from the tier manager's ranking
        (after ``tiering.end_pass_rebalance``), for the next pass's
        staging. None when the tier is off."""
        if self.replica_cache is None:
            return None
        return self.replica_cache.refresh()

    @staticmethod
    def _read_loss(loss: torch.Tensor) -> float:
        """The non-finite guard's read-back of a step's loss: the one
        host sync a step makes with the guard on."""
        return loss.item()

    def _nan_guard(self, loss: torch.Tensor, preds: torch.Tensor,
                   labels: torch.Tensor) -> None:
        """FLAGS_check_nan_inf's trip: on a nan/inf loss, find the
        offending leaves of {params, loss, preds, labels} (the params
        after this step's update), dump them to ``nan_dump_dir`` when set,
        and raise FloatingPointError naming the step and the leaves."""
        if np.isfinite(self._read_loss(loss)):
            return
        scope = {"params": self.eval_params(), "loss": loss,
                 "preds": preds, "labels": labels}
        bad = find_nonfinite(scope)
        # tell telemetry which paths went non-finite, before the raise
        monitor.counter_add("trainer.nan_trips")
        monitor.event("nan_guard", step=int(self.global_step),
                      paths=bad[:32], n_bad=len(bad))
        dumped = None
        if self.cfg.nan_dump_dir:
            dumped = dump_tree(f"{self.cfg.nan_dump_dir}/nan_step"
                               f"{self.global_step}", scope)
        raise FloatingPointError(
            f"nan/inf loss at step {self.global_step}; non-finite leaves: "
            f"{bad[:8]}" + (f" (scope dumped to {dumped})" if dumped else ""))

    def _dump_extra_fields(self, pb: PackedBatch) -> dict:
        """Per-instance extra dump columns (``dump_fields``): ins_id,
        float slots, sparse slot ids."""
        extra: dict[str, Any] = {}
        sparse_names = {s.name for s in self.schema.sparse_slots}
        float_names = {s.name for s in self.schema.float_slots}
        for f in self.cfg.dump_fields:
            if f in ("pred", "label"):
                continue                    # always in the base columns
            if f == "ins_id":
                extra["ins_id"] = (pb.ins_id if pb.ins_id is not None
                                   else np.zeros(len(pb.floats), np.uint64))
            elif f in float_names:
                vals = pb.float_slot(f).reshape(len(pb.floats), -1)
                # every value of a multi-value float slot (comma-joined)
                extra[f] = vals[:, 0] if vals.shape[1] == 1 else vals
            elif f in sparse_names:
                # the (ids, mask) pair: the writer thread joins the ids
                extra[f] = pb.slot_ids(f)
            else:
                raise KeyError(f"unknown dump field {f!r}")
        return extra

    def _dump_params(self, dump_stream: DumpStream) -> None:
        """DumpParam: the dense params whose path contains one of
        ``dump_param``, one ``param <path> v,v,...`` line each."""
        for name, leaf in flatten_tree(self.eval_params()):
            if not any(pat in name for pat in self.cfg.dump_param):
                continue
            vals = np.asarray(leaf).reshape(-1)
            dump_stream.write(
                f"param {name} " + ",".join(f"{v:.6g}" for v in vals))

    def preload_pass(self, keys: np.ndarray) -> None:
        """BeginFeedPass: stage the next pass's working set (key diff,
        host fetch, H2D of fresh rows) on a background thread while the
        current pass trains."""
        with self.timers("preload"):
            self.feed_mgr.begin_feed_pass(keys)

    def wait_feed_pass_done(self) -> None:
        """Join the background feed pass (WaitFeedPassDone); its error,
        if any, is raised here."""
        self.feed_mgr.wait_feed_pass_done()

    def eval_pass(self, dataset) -> dict[str, float]:
        """Test-mode pass (JAX trainer.py:2389/2421): the working set is
        read without growing or dirtying the store, nothing is pushed and
        the dense params stay; the tail batch is padded and masked out of
        the AUC instead of dropped. Returns the AUC stats plus steps,
        examples, routed_dropped, step_seconds (the batch loop, device
        work included) and seconds (the whole pass). On a mesh the AUC
        and the examples are the world's. A routed pass that dropped
        tokens has already grown the eval capacity (``_check_dropped``)
        and re-runs in place, so the numbers returned are a lossless
        run's (the factor caps at the shard count, where nothing
        drops)."""
        # predictions must see every trained row: a pending deferred
        # apply lands first
        self.flush_push()
        out = self._eval_pass_once(dataset)
        for attempt in range(8):      # the factor doubles up to n_shards
            if (not out["routed_dropped"] or flags.routed_drop_fatal
                    or not flags.routed_drop_adapt):
                break
            faultpoint.hit("exchange.eval.pre_retry")
            monitor.counter_add("exchange.overflow_retries")
            monitor.event("exchange_overflow_retry", type="lifecycle",
                          dropped=int(out["routed_dropped"]),
                          capacity_factor=float(self._eval_capacity),
                          attempt=attempt + 1)
            out = self._eval_pass_once(dataset)
        monitor.event("eval_pass", auc=float(out.get("auc", float("nan"))),
                      routed_dropped=out["routed_dropped"])
        return out

    def _eval_pass_once(self, dataset) -> dict[str, float]:
        cfg = self.cfg
        bs = cfg.global_batch_size
        t0 = time.perf_counter()
        ws = self.feed_mgr.begin_pass(dataset.unique_keys(device=self.device),
                                      test_mode=True)
        self._preplan_capacity(dataset, ws, drop_last=False, for_eval=True)
        auc = AucAccumulator(cfg.auc_buckets, device=self.device)
        rows = torch.arange(bs // self.n_shards, device=self.device)
        steps = examples = 0
        self._dropped = None
        t_loop = time.perf_counter()
        for pbs, staged, _ in self._pack_iter(dataset, ws, bs,
                                              test_mode=True):
            pb = pbs[0]
            idx, mask, dense, labels, _, extras = staged
            preds = self.eval_step(ws.table, idx, mask, dense, extras)
            auc.update(preds, labels, mask=rows < pb.num)
            steps += 1
            examples += pb.num
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_seconds = time.perf_counter() - t_loop
        out = self._auc_out(auc)
        out["steps"] = steps
        out["examples"] = (examples if self.mesh is None else int(
            self.mesh.host_psum(np.array([examples], np.int64))[0]))
        out["step_seconds"] = step_seconds
        out["routed_dropped"] = self._check_dropped(self._take_dropped(),
                                                    for_eval=True)
        out["seconds"] = time.perf_counter() - t0
        return out

    def _auc_out(self, auc: AucAccumulator) -> dict[str, float]:
        """The pass's AUC stats: the world's histograms on a mesh."""
        if self.mesh is None:
            return auc.compute()
        return auc.compute_global(self.mesh.collectives())

    # ------------------------------------------------------------------
    # routed capacity: preplan and the overflow policy
    # ------------------------------------------------------------------
    def _preplan_capacity(self, dataset, ws: PassWorkingSet,
                          drop_last: bool = True,
                          for_eval: bool = False) -> None:
        """Size the all-to-all capacity before the first step (JAX
        trainer.py:1800): scan the pass's global batches once on the host
        (the translate the pack thread runs later; its touch marks are
        idempotent), histogram the routed lanes per (source rank,
        destination shard) — unique tokens when routing dedups, NULL
        tokens never — and grow the factor where the measured maximum
        would drop. Every rank scans the same global batches, so every
        rank lands on the same factor. Factors go in steps of 0.25 and
        never shrink; an eval scan grows only the eval capacity. The
        scan is memoized on the dataset (its size, the pass rows, the
        tail rule and the routing mode key it)."""
        n_dev = self.n_shards
        if n_dev <= 1 or not flags.routed_capacity_preplan:
            return
        bs = self.cfg.global_batch_size
        dedup_route = flags.pullpush_dedup_keys
        n_ex = getattr(dataset, "num_examples", None)
        memo_key = (n_ex, ws.global_rows, drop_last, dedup_route,
                    getattr(dataset, "_records_version", None))
        memo = (getattr(dataset, "_pbt_preplan_need", None)
                if n_ex is not None else None)
        if memo is not None and memo[0] == memo_key:
            capf = memo[1]
        else:
            bpd = bs // n_dev
            n_local = bpd * self.layout.total_len
            max_c = 0
            for pb in dataset.batches(bs, drop_last=drop_last):
                if len(pb.floats) < bs:
                    pb = pb.pad_to(bs)
                per_dev = ws.translate(pb.ids, pb.mask).reshape(n_dev, -1)
                for d in range(n_dev):
                    row = per_dev[d]
                    if dedup_route:
                        row = np.unique(row)
                    row = row[row != 0]       # NULL tokens never route
                    if len(row):
                        c = np.bincount(ws.shard_of(row), minlength=n_dev)
                        max_c = max(max_c, int(c[:n_dev].max()))
            if max_c == 0:
                return
            # _capacity gives ceil(n_local * factor / n_dev) lanes a
            # destination; dedup only shrinks the counts
            need = max_c * n_dev / n_local
            capf = min(float(n_dev), max(1.0, -(-need * 4 // 1) / 4))
            if n_ex is not None and hasattr(dataset, "__dict__"):
                # (a dataset type that cannot carry the memo re-plans)
                dataset._pbt_preplan_need = (memo_key, capf)
        if for_eval:
            if capf > self._eval_capacity:
                monitor.counter_add("trainer.capacity_preplanned_eval", 1)
                self._eval_capacity = capf
        elif capf > self.cfg.capacity_factor:
            monitor.counter_add("trainer.capacity_preplanned", 1)
            self.cfg.capacity_factor = capf
            self._eval_capacity = max(self._eval_capacity, capf)

    def _check_dropped(self, total: int, for_eval: bool = False) -> int:
        """The capacity-drop policy: never silent (JAX trainer.py:1930;
        the reference sizes its buffers dynamically and never drops).
        Counts go to ``trainer.routed_dropped`` (and on the sharded
        layout ``exchange.overflow_dropped`` with an ``exchange_overflow``
        event); ``flags.routed_drop_fatal`` raises; by default the factor
        doubles for the next pass (the eval factor only, for an eval
        pass), up to the shard count. Returns ``total``."""
        if not total:
            return 0
        monitor.counter_add("trainer.routed_dropped", total)
        monitor.event("routed_dropped", total=total, for_eval=for_eval)
        capf = (self._eval_capacity if for_eval
                else self.cfg.capacity_factor)
        if self.table_layout == "sharded":
            monitor.counter_add("exchange.overflow_dropped", total)
            monitor.event("exchange_overflow", total=total,
                          capacity_factor=float(capf), for_eval=for_eval)
        msg = (f"{total} tokens exceeded all_to_all capacity this "
               f"{'eval ' if for_eval else ''}pass "
               f"(capacity_factor={capf}); their pulls returned zero "
               f"rows" + ("" if for_eval
                          else " and their grads were dropped"))
        if flags.routed_drop_fatal:
            raise RuntimeError(msg)
        if flags.routed_drop_adapt:
            grown = min(float(self.n_shards), capf * 2.0)
            if for_eval:
                self._eval_capacity = grown
            else:
                self.cfg.capacity_factor = grown
                self._eval_capacity = max(self._eval_capacity, grown)
            msg += f"; raising capacity_factor to {grown} for the next pass"
        warnings.warn(msg)
        return total

    def set_shard_ownership(self, ownership) -> None:
        """Bind the per-host shard ownership (``distributed.
        ShardOwnership``) on the feed manager: every feed builds only the
        keys of this rank's store shards. ``recover_world`` rebinds the
        feed manager directly after an elastic re-formation, so a shrink
        never reaches the faultpoint: it is the crash window of the
        elastic grow's rebind (``RemediationController.poll_grow``)."""
        faultpoint.hit("elastic.ownership.rebind.pre")
        self.feed_mgr.set_ownership(ownership)

    # ------------------------------------------------------------------
    # dense state and snapshots
    # ------------------------------------------------------------------
    def _dispatch_pending_apply(self, table) -> None:
        """Launch the pending deferred apply (if any) on ``table``, on the
        current stream (JAX trainer.py:2038); the caller sequences it
        before anything reads the table."""
        item = self._push_stager.take()
        if item is None:
            return
        faultpoint.hit("trainer.push_apply.pre")
        idx, mask, labels, plan, ops = item
        with monitor.span("push_apply"):
            if self.n_shards == 1:
                sharded.apply_deferred(table, idx, mask, labels, plan, ops,
                                       self.store.cfg)
            else:
                self._apply_deferred_routed(table, idx, mask, labels, plan,
                                            ops)
        self.push_applies += 1
        monitor.counter_add("trainer.push_applies")

    def _apply_deferred_routed(self, table, idx, mask, labels, plan,
                               ops) -> None:
        """The deferred push on a mesh (JAX ``_build_apply_fn``): lanes
        the step premerged onto the plan's unique rows route as
        premerged; per-token operands replay the inline push with the
        increments recomputed from the staged mask and labels."""
        g0, g1, g2 = ops
        if isinstance(plan, sharded.DedupPlan) and g1.numel():
            self._push(table, plan.uniq, g0, g1, g2, premerged=True)
            return
        maskf = mask.to(torch.float32)
        self._push(table, idx.reshape(-1), g0, maskf.reshape(-1),
                   (maskf * labels[:, None]).reshape(-1), plan=plan)

    def flush_push(self) -> int:
        """Apply a pending deferred sparse push to the live working set
        (JAX trainer.py:2054). Runs at pass end, before ``eval_pass`` and
        mid-pass snapshots, and before every sparse flush (the feed
        manager's pre-flush hook: saves, exports, shrinks, ``get_rows``).
        Returns the applies launched (0 or 1: staleness is bounded at one
        step). Raises while a training pass is open: the loop owns the
        table then."""
        if not self._push_stager.pending():
            return 0
        ws = self._overlap_ws
        if ws is None:
            return 0
        if self.feed_mgr._in_pass:
            raise RuntimeError(
                "flush_push while a training pass is open — the loop "
                "owns the table mid-pass; finish the pass first")
        self._dispatch_pending_apply(ws.table)
        return 1

    def flush_sparse(self) -> int:
        """Move the lazily retained device rows back to the host store
        (JAX trainer.py:2073); store saves, shrinks and ``get_rows`` run it
        through the flush hooks. Returns the bytes moved D2H."""
        self.flush_push()
        return self.feed_mgr.flush()

    def eval_params(self) -> dict:
        """The dense params as a NumPy tree in the JAX layout (for
        FleetUtil models and serving)."""
        return weights.model_params(self.model)

    def dense_state(self) -> dict:
        """{"params", "opt_state"} as NumPy trees in the JAX layout: what
        a pass snapshot's dense.npz holds. Under async dense sync the
        optimizer state is the host table's state dict, as in the JAX
        package."""
        if self.dense_table is not None:
            return {"params": weights.model_params(self.model),
                    "opt_state": self.dense_table.state_dict()}
        return weights.dense_state(self.model, self.dense_opt)

    def restore_dense(self, params, opt_state=None) -> None:
        """Load dense params and, when given, the optimizer state (JAX
        trainer.py:2088) onto the trainer's device. Async: the state is
        the host table's (fresh zero moments when omitted); kstep: every
        rank loads the same (collapsed) parameters."""
        if self.dense_table is None:
            weights.load_dense_state(self.model, self.dense_opt, params,
                                     opt_state)
            return
        weights.load_model_params(self.model, params)
        if opt_state is None:
            flat = dense_sync.flatten_dense(self.params)
            opt_state = {"params": flat, "mom1": np.zeros_like(flat),
                         "mom2": np.zeros_like(flat),
                         "steps": np.asarray([0])}
        self.dense_table.load_state_dict(opt_state)

    def save_checkpoint(self, checkpointer, box=None, metrics=None,
                        pass_id: int | None = None) -> str:
        """Snapshot the post-pass state (dense + optimizer + sparse
        base/delta + metrics + cursor) through a PassCheckpointer."""
        return checkpointer.save(self, box=box, metrics=metrics,
                                 pass_id=pass_id)

    def resume(self, checkpointer, box=None, metrics=None,
               collectives=None) -> dict | None:
        """Restore every plane from the newest snapshot that verifies,
        falling back past a torn one (PassCheckpointer.resume). Returns
        the cursor ({pass_id, global_step, date, phase, mid_steps,
        shuffle_state}) — re-enter the pass loop at ``pass_id + 1``, with
        ``train_pass(skip_steps=mid_steps)`` for a mid-pass snapshot — or
        None on a fresh start. The store's restore is a mutation the
        stale-key log cannot bound, so the feed manager drops any resident
        rows unflushed and the next pass rebuilds its working set in
        full.

        ``collectives`` (a HostCollectives with world > 1) makes it the
        coordinated multi-host resume
        (``distributed.resilience.coordinated_resume``): every rank
        publishes its intact snapshot cursors, the world elects the
        highest one every rank holds intact, and all ranks restore that
        same snapshot, so a torn newest snapshot on one rank rolls the
        whole world back together."""
        if collectives is not None and collectives.world > 1:
            from paddlebox_tpu_torch.distributed import resilience
            return resilience.coordinated_resume(
                checkpointer, self, collectives, box=box, metrics=metrics)
        return checkpointer.resume(self, box=box, metrics=metrics)

    # ------------------------------------------------------------------
    # mid-pass snapshots
    # ------------------------------------------------------------------
    def enable_midpass_snapshots(self, checkpointer,
                                 every_steps: int | None = None,
                                 box=None, metrics=None) -> None:
        """Commit a crash-safe snapshot every ``every_steps`` steps inside
        each training pass (JAX trainer.py:2131). ``every_steps``
        defaults to ``flags.ckpt_midpass_every_steps`` (0 keeps mid-pass
        snapshots off), so a launcher sets the cadence from the
        environment (``PBTPU_CKPT_MIDPASS_EVERY_STEPS``). A snapshot's
        cursor records the last completed pass (``box.pass_id - 1``),
        ``mid_steps`` (the open pass's steps already trained, skipped
        ones of a resumed pass included) and the shuffle state the caller
        put in ``midpass_cursor_extra["shuffle_state"]``, so a kill
        between pass boundaries resumes through
        ``train_pass(skip_steps=mid_steps)``.

        The dense-sync modes (JAX trainer.py:2155-2186): ``allreduce``
        takes any cadence; ``kstep`` needs a multiple of
        ``param_sync_step`` (between syncs the replicas' cadence would
        diverge from the uninterrupted run on resume); ``async``
        quiesces the host dense table (``flush``) before each save and
        stores its state with the params it holds. With
        ``steps_per_dispatch`` k > 1 the cadence must also land on the
        dispatch boundary (a multiple of k: a superstep commits k steps
        at once, so no cursor exists between them)."""
        if every_steps is None:
            every_steps = int(flags.ckpt_midpass_every_steps)
        if every_steps <= 0:
            self._midpass = None
            return
        k = int(self.cfg.steps_per_dispatch)
        if k > 1 and every_steps % k:
            raise NotImplementedError(
                f"mid-pass snapshots with steps_per_dispatch={k} must land "
                f"on the dispatch boundary: every_steps={every_steps} is "
                f"not a multiple of it — the k-step superstep commits k "
                f"steps at once, so no cursor exists between them")
        if (self.cfg.dense_sync_mode == "kstep"
                and every_steps % self.cfg.param_sync_step):
            raise NotImplementedError(
                f"kstep mid-pass snapshots must land on the K-step sync "
                f"boundary: every_steps={every_steps} is not a multiple "
                f"of param_sync_step={self.cfg.param_sync_step} — "
                f"between syncs the replicas' consistency cadence would "
                f"diverge from the uninterrupted run on resume")
        if box is None:
            raise ValueError("enable_midpass_snapshots needs a BoxPS "
                             "(the cursor's pass identity)")
        self._midpass = (checkpointer, int(every_steps), box, metrics)

    def _quiesce_steps(self) -> float:
        """Wait for the queued steps' kernels on the stream that launched
        them — not the whole device: the feed manager's staging stream
        keeps copying the next pass — and return the seconds waited."""
        if self.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter() - t0

    def _snapshot_open_pass(self, checkpointer, box, metrics, ws,
                            steps: int) -> dict:
        """Save the open pass as a mid-pass snapshot at ``steps``: wait
        for the steps' kernels, mark the pass's touched rows unsynced so
        the checkpointer's flush materializes them, and save with the
        live dense state. Returns {snapshot, mid_steps, seconds, bytes,
        stream_wait_s}."""
        t0 = time.perf_counter()
        # the pending deferred apply lands first, so the stream wait
        # covers it too
        self.flush_push()
        wait = self._quiesce_steps()
        if self.dense_table is not None:
            # async: every pushed grad applied, and the params saved are
            # the table's, so the state dict IS the dense state here
            self.dense_table.flush()
            self._pull_async_params()
        ds = self.dense_state()
        self.feed_mgr.end_pass(ws, ws.table)
        snap = checkpointer.save(
            self, box=box,
            metrics=metrics if metrics is not None else box.metrics,
            pass_id=int(box.pass_id) - 1, mid_steps=int(steps),
            dense_override=(ds["params"], ds["opt_state"]),
            shuffle_state=self.midpass_cursor_extra.get("shuffle_state"))
        last = checkpointer.last_save or {}
        return {"snapshot": snap, "mid_steps": int(steps),
                "seconds": time.perf_counter() - t0,
                "bytes": int(last.get("bytes", 0)),
                "stream_wait_s": wait}

    def _midpass_save(self, ws: PassWorkingSet, pass_step: int) -> None:
        """Commit a mid-pass snapshot from inside the step loop (JAX
        trainer.py:2193). The feed manager's in-pass guard is lifted only
        around the save: at this instruction no step is queued past the
        stream wait, so the rows read D2H are this step's."""
        ckpt, _every, box, metrics = self._midpass
        self.feed_mgr.pass_closed()
        try:
            info = self._snapshot_open_pass(ckpt, box, metrics, ws,
                                            pass_step)
        finally:
            self.feed_mgr.pass_opened()
        self.midpass_saves.append(info)
        faultpoint.hit("trainer.midpass.post_save")

    def drain_and_snapshot(self, checkpointer, box, metrics=None
                           ) -> str | None:
        """After a pass raised inside its step loop, commit a mid-pass
        snapshot at the step it reached (JAX trainer.py:2233), so the
        restart keeps the steps already trained. The pass's ``finally``
        closed the pack pipeline and left its crumbs
        (``last_pass_steps``, the aborted mark). Returns the snapshot
        directory, or None when there is nothing to snapshot (no open
        BoxPS pass, a pass that did not raise, no step taken, or a kstep
        pass stopped between sync boundaries: the uninterrupted run's
        cadence cannot be reproduced from there, so the election falls
        back to the newest committed snapshot, and a
        ``drain_snapshot_skipped`` event says so). Close the pass with
        ``box.abort_pass`` afterwards."""
        if box is None or not box.in_pass or not self._pass_aborted:
            return None
        steps = int(self.last_pass_steps)
        ws = self.last_ws
        if steps <= 0 or ws is None:
            return None
        if (self.cfg.dense_sync_mode == "kstep"
                and steps % self.cfg.param_sync_step):
            monitor.event("drain_snapshot_skipped",
                          reason="kstep_off_sync_boundary", steps=steps)
            return None
        info = self._snapshot_open_pass(checkpointer, box, metrics, ws,
                                        steps)
        self.midpass_saves.append(info)
        monitor.counter_add("resilience.drain_snapshots")
        monitor.event("drain_snapshot", type="lifecycle",
                      snapshot=info["snapshot"], mid_steps=steps)
        return info["snapshot"]

    def recover_world(self, world, failure, checkpointer, box,
                      metrics=None):
        """The elastic catch arm (JAX trainer.py:2284): a
        ``PeerFailureError`` escaped the pass loop — drain-snapshot,
        re-form the world without the dead ranks, rerun the coordinated
        resume election over the survivors, and return ``(new_world,
        cursor)`` for the training loop to continue from (``cursor``
        None: the survivors hold no common snapshot, a whole-world fresh
        start).

        A further failure inside re-formation or the election escalates
        the generation and retries, up to ``flags.elastic_max_reforms``
        times with a doubling backoff; exhaustion re-raises the failure
        (fail-stop). Survivors below ``flags.elastic_min_world`` return
        ``(None, None)`` after the drain snapshot, for a clean exit. A
        ``WorldFencedError`` propagates: this rank's timeline was
        abandoned.

        The world is the host control plane: an elastic rank trains on
        its own card without a ``mesh``. A trainer's ``torch.distributed``
        group is not re-formed here, as the JAX package re-forms no
        device mesh."""
        from paddlebox_tpu_torch.distributed import resilience
        self.drain_and_snapshot(checkpointer, box, metrics=metrics)
        if box is not None and box.in_pass:
            box.abort_pass(reason=repr(failure))
        dead = sorted(set(int(r) for r in failure.ranks))
        backoff = float(flags.elastic_reform_backoff_s)
        for attempt in range(max(1, int(flags.elastic_max_reforms))):
            if attempt:
                time.sleep(backoff)
                backoff *= 2.0
            try:
                new_world = world.reform(dead)
            except resilience.WorldTooSmallError as e:
                monitor.event("elastic_min_world_exit", type="lifecycle",
                              survivors=e.survivors, floor=e.floor)
                return None, None
            self.peer_check = new_world.check
            own = self.feed_mgr.ownership
            if own is not None:
                # the re-formed world re-deals the store shards: the next
                # begin_pass builds exactly this rank's new shards
                self.feed_mgr.set_ownership(
                    own.with_world(new_world.world, new_world.rank))
            if box is not None:
                box.attach_collectives(new_world.collectives,
                                       heartbeat=new_world.heartbeat)
            try:
                cursor = resilience.coordinated_resume(
                    checkpointer, self, new_world.collectives, box=box,
                    metrics=(metrics if metrics is not None
                             else (box.metrics if box is not None
                                   else None)))
                monitor.counter_add("resilience.elastic_recoveries")
                return new_world, cursor
            except resilience.PeerFailureError as e:
                # another rank died inside the election or restore (the
                # restore is idempotent): escalate without it
                world = new_world
                dead = sorted(set(int(r) for r in e.ranks))
                failure = e
        raise failure
