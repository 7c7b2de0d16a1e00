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
stage split of ``self.timers`` (read, translate, train, auc, drain), the
steps, examples and seconds, and the boundary account to the pass's
flight record (``hub.record_train``). Each step emits the
``pack_batch``, ``h2d_stage``, ``train_step`` and ``auc_update`` spans;
the pack thread, spawned through ``monitor.context``, counts
``trainer.tokens`` / ``pull_bytes`` / ``push_bytes`` (and the dedup
plan's ``trainer.plan_tokens`` / ``plan_unique_tokens``) from the host
arrays it already holds. No counter, span or timer reads a CUDA tensor:
with the hub on, a step still makes no host sync.

Mid-pass snapshots (``enable_midpass_snapshots``): every
``every_steps`` trained steps of a pass the loop commits a
``pass-PPPPP.midSSSSS`` snapshot — after waiting for the steps' kernels
on the stream that launched them (``midpass_saves`` records that wait
with each save's seconds and bytes) — so a crash resumes through
``train_pass(skip_steps=mid_steps)`` instead of replaying the pass.
``drain_and_snapshot`` commits the same kind of snapshot after a pass
raised. The dense optimizer updates the model in place, so the live
dense state at any step is ``dense_state()``.

Precision: the reference computes in f32, so TF32 is turned off for
matmuls and convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) when a Trainer is built.

Not ported yet (ROADMAP queue 1): multi-shard routing, shard ownership,
kstep/async dense sync and coordinated multi-host resume (item 6);
deferred push (push overlap, item 4: ``flush_push`` is a no-op hook);
supersteps.
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
from paddlebox_tpu_torch.embedding import quant, sharded, tiering
from paddlebox_tpu_torch.embedding.feed_pass import FeedPassManager
from paddlebox_tpu_torch.embedding.replica_cache import TrainerReplicaCache
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.working_set import PassWorkingSet
from paddlebox_tpu_torch.metrics.auc import AucAccumulator
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor.timers import StageTimers
from paddlebox_tpu_torch.native.key_index import block_plan, dedup_plan
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots
from paddlebox_tpu_torch.train import optimizers
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.checkpoint import flatten_tree
from paddlebox_tpu_torch.utils.profiler import (DumpStream, dump_tree,
                                                find_nonfinite)


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


class _PackError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Trainer:
    """Pass-oriented trainer on one device (the card unless
    ``device="cpu"``)."""

    def __init__(self, model, store: HostEmbeddingStore,
                 schema: DataFeedSchema, config: TrainerConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 feed_mgr: FeedPassManager | None = None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.store = store
        self.schema = schema
        self.cfg = config or TrainerConfig()
        self.layout = SparseLayout.from_schema(schema)
        model_dim = getattr(model, "emb_dim", None)
        if model_dim is not None and model_dim != store.cfg.total_dim:
            raise ValueError(
                f"model emb_dim={model_dim} must equal the table's trained "
                f"vector width total_dim={store.cfg.total_dim}")
        model.init(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.dense_opt = optimizers.make(
            self.cfg.dense_optimizer, self.cfg.dense_lr, self.params,
            **self.cfg.dense_optimizer_kwargs)
        # the model-extras protocol: a host-side pack stage whose arrays
        # the step passes to the model after the standard arguments
        self._extras_fn = getattr(model, "batch_extras", None)
        self.pull_engine = self._select_pull_engine()
        # host push plans (block or dedup plan, built on the pack thread):
        # on the card while the binned engine is enabled, and wherever a
        # plan-consuming engine is forced (the CPU-parity knob), as in the
        # JAX package with the card in place of the TPU
        forced = kernels.push_engine_flag()
        self._use_plan = ((self.device.type == "cuda" and flags.binned_push)
                          or forced in ("scatter_accumulate",
                                        "binned_kernel"))
        self._seg = torch.as_tensor(self.layout.segment_ids,
                                    dtype=torch.int64, device=self.device)
        self.global_step = 0
        self.last_ws: PassWorkingSet | None = None
        # "train"/"auc" scopes are covered by the train_step/auc_update
        # spans: only the stages without one emit hub events themselves
        self.timers = StageTimers(["read", "translate", "train", "auc",
                                   "drain"],
                                  emit_stages={"read", "translate",
                                               "drain"})
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
        # the incremental, overlapped pass boundary: resident rows reused
        # across passes, write-back lazy. Pass a shared manager when
        # several trainers drive one table.
        self.feed_mgr = feed_mgr or FeedPassManager(store, self.device)
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
        compatible = (uniform
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
        return self._use_plan and self._dedup_premerge()

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

    def pack_arrays(self, ws: PassWorkingSet, idx: np.ndarray,
                    mask: np.ndarray, dense: np.ndarray,
                    labels: np.ndarray, with_plan: bool = True,
                    extras: tuple = ()) -> tuple:
        """Host tensors for one step: (idx, mask, dense, labels, plan,
        extras); plan is host_plan's (None without ``with_plan``: eval
        never pushes), extras the model's batch_extras arrays (a tuple,
        empty for most models). Pinned when the step runs on the card,
        so the copy can overlap compute."""
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
            host = [t.pin_memory() for t in host]
            ext = [t.pin_memory() for t in ext]
            plan = sharded.map_plan(plan, torch.Tensor.pin_memory)
        return (*host, plan, tuple(ext))

    def _pack_host(self, ws: PassWorkingSet, pb: PackedBatch,
                   with_plan: bool = True) -> tuple:
        with self.timers("translate"):
            idx = ws.translate(pb.ids, pb.mask)
            labels, dense = self.split_floats(pb.floats)
            extras = (self._extras_fn(pb, 1) if self._extras_fn is not None
                      else ())
            out = self.pack_arrays(ws, idx, pb.mask, dense, labels,
                                   with_plan, extras)
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
        """Host tensors from pack_arrays → the step's device tensors."""
        dev = self.device

        def put(t):
            return t.to(dev, non_blocking=True)

        with monitor.span("h2d_stage"):
            *arrays, plan, extras = host
            return (*(put(t) for t in arrays), sharded.map_plan(plan, put),
                    tuple(put(t) for t in extras))

    def _pack_iter(self, dataset, ws: PassWorkingSet, batch_size: int,
                   test_mode: bool = False):
        """Yield (packed batch, its staged tensors), with the pack
        (translate + plan + pin) running on a host thread
        ``flags.prefetch_batches`` batches ahead of the step; the step
        thread's wait on it is the "read" stage (starvation = a
        host-bound pass). ``test_mode`` (eval) packs no push plan and
        pads the tail batch instead of dropping it (``pb.num`` keeps the
        valid count)."""
        def source():
            for pb in dataset.batches(batch_size, drop_last=not test_mode):
                if len(pb.floats) < batch_size:
                    pb = pb.pad_to(batch_size)
                yield pb, self._pack_host(ws, pb, with_plan=not test_mode)

        depth = flags.prefetch_batches
        if depth <= 0:
            for pb, host in source():
                yield pb, self.stage(host)
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
                yield item[0], self.stage(item[1])
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
              requires_grad: bool = False):
        """One batch's pull and the model input it makes: for the fused
        engine the gather_pool kernel's (B, S, P) sums (PooledSlots), else
        the gathered (B, T, P) rows."""
        lay = self.layout
        S = lay.num_slots
        ecfg = self.store.cfg
        fused = self.pull_engine == "fused_gather_pool"
        if fused:
            pulled = sharded.fused_pull_pool(table, idx, ecfg, S,
                                             lay.total_len // S)
        else:
            pulled = sharded.lookup(table, idx, ecfg)
        if requires_grad:
            pulled.requires_grad_()
        return pulled, (PooledSlots(pulled) if fused else pulled)

    def train_step(self, table: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor, dense: torch.Tensor,
                   labels: torch.Tensor, plan=None, extras: tuple = ()
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """One training step on device tensors. Updates ``table`` and the
        dense params in place; returns (loss, preds) without a host
        sync."""
        lay = self.layout
        S, T = lay.num_slots, lay.total_len
        ecfg = self.store.cfg
        B = idx.shape[0]
        fused = self.pull_engine == "fused_gather_pool"
        pulled, model_in = self._pull(table, idx, requires_grad=True)
        logits = self.model(model_in, mask, dense, lay.segment_ids, S,
                            *extras)
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        # a parameter the loss does not reach (MMoE's other task heads)
        # gets a zero gradient, as jax.grad gives it
        *gp, gpulled = torch.autograd.grad(loss, [*self.params, pulled],
                                           allow_unused=True)
        gp = [torch.zeros_like(p) if g is None else g
              for p, g in zip(self.params, gp)]
        # only the (w, embedx) columns train; show/clk are counters
        if fused:
            sgrad = sharded.pooled_grad_tokens(gpulled, mask, self._seg, S)
        else:
            sgrad = gpulled[..., 2:].reshape(B * T, ecfg.grad_width)
        maskf = mask.to(torch.float32)
        show_inc = maskf.reshape(-1)
        clk_inc = (maskf * labels[:, None]).reshape(-1)
        sharded.push(table, idx.reshape(-1), sgrad, show_inc, clk_inc, ecfg,
                     plan=plan)
        self.dense_opt.step(gp)
        return loss.detach(), torch.sigmoid(logits.detach())

    @torch.no_grad()
    def eval_step(self, table: torch.Tensor, idx: torch.Tensor,
                  mask: torch.Tensor, dense: torch.Tensor,
                  extras: tuple = ()) -> torch.Tensor:
        """Predictions of one batch (the JAX eval step, trainer.py:894):
        the training step's pull and the model's forward; nothing is
        pushed or updated."""
        lay = self.layout
        _, model_in = self._pull(table, idx)
        logits = self.model(model_in, mask, dense, lay.segment_ids,
                            lay.num_slots, *extras)
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
        try:
            out = self._train_pass_impl(dataset, metrics, preload_keys,
                                        skip_steps)
        except BaseException as e:
            if owned_pass:
                hub.abort_pass(reason=repr(e))
            raise
        fm = self.feed_mgr
        hub.record_train(
            stage_seconds={k: self.timers.total.get(k, 0.0)
                           - stage0.get(k, 0.0) for k in self.timers.total},
            steps=out["steps"],
            examples=out["steps"] * self.cfg.global_batch_size,
            seconds=time.perf_counter() - pass_t0,
            loss_mean=out.get("loss_mean"), auc=out.get("auc"),
            pull_engine=self.pull_engine,
            push_engine=(self.resolved_push_engine(self.last_ws)
                         if self.last_ws is not None else None),
            boundary_seconds=round(fm.last_boundary_seconds, 6),
            boundary_split={k: round(v, 6) for k, v
                            in fm.last_boundary_split.items()},
            table_tiering=self.table_tiering)
        if owned_pass:
            hub.end_pass(metrics=metrics)
        return out

    def _train_pass_impl(self, dataset, metrics,
                         preload_keys: np.ndarray | None,
                         skip_steps: int) -> dict[str, float]:
        cfg = self.cfg
        t0 = time.perf_counter()
        fm = self.feed_mgr
        ws = fm.begin_pass(dataset.unique_keys())
        self.last_ws = ws
        self.midpass_saves = []
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
            pack_it = self._pack_iter(dataset, ws, cfg.global_batch_size)
            for pb, staged in pack_it:
                if skip > 0:
                    skip -= 1
                    pass_step += 1
                    continue
                mon_ctx.set_step(self.global_step)
                with monitor.span("pack_batch"):
                    idx, mask, dense, labels, plan, extras = staged
                with self.timers("train"), monitor.span("train_step"):
                    loss, preds = self.train_step(ws.table, idx, mask,
                                                  dense, labels, plan,
                                                  extras)
                    pass_step += 1
                with self.timers("auc"), monitor.span("auc_update"):
                    auc.update(preds, labels)
                    if metrics is not None:
                        metrics.add_batch(preds, labels, cmatch=pb.cmatch,
                                          rank=pb.rank)
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
            if pack_it is not None:
                # close the pack generator now, so its producer stops
                # before anything reads or persists the table (the
                # exception's traceback would keep it alive otherwise)
                pack_it.close()
            fm.pass_closed()
            if dump_stream is not None:
                # flush the tail batch even when the pass raised (a nan
                # trip must keep its debug stream); a dump failure is
                # reported but never masks the training exception
                try:
                    if dump_pending is not None:
                        dump_stream.write_fields(*dump_pending)
                    if cfg.dump_param:
                        self._dump_params(dump_stream)
                    dump_stream.close()
                except Exception as e:
                    warnings.warn(f"dump stream failed: {e}")
        fm.end_pass(ws, ws.table)
        with self.timers("drain"):
            lv = (torch.stack(losses).cpu().numpy().astype(np.float64)
                  if losses else np.zeros(0))
        out = auc.compute()
        out["loss_first"] = float(lv[0]) if len(lv) else float("nan")
        out["loss_last"] = float(lv[-1]) if len(lv) else float("nan")
        out["loss_mean"] = float(np.mean(lv)) if len(lv) else float("nan")
        out["steps"] = len(lv)
        out["step_seconds"] = step_seconds
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
        examples, step_seconds (the batch loop, device work included)
        and seconds (the whole pass)."""
        cfg = self.cfg
        bs = cfg.global_batch_size
        t0 = time.perf_counter()
        ws = self.feed_mgr.begin_pass(dataset.unique_keys(), test_mode=True)
        auc = AucAccumulator(cfg.auc_buckets, device=self.device)
        rows = torch.arange(bs, device=self.device)
        steps = examples = 0
        t_loop = time.perf_counter()
        for pb, staged in self._pack_iter(dataset, ws, bs, test_mode=True):
            idx, mask, dense, labels, _, extras = staged
            preds = self.eval_step(ws.table, idx, mask, dense, extras)
            auc.update(preds, labels, mask=rows < pb.num)
            steps += 1
            examples += pb.num
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_seconds = time.perf_counter() - t_loop
        out = auc.compute()
        out["steps"] = steps
        out["examples"] = examples
        out["step_seconds"] = step_seconds
        out["seconds"] = time.perf_counter() - t0
        # one card routes nothing, so nothing is ever dropped
        monitor.event("eval_pass", auc=float(out.get("auc", float("nan"))),
                      routed_dropped=0)
        return out

    # ------------------------------------------------------------------
    # dense state and snapshots
    # ------------------------------------------------------------------
    def flush_push(self) -> int:
        """Apply a pending deferred sparse push (JAX trainer.py:2054),
        registered as the feed manager's pre-flush hook. The port pushes
        inline (push overlap is not ported, ROADMAP queue 1 item 4), so
        nothing is ever pending: returns 0."""
        return 0

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
        a pass snapshot's dense.npz holds."""
        return weights.dense_state(self.model, self.dense_opt)

    def restore_dense(self, params, opt_state=None) -> None:
        """Load dense params and, when given, the optimizer state (JAX
        trainer.py:2088, allreduce mode — the only mode ported) onto the
        trainer's device."""
        weights.load_dense_state(self.model, self.dense_opt, params,
                                 opt_state)

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
        full."""
        if collectives is not None:
            raise NotImplementedError(
                "coordinated multi-host resume (collectives=...) is not "
                "ported yet (ROADMAP, queue 1 item 6: multi-GPU)")
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
        ``train_pass(skip_steps=mid_steps)``. One card, allreduce: any
        cadence (the kstep, async and superstep boundary rules of the
        reference have no mode to bind here)."""
        if every_steps is None:
            every_steps = int(flags.ckpt_midpass_every_steps)
        if every_steps <= 0:
            self._midpass = None
            return
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
        wait = self._quiesce_steps()
        self.flush_push()
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
        BoxPS pass, a pass that did not raise, or no step taken). Close
        the pass with ``box.abort_pass`` afterwards."""
        if box is None or not box.in_pass or not self._pass_aborted:
            return None
        steps = int(self.last_pass_steps)
        ws = self.last_ws
        if steps <= 0 or ws is None:
            return None
        info = self._snapshot_open_pass(checkpointer, box, metrics, ws,
                                        steps)
        self.midpass_saves.append(info)
        monitor.counter_add("resilience.drain_snapshots")
        monitor.event("drain_snapshot", type="lifecycle",
                      snapshot=info["snapshot"], mid_steps=steps)
        return info["snapshot"]
