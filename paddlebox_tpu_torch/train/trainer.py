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

Precision: the reference computes in f32, so TF32 is turned off for
matmuls and convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) when a Trainer is built.

Not ported yet (ROADMAP): multi-shard routing, kstep/async dense sync,
supersteps, deferred push, dump streams, mid-pass resume, telemetry,
tiering, eval_pass.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import PackedBatch, SparseLayout
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding import sharded
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.working_set import PassWorkingSet
from paddlebox_tpu_torch.metrics.auc import AucAccumulator
from paddlebox_tpu_torch.native.key_index import dedup_plan
from paddlebox_tpu_torch.ops import kernels
from paddlebox_tpu_torch.ops.seqpool_cvm import PooledSlots
from paddlebox_tpu_torch.train import optimizers


@dataclasses.dataclass
class TrainerConfig:
    dense_lr: float = 1e-3
    dense_optimizer: str = "adam"          # adam | sgd
    global_batch_size: int = 256
    auc_buckets: int = 1 << 16
    label_slot: str = "label"


class _PackError:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Trainer:
    """Pass-oriented trainer on one device (the card unless
    ``device="cpu"``)."""

    def __init__(self, model, store: HostEmbeddingStore,
                 schema: DataFeedSchema, config: TrainerConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
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
        self.dense_opt = optimizers.make(self.cfg.dense_optimizer,
                                         self.cfg.dense_lr, self.params)
        self.pull_engine = self._select_pull_engine()
        # the host dedup plan: always on the card (the fused push engine
        # consumes premerged lanes), and wherever the fused engine is
        # forced (the CPU-parity knob, as in the JAX package)
        fused_forced = kernels.push_engine_flag() == "scatter_accumulate"
        self._use_plan = self.device.type == "cuda" or fused_forced
        self._seg = torch.as_tensor(self.layout.segment_ids,
                                    dtype=torch.int64, device=self.device)
        self.global_step = 0
        self.last_ws: PassWorkingSet | None = None

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
        (flags.push_dedup_premerge). "auto" premerges every batch that
        gets a plan — on the card, and wherever the fused engine is
        forced. (On the card this is an interim choice until the binned
        engine is measured there: ROADMAP slice 2.)"""
        dd = flags.push_dedup_premerge
        if dd not in ("auto", "on", "off"):
            raise ValueError(f"push_dedup_premerge={dd!r}")
        return dd != "off"

    def push_premerged(self) -> bool:
        return self._use_plan and self._dedup_premerge()

    def resolved_push_engine(self, ws: PassWorkingSet) -> str:
        """The push engine the steps run for this working set."""
        return kernels.resolve_push_engine(
            self.store.cfg, ws.padded_rows, premerged=self.push_premerged(),
            device_type=self.device.type, table_width=ws.table.shape[1])

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

    def pack_arrays(self, ws: PassWorkingSet, idx: np.ndarray,
                    mask: np.ndarray, dense: np.ndarray,
                    labels: np.ndarray) -> tuple:
        """Host tensors for one step: (idx, mask, dense, labels, plan);
        plan is the dedup plan (order, uniq, segend) or None. Pinned when
        the step runs on the card, so the copy can overlap compute."""
        plan = None
        if self.push_premerged():
            o, u, s, _, _ = dedup_plan(idx.reshape(-1), ws.padded_rows,
                                       ws.padded_rows, 1)
            plan = (o, u, s)
        arrays = (np.ascontiguousarray(idx, np.int32),
                  np.ascontiguousarray(mask, bool),
                  np.ascontiguousarray(dense, np.float32),
                  np.ascontiguousarray(labels, np.float32))
        host = [torch.from_numpy(a) for a in arrays]
        plan_t = (None if plan is None
                  else tuple(torch.from_numpy(a) for a in plan))
        if self.device.type == "cuda":
            host = [t.pin_memory() for t in host]
            if plan_t is not None:
                plan_t = tuple(t.pin_memory() for t in plan_t)
        return (*host, plan_t)

    def _pack_host(self, ws: PassWorkingSet, pb: PackedBatch) -> tuple:
        idx = ws.translate(pb.ids, pb.mask)
        labels, dense = self.split_floats(pb.floats)
        return self.pack_arrays(ws, idx, pb.mask, dense, labels)

    def stage(self, host: tuple) -> tuple:
        """Host tensors from pack_arrays → the step's device tensors."""
        dev = self.device

        def put(t):
            return t.to(dev, non_blocking=True)

        *arrays, plan = host
        staged = [put(t) for t in arrays]
        staged.append(None if plan is None else tuple(put(t) for t in plan))
        return tuple(staged)

    def _pack_iter(self, dataset, ws: PassWorkingSet, batch_size: int):
        """Yield each batch's staged tensors, with the pack (translate +
        plan + pin) running on a host thread ``flags.prefetch_batches``
        batches ahead of the step."""
        def source():
            for pb in dataset.batches(batch_size, drop_last=True):
                yield self._pack_host(ws, pb)

        depth = flags.prefetch_batches
        if depth <= 0:
            for host in source():
                yield self.stage(host)
            return
        q: Any = queue.Queue(maxsize=depth)
        done = object()
        cancel = threading.Event()

        def producer():
            try:
                for item in source():
                    if cancel.is_set():
                        return
                    q.put(item)
                q.put(done)
            except BaseException as e:  # re-raised on the consumer side
                q.put(_PackError(e))

        t = threading.Thread(target=producer, name="pbt-pack", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, _PackError):
                    raise item.exc
                yield self.stage(item)
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
    def train_step(self, table: torch.Tensor, idx: torch.Tensor,
                   mask: torch.Tensor, dense: torch.Tensor,
                   labels: torch.Tensor, plan=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """One training step on device tensors. Updates ``table`` and the
        dense params in place; returns (loss, preds) without a host
        sync."""
        lay = self.layout
        S, T = lay.num_slots, lay.total_len
        ecfg = self.store.cfg
        B = idx.shape[0]
        fused = self.pull_engine == "fused_gather_pool"
        if fused:
            pulled = sharded.fused_pull_pool(table, idx, ecfg, S, T // S)
            pulled.requires_grad_()
            model_in = PooledSlots(pulled)
        else:
            pulled = sharded.lookup(table, idx, ecfg).requires_grad_()
            model_in = pulled
        logits = self.model(model_in, mask, dense, lay.segment_ids, S)
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        *gp, gpulled = torch.autograd.grad(loss, [*self.params, pulled])
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

    # ------------------------------------------------------------------
    # the pass
    # ------------------------------------------------------------------
    def train_pass(self, dataset) -> dict[str, float]:
        """One pass over the dataset: build the working set from the
        dataset's keys, train every full batch, write the touched rows
        back to the store. Returns AUC stats plus loss_first/last/mean,
        steps, step_seconds (the step loop's wall time, device work
        included) and seconds (the whole pass)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        ws = PassWorkingSet.begin_pass(self.store, dataset.unique_keys(),
                                       device=self.device)
        auc = AucAccumulator(cfg.auc_buckets, device=self.device)
        losses: list[torch.Tensor] = []
        t_loop = time.perf_counter()
        for staged in self._pack_iter(dataset, ws, cfg.global_batch_size):
            loss, preds = self.train_step(ws.table, *staged)
            auc.update(preds, staged[3])
            losses.append(loss)
            self.global_step += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        step_seconds = time.perf_counter() - t_loop
        self.last_ws = ws
        ws.end_pass(self.store)
        lv = (torch.stack(losses).cpu().numpy().astype(np.float64)
              if losses else np.zeros(0))
        out = auc.compute()
        out["loss_first"] = float(lv[0]) if len(lv) else float("nan")
        out["loss_last"] = float(lv[-1]) if len(lv) else float("nan")
        out["loss_mean"] = float(np.mean(lv)) if len(lv) else float("nan")
        out["steps"] = len(lv)
        out["step_seconds"] = step_seconds
        out["seconds"] = time.perf_counter() - t0
        return out
