"""Heterogeneous trainer — the port of ``train/heter.py``: the table stays
in the host store, the dense stage runs on the card.

The reference's heterogeneous mode (HeterXpuTrainer) splits the graph:
the CPU side owns the sparse tables, the accelerator runs the dense
stage. It trains tables far larger than device memory. Here, per batch:

    host pull    : rows for the batch's keys straight from the
                   HostEmbeddingStore (no pass working set, no device
                   table), numpy only, on a prefetch thread
    device step  : the pulled block to the card, the model's forward and
                   backward, the dense optimizer (optax's formulas,
                   ``train/optimizers.py``); the sparse grads of the pull
                   columns 2: come back to the host
    host push    : per-key grads merged (numpy) and the in-table
                   optimizer applied on the CPU (``embedding/optim.py``),
                   rows written back

The copies and launches stay on the main thread. ``prefetch_depth``
bounds the pulls in flight: the pull of batch k + d waits until batch
k's push has landed, so a pull reads rows at most ``d - 1`` batches
stale and ``prefetch_depth=1`` is fully serial (deterministic, what the
parity checks use). (The JAX package bounds its queue instead, so its
depth-1 pull of batch k + 1 may race batch k's push.)

The store must not be held by a ``FeedPassManager`` (a ``Trainer``'s
``feed_mgr``): the manager keeps rows resident on the card and writes
them back lazily, while this trainer reads and writes the store
directly, so each would act on rows the other has changed. A store with
a manager attached is refused; ``trainer.feed_mgr.close()`` flushes the
resident rows and detaches the manager first.

Use ``Trainer`` when the pass's working set fits on the card; this
trainer trades a per-batch H2D/D2H copy for an unbounded table and
takes streamed data (``QueueDataset``).
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

from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import PackedBatch, SparseLayout
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding import gating
from paddlebox_tpu_torch.embedding.optim import apply_updates
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.metrics.auc import AucAccumulator
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.train import optimizers


@dataclasses.dataclass
class HeterConfig:
    dense_lr: float = 1e-3
    dense_optimizer: str = "adam"
    global_batch_size: int = 256
    auc_buckets: int = 1 << 16
    label_slot: str = "label"
    prefetch_depth: int = 2          # host pulls in flight


class HeterTrainer:
    """Host-table, card-dense split trainer (HeterXpuTrainer's
    counterpart) on one device (the card unless ``device="cpu"``)."""

    def __init__(self, model: Any, store: HostEmbeddingStore,
                 schema: DataFeedSchema, config: HeterConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.store = store
        self._check_store()
        self.schema = schema
        self.cfg = config or HeterConfig()
        self.layout = SparseLayout.from_schema(schema)
        lc, _, _ = schema.float_split_cols(self.cfg.label_slot)
        if lc < 0:
            raise ValueError(f"label slot {self.cfg.label_slot!r} not found")
        model.init(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.dense_opt = optimizers.make(self.cfg.dense_optimizer,
                                         self.cfg.dense_lr, self.params)
        self.global_step = 0

    def _check_store(self) -> None:
        if self.store.has_flush_hooks():
            raise RuntimeError(
                "HeterTrainer: a FeedPassManager (a Trainer's feed_mgr) "
                "holds this store and writes its rows back lazily; call "
                "its close() to flush and detach it before streaming")

    # ------------------------------------------------------------------
    def _host_pull(self, pb: PackedBatch) -> tuple:
        """Host stage 1 (numpy only): the batch's rows from the store."""
        ids = pb.ids.reshape(-1).astype(np.uint64)
        mask = pb.mask.reshape(-1)
        # one store round-trip for the batch's masked tokens
        uniq, inverse = np.unique(ids[mask], return_inverse=True)
        rows = self.store.lookup_or_init(uniq)
        P = self.store.cfg.pull_width
        B, T = pb.mask.shape
        pulled = np.zeros((B * T, P), np.float32)
        pulled[mask] = rows[inverse, :P]
        labels, dense = _split(pb, self.cfg.label_slot)
        return (uniq, inverse, pulled.reshape(B, T, P), pb.mask, dense,
                labels)

    def _device_step(self, pulled: np.ndarray, mask: np.ndarray,
                     dense: np.ndarray, labels: np.ndarray) -> tuple:
        """The device stage: copies in, forward and backward, the dense
        optimizer; returns (loss, preds, labels) on the device and the
        sparse grads (B, T, grad_width) as numpy."""
        dev = self.device
        lay = self.layout
        with torch.no_grad():
            # create-threshold gating, as the trainer's pull applies it
            pulled_t = gating.gate_pull(torch.from_numpy(pulled).to(dev),
                                        self.store.cfg)
        pulled_t.requires_grad_()
        mask_t = torch.from_numpy(np.ascontiguousarray(mask)).to(dev)
        dense_t = torch.from_numpy(np.ascontiguousarray(dense)).to(dev)
        labels_t = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
        logits = self.model(pulled_t, mask_t, dense_t, lay.segment_ids,
                            lay.num_slots)
        loss = F.binary_cross_entropy_with_logits(logits, labels_t)
        *gp, gpull = torch.autograd.grad(loss, [*self.params, pulled_t])
        self.dense_opt.step(gp)
        # only (w, embedx) train; show/clk are counters
        sgrad = gpull[..., 2:].cpu().numpy()
        return (loss.detach(), torch.sigmoid(logits.detach()), labels_t,
                sgrad)

    def _host_push(self, uniq: np.ndarray, inverse: np.ndarray,
                   mask: np.ndarray, labels: np.ndarray,
                   sgrad: np.ndarray) -> None:
        """Host stage 3: merge per-key grads, run the in-table optimizer
        on the CPU, write the rows back."""
        cfg = self.store.cfg
        gw = cfg.grad_width
        sg = sgrad.reshape(-1, gw)[mask.reshape(-1)]
        merged = np.zeros((len(uniq), gw), np.float32)
        np.add.at(merged, inverse, sg)
        shows = np.bincount(inverse, minlength=len(uniq)).astype(np.float32)
        clk_tok = np.repeat(labels, mask.shape[1])[mask.reshape(-1)]
        clks = np.bincount(inverse, weights=clk_tok,
                           minlength=len(uniq)).astype(np.float32)
        rows = self.store.get_rows(uniq)
        new_rows = apply_updates(torch.from_numpy(rows),
                                 torch.from_numpy(merged),
                                 torch.from_numpy(shows),
                                 torch.from_numpy(clks), cfg)
        self.store.write_back(uniq, new_rows.numpy())

    # ------------------------------------------------------------------
    def train_pass(self, dataset) -> dict[str, float]:
        """One pass over ``dataset.batches`` (a QueueDataset streams;
        a SlotDataset works too). Returns the AUC stats plus loss_first /
        loss_last / loss_mean, steps, step_seconds (the step loop, device
        work included), seconds, and ``split``: seconds of host pull (on
        the prefetch thread, overlapped), device stage and host push."""
        self._check_store()
        cfg = self.cfg
        t0 = time.perf_counter()
        auc = AucAccumulator(cfg.auc_buckets, device=self.device)
        losses: list[torch.Tensor] = []
        split = {"pull": 0.0, "device": 0.0, "push": 0.0}
        q: queue.Queue = queue.Queue()      # bounded by `slots`
        slots = threading.Semaphore(max(1, cfg.prefetch_depth))
        stop = object()
        cancel = threading.Event()
        producer_errors: list[BaseException] = []

        def producer():
            batches = None
            try:
                # inside the try: SlotDataset.batches raises at once when
                # nothing is loaded, and the sentinel must still land
                batches = dataset.batches(cfg.global_batch_size,
                                          drop_last=True)
                for pb in batches:
                    while not slots.acquire(timeout=0.1):
                        if cancel.is_set():
                            return
                    if cancel.is_set():
                        return
                    t = time.perf_counter()
                    item = self._host_pull(pb)
                    split["pull"] += time.perf_counter() - t
                    q.put(item)
            except BaseException as e:
                # raised after the loop: a pass must not quietly complete
                # on truncated data
                producer_errors.append(e)
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()          # a streaming dataset reaps its readers
                q.put(stop)

        t = mon_ctx.spawn(producer, name="pbt-heter-pull")
        t.start()
        t_loop = time.perf_counter()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                uniq, inverse, pulled, mask, dense, labels = item
                t1 = time.perf_counter()
                loss, preds, labels_t, sgrad = self._device_step(
                    pulled, mask, dense, labels)
                t2 = time.perf_counter()
                self._host_push(uniq, inverse, mask, labels, sgrad)
                split["device"] += t2 - t1
                split["push"] += time.perf_counter() - t2
                slots.release()
                auc.update(preds, labels_t)
                losses.append(loss)
                self.global_step += 1
            step_seconds = time.perf_counter() - t_loop
        finally:
            # a consumer error must not strand the producer: it sees the
            # cancel at its next slot wait
            cancel.set()
            t.join()
        if producer_errors:
            raise producer_errors[0]
        lv = (torch.stack(losses).cpu().numpy().astype(np.float64)
              if losses else np.zeros(0))
        out = auc.compute()
        out["loss_first"] = float(lv[0]) if len(lv) else float("nan")
        out["loss_last"] = float(lv[-1]) if len(lv) else float("nan")
        out["loss_mean"] = float(np.mean(lv)) if len(lv) else float("nan")
        out["steps"] = len(lv)
        out["step_seconds"] = step_seconds
        out["seconds"] = time.perf_counter() - t0
        out["split"] = split
        return out


def _split(pb: PackedBatch, label_slot: str) -> tuple[np.ndarray, np.ndarray]:
    lc, lw, _ = pb.schema.float_split_cols(label_slot)
    labels = pb.floats[:, lc:lc + lw].reshape(-1)
    dense = np.concatenate([pb.floats[:, :lc], pb.floats[:, lc + lw:]],
                           axis=1)
    return labels, dense
