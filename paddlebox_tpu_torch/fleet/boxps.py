"""Pass/day lifecycle façade — the port of ``fleet/boxps.py`` (JAX
``boxps.py:32-242``).

The user-facing lifecycle is

    box.set_date(d)
    box.init_metric("auc")
    box.begin_pass()
    trainer.train_pass(dataset, metrics=box.metrics)
    box.end_pass(checkpointer=ckpt, trainer=trainer, dataset=dataset)

``Trainer.train_pass`` builds the pass's device working set through its
``FeedPassManager``, which writes rows back lazily; the store's saves
and ``shrink_table`` flush the card's rows first through the store's
flush hooks. So begin/end here is pass bookkeeping plus the persistence
policy: ``end_pass`` commits a PassCheckpointer snapshot (with the
dataset's shuffle cursor) and/or a delta save. BoxPS owns the store, the
metric registry and the join/update phase bit.

Not ported yet (ROADMAP): publishing to the serving plane (``publisher``
raises), multi-host pass barriers and heartbeats
(``attach_collectives``), and the telemetry pass scope; the spill-tier,
replica-cache, exchange-wire and self-healing boundary hooks serve
subsystems the port does not have yet.
"""

from __future__ import annotations

import time
from typing import Any

from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.metrics.metric import MetricRegistry

JOIN_PHASE = 1
UPDATE_PHASE = 0


class BoxPS:
    """Owns the sparse store, the metrics and the pass/phase state for one
    job."""

    def __init__(self, store: HostEmbeddingStore,
                 metrics: MetricRegistry | None = None):
        self.store = store
        self.metrics = metrics or MetricRegistry()
        self.metrics.phase = JOIN_PHASE
        self.date: int | None = None
        self.pass_id = 0
        self.in_pass = False
        self._pass_t0 = 0.0

    @property
    def phase(self) -> int:
        """The metric registry holds the phase: it gates accumulation."""
        return self.metrics.phase

    def set_date(self, date: int) -> None:
        self.date = int(date)

    def begin_pass(self) -> None:
        if self.in_pass:
            raise RuntimeError("begin_pass while a pass is open")
        self.in_pass = True
        self.pass_id += 1
        self._pass_t0 = time.time()

    def end_pass(self, need_save_delta: bool = False,
                 delta_path: str | None = None,
                 checkpointer=None, trainer=None,
                 dataset=None, publisher=None) -> dict[str, Any]:
        """Close the pass. With ``checkpointer`` (a PassCheckpointer) and
        ``trainer``, commit the crash-safe pass snapshot (dense +
        optimizer + sparse base/delta + metrics + cursor); ``dataset``
        adds its shuffle cursor. ``need_save_delta`` writes a delta of the
        store into ``delta_path``. ``publisher`` (serving) is not ported
        yet and raises."""
        if publisher is not None:
            raise NotImplementedError(
                "end_pass(publisher=...): publishing to the serving plane "
                "is not ported yet (ROADMAP, queue 1: serving)")
        if not self.in_pass:
            raise RuntimeError("end_pass without begin_pass")
        self.in_pass = False
        out: dict[str, Any] = {"pass_id": self.pass_id,
                               "seconds": time.time() - self._pass_t0}
        if checkpointer is not None:
            if trainer is None:
                raise ValueError("end_pass(checkpointer=...) needs trainer")
            shuffle_state = (dataset.shuffle_state()
                             if dataset is not None
                             and hasattr(dataset, "shuffle_state")
                             else None)
            out["snapshot"] = checkpointer.save(trainer, box=self,
                                                metrics=self.metrics,
                                                shuffle_state=shuffle_state)
        if need_save_delta:
            if delta_path is None:
                raise ValueError("need_save_delta requires delta_path")
            out["delta_file"] = self.store.save_delta(
                delta_path, pass_id=self.pass_id)
        return out

    def flip_phase(self) -> None:
        """Join ↔ update flip; metrics follow the phase."""
        self.metrics.flip_phase()

    # ---- table hygiene ----

    def shrink_table(self, min_show: float, decay: float = 1.0) -> int:
        return self.store.shrink(min_show, decay)

    # ---- metric surface ----

    def init_metric(self, name: str, **kw) -> None:
        self.metrics.init_metric(name, **kw)

    def get_metric_msg(self, name: str) -> dict[str, float]:
        return self.metrics.get_metric_msg(name)
