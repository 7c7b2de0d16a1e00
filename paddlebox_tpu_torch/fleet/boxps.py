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

``end_pass(publisher=…, trainer=…)`` then publishes the pass's model to
the serving plane (``serving.ServingPublisher``), after the snapshot; a
failed publish degrades to a warning and ``{"error": ...}`` under
``"publish"`` (serving keeps its last good version) instead of ending
the pass loop.

The pass boundary of the storage tiers runs in ``end_pass`` after the
snapshot and the publish: ``tiering.end_pass_rebalance`` re-scores a
spill store's RAM tier (its counts under ``"tiering"``), then
``trainer.refresh_replica_boundary`` rebuilds the replica tier from that
ranking. While a BoxPS pass is open its store's ``boundary_owner`` is
the BoxPS, so ``Trainer.train_pass`` leaves that work to ``end_pass``.

Telemetry: ``begin_pass`` opens the hub's pass scope, so everything
until ``end_pass`` — trainer steps, worker threads, checkpoint commits —
is tagged with the pass; ``end_pass`` commits the pass's flight record
last and returns it under ``"flight_record"``; ``abort_pass`` closes the
scope without one; ``flip_phase`` emits ``flip_phase``.

On a mesh, ``attach_collectives`` makes ``begin_pass`` and ``end_pass``
barrier over the world, and ``end_pass(trainer=)`` runs the trainer's
exchange-wire adaptation (``Trainer.adapt_wire_boundary``) before the
flight record commits. With a heartbeat (``attach_collectives(col,
heartbeat=hb)``, a ``distributed.resilience.HeartbeatMonitor``) those
barriers poll its watchdog, so a dead or hung peer fails them by name,
and each boundary publishes a fresh beat.

The read side: ``end_pass(trainer=)`` runs the trainer's self-healing
boundary (``Trainer.remediation_boundary``, ``flags.self_healing``)
before the flight record commits, so an applied action lands in this
pass's record (``out["remediation"]``); with ``flags.doctor_live`` the
doctor's findings of the committed record come back under
``out["doctor"]``.
"""

from __future__ import annotations

import time
import warnings
from typing import Any

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.embedding import tiering
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
        # the multi-host lifecycle (attach_collectives): lockstep barriers
        # at the pass boundaries, and the heartbeat watchdog they poll
        self._col = None
        self._heartbeat = None

    def attach_collectives(self, collectives, heartbeat=None) -> None:
        """Make the pass lifecycle world-synchronous: ``begin_pass`` and
        ``end_pass`` barrier over the collectives (a ``HostCollectives``
        or a mesh's ``collectives()``), so no rank trains a pass the world
        has not entered (the reference's MPICluster barrier around
        BeginPass/EndPass, box_wrapper.h:415).

        With ``heartbeat`` (a ``HeartbeatMonitor``) the barriers poll its
        watchdog — a dead or stalled peer raises PeerLost/PeerStalled
        naming the ranks instead of the store's timeout — unless the
        collectives already carry one, and each boundary publishes a
        fresh beat, so peers see this rank's pass at once.

        Re-attachable: after an elastic re-formation the training loop (or
        ``Trainer.recover_world``) attaches the new generation's
        collectives and heartbeat, whose barriers ride that generation's
        store scope."""
        self._col = collectives
        self._heartbeat = heartbeat
        if heartbeat is not None and getattr(collectives, "watchdog",
                                             None) is None:
            collectives.watchdog = heartbeat

    @property
    def phase(self) -> int:
        """The metric registry holds the phase: it gates accumulation."""
        return self.metrics.phase

    def set_date(self, date: int) -> None:
        self.date = int(date)

    def begin_pass(self) -> None:
        if self.in_pass:
            raise RuntimeError("begin_pass while a pass is open")
        if self._col is not None:
            # lockstep: no rank opens pass N+1 until the world is ready
            self._col.barrier("begin_pass")
        # the telemetry pass scope first: the world trace samples here
        monitor.hub().begin_pass(self.pass_id + 1, phase=self.phase)
        self.in_pass = True
        self.store.boundary_owner = self
        self.pass_id += 1
        self._pass_t0 = time.time()
        if self._heartbeat is not None:
            self._heartbeat.publish()     # peers see the new pass at once

    def abort_pass(self, reason: str = "") -> None:
        """Close an open pass without the end-of-pass snapshot: the pass
        raised, and its work is drained (``Trainer.drain_and_snapshot``)
        or dropped. The telemetry scope is aborted, so no flight record
        commits for a half-trained pass. No-op when no pass is open."""
        if not self.in_pass:
            return
        self.in_pass = False
        self.store.boundary_owner = None
        monitor.hub().abort_pass(reason=reason or "pass aborted")
        monitor.event("pass_aborted", pass_id=int(self.pass_id),
                      reason=reason[:200])

    def end_pass(self, need_save_delta: bool = False,
                 delta_path: str | None = None,
                 checkpointer=None, trainer=None,
                 dataset=None, publisher=None) -> dict[str, Any]:
        """Close the pass. With ``checkpointer`` (a PassCheckpointer) and
        ``trainer``, commit the crash-safe pass snapshot (dense +
        optimizer + sparse base/delta + metrics + cursor); ``dataset``
        adds its shuffle cursor. ``need_save_delta`` writes a delta of the
        store into ``delta_path``. ``publisher`` (a ServingPublisher,
        with ``trainer`` for the dense params) ships the pass's model to
        the serving plane after the snapshot; a publish failure warns and
        returns ``{"error": ...}`` under ``"publish"``."""
        if not self.in_pass:
            raise RuntimeError("end_pass without begin_pass")
        self.in_pass = False
        self.store.boundary_owner = None
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
        if publisher is not None:
            if trainer is None:
                raise ValueError("end_pass(publisher=...) needs trainer "
                                 "(the dense params to publish)")
            try:
                out["publish"] = publisher.publish(
                    self.store, trainer.eval_params(),
                    pass_id=self.pass_id)
            except Exception as e:   # noqa: BLE001 — degrade, don't die
                out["publish"] = {"error": repr(e)}
                monitor.counter_add("serving.publish_failures")
                monitor.event("serving_publish_failed",
                              pass_id=int(self.pass_id),
                              error=repr(e)[:300])
                warnings.warn(f"serving publish failed for pass "
                              f"{self.pass_id} ({e!r}); serving stays on "
                              f"its last good version")
        # re-score the spill store's RAM tier off this pass's traffic, then
        # rebuild the replica tier from that ranking
        tier = tiering.end_pass_rebalance(self.store)
        if tier is not None:
            out["tiering"] = tier
        if trainer is not None and hasattr(trainer,
                                           "refresh_replica_boundary"):
            trainer.refresh_replica_boundary()
        if trainer is not None and hasattr(trainer, "adapt_wire_boundary"):
            wire_next = trainer.adapt_wire_boundary()
            if wire_next is not None:
                out["exchange_wire_next"] = wire_next
        # the self-healing boundary (flags.self_healing): at most one
        # guarded action, before the commit so its record and before-
        # deltas land in this pass's flight record
        if trainer is not None and hasattr(trainer, "remediation_boundary"):
            healed = trainer.remediation_boundary()
            if healed is not None:
                out["remediation"] = healed
        # the flight record commits last: the snapshot's, the publish's
        # and the tiers' counters above land in this pass's stats_delta
        out["flight_record"] = monitor.hub().end_pass(metrics=self.metrics)
        # the live doctor (flags.doctor_live) ran over the committed
        # records inside end_pass; the caller reads its findings here
        findings = monitor.hub().last_doctor_findings
        if findings:
            out["doctor"] = findings
        if self._heartbeat is not None:
            self._heartbeat.publish()
        if self._col is not None:
            self._col.barrier("end_pass")
        return out

    def flip_phase(self) -> None:
        """Join ↔ update flip; metrics follow the phase."""
        self.metrics.flip_phase()
        monitor.context.set_phase(self.phase)
        monitor.event("flip_phase", phase=self.phase)

    # ---- table hygiene ----

    def shrink_table(self, min_show: float, decay: float = 1.0) -> int:
        return self.store.shrink(min_show, decay)

    # ---- metric surface ----

    def init_metric(self, name: str, **kw) -> None:
        self.metrics.init_metric(name, **kw)

    def get_metric_msg(self, name: str) -> dict[str, float]:
        return self.metrics.get_metric_msg(name)
