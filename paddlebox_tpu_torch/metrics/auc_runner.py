"""AUC runner — per-slot feature-ablation evaluation; the port of
``paddlebox_tpu/metrics/auc_runner.py`` (``AucRunner`` :24-93).

The reference (``InitializeAucRunner``, box_wrapper.h:685-767;
``FeasignValuesCandidateList``, data_feed.h:1106) measures each slot's
AUC contribution by re-evaluating with that slot's feature values
replaced by random candidates drawn from a pool collected in normal
passes. As in the JAX package, each ablation evaluates a shallow copy of
the dataset with ONE slot's value column resampled from the pool, and
the AUC drop against the baseline eval is the slot's contribution.

The draws are the reference's: one ``np.random.default_rng(seed)``,
drawn in the same order (``collect_candidates``, then per slot in
``run`` through ``_ablated_dataset``), so both packages ablate with
identical columns. The evaluations are the trainer's ``eval_pass``
(on a multi-hot layout one ``gather_pool`` launch a batch on the card).
``flags.auc_runner_mode`` is not ported: nothing in the JAX package
reads it.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np


class AucRunner:
    def __init__(self, trainer, pool_size: int = 100_000, seed: int = 0):
        self.trainer = trainer
        self.pool_size = pool_size
        self._rng = np.random.default_rng(seed)
        # per-slot candidate feasign pools (FeasignValuesCandidateList)
        self._pools: dict[str, np.ndarray] = {}

    def collect_candidates(self, dataset) -> None:
        """Sample candidate values per sparse slot from a loaded dataset."""
        rec = dataset.records
        if rec is None:
            raise RuntimeError("no records: call load_into_memory first")
        for s, slot in enumerate(dataset.schema.sparse_slots):
            vals = rec.sparse_values[s]
            if len(vals) == 0:
                continue
            take = min(len(vals), self.pool_size)
            sample = self._rng.choice(vals, size=take, replace=False)
            prev = self._pools.get(slot.name)
            if prev is not None:
                merged = np.concatenate([prev, sample])
                if len(merged) > self.pool_size:
                    merged = self._rng.choice(merged, size=self.pool_size,
                                              replace=False)
                sample = merged
            self._pools[slot.name] = sample

    def _ablated_dataset(self, dataset, slot_name: str):
        """A shallow copy of the dataset with one slot's values resampled
        from its pool (RecordReplace without the replace-back)."""
        pool = self._pools[slot_name]
        ds = copy.copy(dataset)
        rec = copy.copy(dataset.records)
        rec.sparse_values = list(rec.sparse_values)
        names = [s.name for s in dataset.schema.sparse_slots]
        s = names.index(slot_name)
        n = len(rec.sparse_values[s])
        rec.sparse_values[s] = self._rng.choice(pool, size=n)
        ds.records = rec
        return ds

    def run(self, dataset, slots: Sequence[str] | None = None
            ) -> dict[str, dict[str, float]]:
        """Baseline eval, then one ablated eval per slot. Returns
        {"__baseline__": metrics, slot: metrics with auc_drop, ...};
        a larger ``auc_drop`` means the slot contributes more."""
        if not self._pools:
            self.collect_candidates(dataset)
        names = [s.name for s in dataset.schema.sparse_slots]
        slots = list(slots) if slots is not None else names
        base = self.trainer.eval_pass(dataset)
        out: dict[str, dict[str, float]] = {"__baseline__": base}
        for name in slots:
            if name not in self._pools:  # the slot had no feasigns
                out[name] = {"auc_drop": 0.0, "skipped": 1.0}
                continue
            m = self.trainer.eval_pass(self._ablated_dataset(dataset, name))
            m["auc_drop"] = base["auc"] - m["auc"]
            out[name] = m
        return out
