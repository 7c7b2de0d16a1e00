"""Join/update phase training — the port of
``paddlebox_tpu/train/phased.py`` (``PhasedTrainer`` :31-79).

The reference's ``FlipPhase`` (box_wrapper.h:625) alternates the
training program between pass groups over ONE sparse table: the join
phase trains with the CVM show/clk columns (``use_cvm=True``), the
update phase without them (``use_cvm=False``, a narrower input and so a
different dense network). Metrics accumulate per phase (the registry's
phase gate).

Two ``Trainer``s, one per phase's model, share the store and ONE
``FeedPassManager``: a flip reuses the resident working set on the
device like consecutive passes do. Each phase keeps its own dense params
and optimizer. Both run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any

import torch

from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.fleet.boxps import JOIN_PHASE
from paddlebox_tpu_torch.train.trainer import Trainer, TrainerConfig


class PhasedTrainer:
    """Two-phase (join/update) trainer over one shared sparse table."""

    def __init__(self, join_model, update_model,
                 store: HostEmbeddingStore, schema: DataFeedSchema,
                 join_config: TrainerConfig | None = None,
                 update_config: TrainerConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None):
        if getattr(join_model, "use_cvm", True) is False:
            raise ValueError("join_model must be built with use_cvm=True")
        if getattr(update_model, "use_cvm", False) is True:
            raise ValueError("update_model must be built with use_cvm=False")
        self.join = Trainer(join_model, store, schema, join_config,
                            seed=seed, device=device)
        # the update program shares the feed manager: a phase flip reuses
        # the resident working set instead of rebuilding it
        self.update = Trainer(update_model, store, schema, update_config,
                              seed=seed + 1, device=self.join.device,
                              feed_mgr=self.join.feed_mgr)
        self.store = store

    def trainer_for(self, phase: int) -> Trainer:
        return self.join if phase == JOIN_PHASE else self.update

    def train_pass(self, dataset, box=None, metrics: Any = None,
                   phase: int | None = None) -> dict[str, float]:
        """One pass with the program the phase bit selects: a BoxPS's
        current phase (its metric registry receives the batches, gated
        by phase) or an explicit ``phase``."""
        if phase is None:
            if box is None:
                raise ValueError("need box or explicit phase")
            phase = box.phase
        if metrics is None and box is not None:
            metrics = box.metrics
        out = self.trainer_for(phase).train_pass(dataset, metrics=metrics)
        out["phase"] = phase
        return out

    def eval_pass(self, dataset, phase: int = JOIN_PHASE) -> dict[str, float]:
        return self.trainer_for(phase).eval_pass(dataset)

    def flush_sparse(self) -> int:
        return self.join.flush_sparse()
