"""Predictor — the port of ``paddlebox_tpu/inference/predictor.py``
(``make_serving_fn`` :27-37, ``Predictor`` :39-105).

Serving splits as training does: the embedding half is a host lookup in
the ``ServingTable`` (sorted keys, ``np.searchsorted``, gather), the
dense half runs on the card. ``predict`` makes one host → device copy
of the pulled rows (B, T, P), the mask and the dense features, runs the
forward under ``torch.no_grad()``, takes the sigmoid and copies the
probabilities back once.

Each Predictor owns its module: it is built fresh from the model's class
and config and the given params are loaded into it, so neither the
caller's model (a trainer's, say) nor another Predictor's is ever
touched. ``with_model`` builds the next version's module the same way,
off the request path, and never writes into the module a live version
is serving from. It runs on the card unless ``device="cpu"``; without a
card and without that request it raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import PackedBatch, SparseLayout
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.inference import export
from paddlebox_tpu_torch.inference.serving_table import ServingTable


def make_serving_fn(model: Any, segment_ids, num_slots: int):
    """The one serving forward: sigmoid(apply(...)), multi-task aware
    (``apply_tasks`` gives (B, tasks))."""
    apply = getattr(model, "apply_tasks", None) or model

    def fwd(pulled, mask, dense):
        return torch.sigmoid(apply(pulled, mask, dense, segment_ids,
                                   num_slots))

    return fwd


def _module(model: Any, params: Any, device: torch.device):
    """A fresh eval-mode module of ``model``'s class and config with
    ``params`` (a JAX-layout tree) loaded, on ``device``."""
    m = export.build_model(type(model), export.model_config(model))
    weights.load_model_params(m, params)
    return m.to(device).eval()


class Predictor:
    """Batch scorer over an exported model directory."""

    def __init__(self, model: Any, params: Any, table: ServingTable,
                 schema: DataFeedSchema, label_slot: str = "label",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = _module(model, params, self.device)
        self.params = params
        self.table = table
        self.schema = schema
        self.label_slot = label_slot
        self.layout = SparseLayout.from_schema(schema)
        self._fwd = make_serving_fn(self.model, self.layout.segment_ids,
                                    self.layout.num_slots)

    @classmethod
    def load(cls, path: str, device: str | torch.device | None = None
             ) -> "Predictor":
        model, params, table, schema, meta = export.load_inference_model(
            path)
        return cls(model, params, table, schema,
                   label_slot=meta.get("label_slot", "label"),
                   device=device)

    def with_model(self, params: Any, table: ServingTable) -> "Predictor":
        """A Predictor of the same architecture serving new params and
        table: a fresh module with ``params`` loaded, on this one's
        device. This Predictor's module is left as it is, so requests in
        flight on it finish on the old weights."""
        return Predictor(self.model, params, table, self.schema,
                         label_slot=self.label_slot, device=self.device)

    # ------------------------------------------------------------------
    def stage(self, pulled: np.ndarray, mask: np.ndarray,
              dense: np.ndarray) -> tuple[torch.Tensor, ...]:
        """The one host → device copy of a batch's inputs."""
        dev = self.device
        return (torch.from_numpy(pulled).to(dev),
                torch.from_numpy(mask).to(dev),
                torch.from_numpy(dense).to(dev))

    @torch.no_grad()
    def forward(self, pulled: torch.Tensor, mask: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        """Probabilities on the device: (B,), or (B, tasks)."""
        return self._fwd(pulled, mask, dense)

    def predict(self, ids: np.ndarray, mask: np.ndarray,
                dense: np.ndarray | None = None) -> np.ndarray:
        """ids uint64 (B, T) raw feature signs, mask bool (B, T), dense
        float32 (B, F) → probabilities (B,) (or (B, tasks) for
        multi-task models)."""
        ids = np.asarray(ids)
        mask = np.ascontiguousarray(mask, bool)
        if ids.ndim != 2 or ids.shape[1] != self.layout.total_len:
            raise ValueError(f"ids shape {ids.shape}: the token axis must "
                             f"be the schema's T={self.layout.total_len}")
        pulled = self.table.lookup(ids, mask)
        if dense is None:
            dense = np.zeros((ids.shape[0], 0), np.float32)
        dense = np.ascontiguousarray(dense, np.float32)
        out = self.forward(*self.stage(pulled, mask, dense))
        return out.cpu().numpy()

    def predict_batch(self, pb: PackedBatch) -> np.ndarray:
        """Score a PackedBatch; the label column (if the schema has one)
        is dropped from the float features."""
        lc, lw, _ = pb.schema.float_split_cols(self.label_slot)
        floats = pb.floats
        if lc >= 0:
            floats = np.concatenate([floats[:, :lc], floats[:, lc + lw:]],
                                    axis=1)
        return self.predict(pb.ids.astype(np.uint64), pb.mask, floats)
