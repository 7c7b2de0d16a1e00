"""The model contract — the port of ``models/base.py``.

A CTR model is an ``nn.Module`` that owns its dense parameters (the
embedding table is the trainer's) and is called as

    model(pulled, mask, dense, segment_ids, num_slots, *extras) -> (B,)

- ``pulled``: (B, T, P) raw pull values of every sparse token (P = show,
  clk, w, embedx; see embedding/config.py) with ``mask`` (B, T), or a
  ``PooledSlots`` (B, S, P) when the model sets ``pooled_pull_ok`` and
  the trainer pools inside the pull (the gather_pool kernel);
- ``dense``: (B, F) float slot columns (label excluded);
- ``extras``: the arrays of the model's ``batch_extras(pb, n_shards)``
  hook, if it declares one (``num_extras`` of them), built on the
  trainer's pack thread per batch;

and returns logits (B,). ``init(generator)`` draws fresh parameters;
parameter names are the JAX package's pytree paths with dots
(``weights.py`` maps them both ways).
"""

from __future__ import annotations

from typing import Protocol

import torch


class CTRModel(Protocol):
    name: str
    emb_dim: int

    def init(self, generator: torch.Generator) -> None: ...

    def __call__(self, pulled, mask: torch.Tensor, dense: torch.Tensor,
                 segment_ids, num_slots: int | None = None,
                 *extras) -> torch.Tensor: ...
