"""The Criteo-shaped example generator that every mix reads.

Adapted from ``chip_smoke.py``'s ``make_records`` (line 926 of the
port's smoke script at the benchmark's first version): the same record
layout (a 25%-positive label, 13 standard normal dense floats, zeroed
metadata columns; one id per categorical slot, or the configuration's
``hotness`` ids) built into the port's ``SlotRecordBatch``. Two things
differ, because the smoke script draws from one materialised key array,
which does not scale to fields of 40 million keys:

- each field has a cardinality of its own (the configuration's), and its
  ids are power-law (Zipf-like) draws over ranks 0..card-1, by the
  inverse of the bounded continuous power law's CDF, so rank r is drawn
  with a probability near r^-s;
- a rank becomes a key by ``key(field, rank)``: the field in the top
  bits and an odd-multiplier bijection of the rank below them, so hot
  ranks scatter over the key space and fields never share a key.

Draws run on the benchmark's device from a ``torch.Generator`` seeded
from ``--seed``: the same seed gives the same examples on the same
device.
"""

from __future__ import annotations

import numpy as np
import torch

RANK_BITS = 40
_MASK = (1 << RANK_BITS) - 1
_MULT = 0x9E3779B1            # odd: a bijection of the ranks mod 2^40
_ADD = 0x5BD1E995


def key_of(field: int, rank: torch.Tensor) -> torch.Tensor:
    """The feature sign of ``rank`` in ``field`` (int64; ranks < 2^26,
    so the product stays inside 63 bits)."""
    return ((field + 1) << RANK_BITS) | ((rank * _MULT + _ADD) & _MASK)


def rank_of(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``key_of``: (field, rank) of int64 keys."""
    inv = pow(_MULT, -1, 1 << RANK_BITS)
    field = (keys >> RANK_BITS) - 1
    low = ((keys & _MASK) - _ADD) & _MASK
    # (low * inv) mod 2^40 in pieces that stay inside 63 bits
    lo, hi = low & 0xFFFFF, (low >> 20) & 0xFFFFF
    rank = (lo * inv + ((hi * inv) & _MASK) * (1 << 20)) & _MASK
    return field, rank


def power_law_ranks(gen: torch.Generator, n: int, card: int, s: float,
                    device) -> torch.Tensor:
    """``n`` ranks in [0, card), rank r drawn with probability about
    proportional to (r + 1)^-s (s != 1)."""
    u = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    a = 1.0 - s
    top = float(card + 1) ** a
    x = ((top - 1.0) * u + 1.0) ** (1.0 / a)
    return (x.floor().long() - 1).clamp_(0, card - 1)


def draw_keys(gen: torch.Generator, n: int, cards, s: float, device,
              hotness=None) -> torch.Tensor:
    """(n, sum of hotness) int64 keys: field f's ``hotness[f]`` ids an
    example (1 by default) drawn as one power-law draw of n * h ranks,
    field after field, each field's ids side by side."""
    hot = hotness or [1] * len(cards)
    return torch.cat([key_of(f, power_law_ranks(gen, n * h, c, s, device))
                      .reshape(n, h)
                      for f, (c, h) in enumerate(zip(cards, hot,
                                                     strict=True))],
                     dim=1)


def draw_examples(gen: torch.Generator, n: int, cfg: dict, device):
    """n examples: (keys (n, sum of hotness) int64, label (n,) f32, dense
    (n, F) f32), all on ``device``."""
    keys = draw_keys(gen, n, cfg["cardinalities"], cfg["zipf_exponent"],
                     device, cfg.get("hotness"))
    label = (torch.rand(n, generator=gen, device=device) < 0.25).float()
    dense = torch.randn(n, cfg["num_dense"], generator=gen, device=device)
    return keys, label, dense


def records(schema, keys: torch.Tensor, label: torch.Tensor,
            dense: torch.Tensor):
    """The port's SlotRecordBatch of examples whose slot f holds the
    schema's ``max_len`` ids each, side by side in ``keys`` (the slots'
    columns laid end to end on the device and copied to the host at
    once, the floats likewise)."""
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
    n = keys.shape[0]
    hot = [s.max_len for s in schema.sparse_slots]
    ends = np.cumsum(hot)
    flat = torch.cat([keys[:, e - h:e].reshape(-1)
                      for h, e in zip(hot, ends)]).cpu().numpy()
    vals = np.split(flat, n * ends[:-1])
    # one offsets array shared by the slots of a hotness: a pool of passes
    # would otherwise hold one a slot (4 MB each at 524,288 examples)
    offs = {h: np.arange(n + 1, dtype=np.int64) * h for h in set(hot)}
    floats = list(torch.cat([label[None], dense.T]).contiguous()
                  .cpu().numpy())
    z64, z32 = np.zeros(n, np.uint64), np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, [offs[h] for h in hot], floats,
                           z64, z64, z32, z32)


def unique_keys(keys: torch.Tensor) -> np.ndarray:
    """The distinct keys of a set of examples, sorted, as uint64."""
    return torch.unique(keys.reshape(-1)).cpu().numpy().view(np.uint64)
