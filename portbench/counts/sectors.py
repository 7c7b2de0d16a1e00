"""Bytes the memory system must move, in whole 32-byte sectors.

``sector_ids``, ``sector_bytes``, ``dense_bytes`` and ``row_starts`` are
frozen copies of ``chip_smoke.py``'s (lines 420-450 of the port's smoke
script at the benchmark's first version), unchanged but for taking
``torch`` from the import instead of an argument, so that a later change
to the program cannot move the yardstick.

The pull and push bytes below are defined by the work on the batch's
actual rows, not by the kernel that does it: they stay the same
whichever kernel implements the pull or the push, and are counted
exactly where ``utils/step_probe.py``'s push floor estimates the
sectors of rows spread at random.
"""

from __future__ import annotations

import torch

SECTOR = 32


def sector_ids(starts: torch.Tensor, length: int) -> torch.Tensor:
    """The 32-byte sectors that byte ranges [s, s + length) cover, for
    each s in ``starts`` (an int64 tensor of byte offsets)."""
    first = starts // SECTOR
    last = (starts + length - 1) // SECTOR
    span = int((last - first).max()) + 1 if starts.numel() else 1
    ids = first[:, None] + torch.arange(span, device=starts.device)
    return ids[ids <= last[:, None]]


def sector_bytes(*parts) -> int:
    """Bytes in the distinct sectors that (starts, length) parts of one
    array cover: what the memory system must move to touch them once."""
    ids = torch.cat([sector_ids(st, n) for st, n in parts])
    return int(torch.unique(ids).numel()) * SECTOR


def dense_bytes(n_bytes: int) -> int:
    """A contiguous array's bytes in whole sectors."""
    return -(-int(n_bytes) // SECTOR) * SECTOR


def row_starts(rows: torch.Tensor, stride_floats: int, col: int = 0):
    """Byte offsets of column ``col`` of the given rows of an f32 array
    whose rows are ``stride_floats`` apart."""
    return (rows.long() * stride_floats + col) * 4


def pull_bytes(rows: torch.Tensor, table_stride: int, pull_width: int,
               out_floats: int) -> int:
    """The least bytes of one batch's pull: each token's row id read
    once, each distinct row's pulled columns read once at the table's
    stride, and the output (``out_floats`` f32 values: per token for a
    plain gather, per example and slot for a pooled one) written once.

    rows : the batch's row ids, one per token (int tensor)."""
    uniq = torch.unique(rows.reshape(-1))
    return (dense_bytes(rows.numel() * 4)
            + sector_bytes((row_starts(uniq, table_stride), pull_width * 4))
            + dense_bytes(out_floats * 4))


def push_bytes(rows: torch.Tensor, table_stride: int, row_width: int,
               grad_width: int) -> int:
    """The least bytes of one batch's push: each token's row id, its
    ``grad_width`` gradient values and its show and click increments read
    once, and each distinct row read and written once at the table's
    stride (its counters, weights and optimizer state)."""
    uniq = torch.unique(rows.reshape(-1))
    touched = sector_bytes((row_starts(uniq, table_stride), row_width * 4))
    return dense_bytes(rows.numel() * (grad_width + 3) * 4) + 2 * touched
