"""MultiSlot text parsing — the port of ``data/parser.py`` (NumPy path).

MultiSlot text protocol: for each example (one line), for each slot in
schema order: ``<len> v_1 ... v_len`` separated by whitespace. uint64
slots carry feature signs (stored as int64 bit patterns), float slots
carry floats. A malformed line is skipped with a warning; an input where
every line is malformed raises. Instance-id prefixes and the native
parser are not ported yet (ROADMAP).
"""

from __future__ import annotations

import warnings
from typing import Iterable, Sequence

import numpy as np

from paddlebox_tpu_torch.data.schema import DataFeedSchema, SlotType
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch

_U64_MASK = (1 << 64) - 1
_U64_WRAP = 1 << 64
_I64_MAX1 = 1 << 63


def parse_multislot_buffer(buf: bytes,
                           schema: DataFeedSchema) -> SlotRecordBatch:
    """Parse a whole raw text buffer."""
    return parse_multislot_lines(
        buf.decode("utf-8", errors="replace").splitlines(), schema)


def _wrap_i64(v: str) -> int:
    u = int(v) & _U64_MASK
    return u - _U64_WRAP if u >= _I64_MAX1 else u


def parse_multislot_lines(lines: Iterable[str],
                          schema: DataFeedSchema) -> SlotRecordBatch:
    """Parse MultiSlot text lines into one columnar SlotRecordBatch."""
    slots = schema.slots
    n_sparse = len(schema.sparse_slots)
    n_float = len(schema.float_slots)
    sparse_vals: list[list[int]] = [[] for _ in range(n_sparse)]
    sparse_lens: list[list[int]] = [[] for _ in range(n_sparse)]
    float_vals: list[list[float]] = [[] for _ in range(n_float)]
    num = 0
    n_bad = 0
    lineno = 0
    for line in lines:
        lineno += 1
        line = line.strip()
        if not line:
            continue
        # parse into per-line buffers, commit to the columns on success
        row_sparse: list[tuple[list[int], int]] = []
        row_float: list[list[float]] = []
        try:
            toks = line.split()
            pos = 0
            for slot in slots:
                if pos >= len(toks):
                    raise ValueError(
                        f"ran out of tokens at slot {slot.name!r}")
                ln = int(toks[pos])
                pos += 1
                if ln < 0:
                    raise ValueError(
                        f"slot {slot.name!r} declares negative length {ln}")
                if pos + ln > len(toks):
                    raise ValueError(
                        f"slot {slot.name!r} declares {ln} values but "
                        f"line ends")
                vals = toks[pos:pos + ln]
                pos += ln
                if not slot.is_used:
                    continue
                if slot.type == SlotType.UINT64:
                    row_sparse.append(([_wrap_i64(v) for v in vals], ln))
                else:
                    w = slot.max_len
                    fv = [float(v) for v in vals[:w]]
                    fv += [0.0] * (w - len(fv))
                    row_float.append(fv)
        except ValueError as err:
            n_bad += 1
            if n_bad == 1:
                warnings.warn(f"malformed MultiSlot line {lineno} (skipped): "
                              f"{line[:120]!r} ({err})")
            continue
        for i, (vals_i, ln_i) in enumerate(row_sparse):
            sparse_vals[i].extend(vals_i)
            sparse_lens[i].append(ln_i)
        for i, fv_i in enumerate(row_float):
            float_vals[i].extend(fv_i)
        num += 1
    if num == 0 and n_bad:
        raise ValueError(
            f"every line was malformed MultiSlot ({n_bad} skipped) — "
            f"wrong schema or non-MultiSlot input?")
    sparse_values = [np.asarray(v, dtype=np.int64) for v in sparse_vals]
    sparse_offsets = []
    for lens in sparse_lens:
        offs = np.zeros(num + 1, dtype=np.int64)
        if lens:
            np.cumsum(np.asarray(lens, dtype=np.int64), out=offs[1:])
        sparse_offsets.append(offs)
    return SlotRecordBatch(
        schema=schema, num=num,
        sparse_values=sparse_values, sparse_offsets=sparse_offsets,
        float_values=[np.asarray(v, dtype=np.float32) for v in float_vals],
        ins_id=np.zeros(num, dtype=np.uint64),
        search_id=np.zeros(num, dtype=np.uint64),
        rank=np.zeros(num, dtype=np.int32),
        cmatch=np.zeros(num, dtype=np.int32),
    )


def format_multislot_example(slot_values: Sequence[tuple[str, Sequence]],
                             schema: DataFeedSchema) -> str:
    """Inverse of the parser: one MultiSlot text line."""
    by_name = dict(slot_values)
    parts: list[str] = []
    for slot in schema.slots:
        vals = by_name.get(slot.name, ())
        parts.append(str(len(vals)))
        parts.extend(str(v) for v in vals)
    return " ".join(parts)
