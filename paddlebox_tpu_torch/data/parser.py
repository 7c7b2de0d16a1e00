"""MultiSlot text parsing — the port of ``data/parser.py``.

MultiSlot text protocol: for each example (one line), for each slot in
schema order: ``<len> v_1 ... v_len`` separated by whitespace. uint64
slots carry feature signs (stored as int64 bit patterns, so signs at or
above 2^63 wrap), float slots carry floats padded or truncated to the
slot's width. With ``with_ins_id`` each line starts ``<ins_id>\\t`` and
the batch's ``ins_id`` column holds ``hash64`` of that string.

Two implementations with one result: the native C++ parser
(``native/slot_parser.py``, the production path: host parse is the
ingest bottleneck) and the Python one below. The native parser is
strict: on its ``ValueError`` the input is parsed again in Python, which
skips each malformed line, counts it and warns on the first, and raises
only when every line is malformed. That re-parse is the malformed-input
contract, not a stand-in for a missing library.

Counts go to a caller-owned :class:`ParseStats` (the JAX package sends
them to its monitor as ``reader.parse_errors``; the port has no monitor
yet): which backend parsed each buffer, how many native parses were
rejected, and how many lines were skipped.
"""

from __future__ import annotations

import threading
import warnings
from typing import Iterable, Sequence

import numpy as np

from paddlebox_tpu_torch.data.schema import DataFeedSchema, SlotType
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.native import slot_parser
from paddlebox_tpu_torch.utils.hashing import hash64

_U64_MASK = (1 << 64) - 1
_U64_WRAP = 1 << 64
_I64_MAX1 = 1 << 63


class ParseStats:
    """Thread-safe parse counters, owned by the caller (a dataset per
    load): ``native`` / ``python`` count the buffers each backend parsed,
    ``native_rejects`` the native parses that raised on malformed input
    (then re-parsed in Python), ``parse_errors`` the lines skipped."""

    FIELDS = ("native", "python", "native_rejects", "parse_errors")

    def __init__(self):
        self._lock = threading.Lock()
        self.native = self.python = 0
        self.native_rejects = self.parse_errors = 0

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> dict[str, int]:
        with self._lock:
            return {k: getattr(self, k) for k in self.FIELDS}


def is_native() -> bool:
    """Whether parses go through the native C++ parser (its library
    built and loaded); see ``native.slot_parser.build_error`` when not."""
    return slot_parser.available()


def _add(stats: ParseStats | None, name: str, n: int = 1) -> None:
    if stats is not None:
        stats.add(name, n)


def parse_multislot_lines(lines: Iterable[str], schema: DataFeedSchema,
                          with_ins_id: bool = False,
                          stats: ParseStats | None = None
                          ) -> SlotRecordBatch:
    """Parse MultiSlot text lines into one columnar SlotRecordBatch."""
    if slot_parser.available():
        lines = list(lines)      # re-iterable for the Python re-parse
        try:
            out = slot_parser.parse_lines(lines, schema,
                                          with_ins_id=with_ins_id)
        except ValueError:
            # strict native parser: re-parse in Python, which skips and
            # names each malformed line
            _add(stats, "native_rejects")
        else:
            _add(stats, "native")
            return out
    return _parse_python(lines, schema, with_ins_id, stats)


def parse_multislot_buffer(buf: bytes, schema: DataFeedSchema,
                           with_ins_id: bool = False,
                           stats: ParseStats | None = None,
                           n_threads: int = 0) -> SlotRecordBatch:
    """Parse a whole raw text buffer: the native parser takes the bytes
    as they are (``n_threads`` parser threads, 0 = one per hardware
    thread; the result does not depend on it)."""
    if slot_parser.available():
        try:
            out = slot_parser.parse_buffer(buf, schema,
                                           with_ins_id=with_ins_id,
                                           n_threads=n_threads)
        except ValueError:
            _add(stats, "native_rejects")
        else:
            _add(stats, "native")
            return out
    # errors="replace", not strict: a torn line of binary garbage must
    # reach the per-line skip, not fail the whole file unnamed
    return _parse_python(buf.decode("utf-8", errors="replace").splitlines(),
                         schema, with_ins_id, stats)


def _note_malformed_line(lineno: int, line: str, err: Exception,
                         n_bad: int, stats: ParseStats | None) -> None:
    """Every skip counts; the first of a parse call warns, naming the
    line."""
    _add(stats, "parse_errors")
    if n_bad == 1:
        warnings.warn(f"malformed MultiSlot line {lineno} (skipped): "
                      f"{line[:120]!r} ({err}); counted in "
                      f"ParseStats.parse_errors")


def _wrap_i64(v: str) -> int:
    u = int(v) & _U64_MASK
    return u - _U64_WRAP if u >= _I64_MAX1 else u


def _parse_python(lines: Iterable[str], schema: DataFeedSchema,
                  with_ins_id: bool,
                  stats: ParseStats | None = None) -> SlotRecordBatch:
    _add(stats, "python")
    slots = schema.slots
    n_sparse = len(schema.sparse_slots)
    n_float = len(schema.float_slots)
    sparse_vals: list[list[int]] = [[] for _ in range(n_sparse)]
    sparse_lens: list[list[int]] = [[] for _ in range(n_sparse)]
    float_vals: list[list[float]] = [[] for _ in range(n_float)]
    ins_ids: list[int] = []
    num = 0
    n_bad = 0
    lineno = 0
    for line in lines:
        lineno += 1
        line = line.strip()
        if not line:
            continue
        # parse into per-line buffers, commit to the columns on success:
        # a line failing mid-slot leaves no partial state
        row_ins = 0
        row_sparse: list[tuple[list[int], int]] = []
        row_float: list[list[float]] = []
        try:
            if with_ins_id:
                ins_id_str, _, line = line.partition("\t")
                row_ins = hash64(ins_id_str)
            toks = line.split()
            pos = 0
            for slot in slots:
                if pos >= len(toks):
                    raise ValueError(
                        f"ran out of tokens at slot {slot.name!r}")
                ln = int(toks[pos])
                pos += 1
                if ln < 0:
                    # a negative length would pass the bounds check below
                    # (empty slice, pos moving backwards) and emit
                    # negative lengths
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
            _note_malformed_line(lineno, line, err, n_bad, stats)
            continue
        for i, (vals_i, ln_i) in enumerate(row_sparse):
            sparse_vals[i].extend(vals_i)
            sparse_lens[i].append(ln_i)
        for i, fv_i in enumerate(row_float):
            float_vals[i].extend(fv_i)
        if with_ins_id:
            ins_ids.append(row_ins)
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
    ins = (np.asarray(ins_ids, dtype=np.uint64) if with_ins_id
           else np.zeros(num, dtype=np.uint64))
    return SlotRecordBatch(
        schema=schema, num=num,
        sparse_values=sparse_values, sparse_offsets=sparse_offsets,
        float_values=[np.asarray(v, dtype=np.float32) for v in float_vals],
        ins_id=ins,
        search_id=np.zeros(num, dtype=np.uint64),
        rank=np.zeros(num, dtype=np.int32),
        cmatch=np.zeros(num, dtype=np.int32),
    )


def format_multislot_example(slot_values: Sequence[tuple[str, Sequence]],
                             schema: DataFeedSchema) -> str:
    """Inverse of the parser: one MultiSlot text line (the data
    generator's output)."""
    by_name = dict(slot_values)
    parts: list[str] = []
    for slot in schema.slots:
        vals = by_name.get(slot.name, ())
        parts.append(str(len(vals)))
        parts.extend(str(v) for v in vals)
    return " ".join(parts)
