"""Binary columnar archive of parsed slot records — the port of
``data/archive.py``, byte-compatible with it both ways.

Parsed SlotRecords are written once and reloaded without re-tokenizing
text (the reference's BinaryArchiveWriter and ``LoadIntoMemoryByArchive``).
Text parse is the ingest bottleneck, so repeated passes over the same
day's data pay it once.

Format (``.pbar``): magic + little-endian uint64 header length + JSON header
+ raw column bytes in header order. Columns are exactly the
``SlotRecordBatch`` fields, so load is ``np.frombuffer`` per column — no
per-record work at all.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch

MAGIC = b"PBAR1\n"
ARCHIVE_SUFFIX = ".pbar"


def _columns(batch: SlotRecordBatch) -> list[tuple[str, np.ndarray]]:
    cols: list[tuple[str, np.ndarray]] = []
    for s, slot in enumerate(batch.schema.sparse_slots):
        cols.append((f"sparse_values/{slot.name}", batch.sparse_values[s]))
        cols.append((f"sparse_offsets/{slot.name}", batch.sparse_offsets[s]))
    for f, slot in enumerate(batch.schema.float_slots):
        cols.append((f"float_values/{slot.name}", batch.float_values[f]))
    cols.append(("ins_id", batch.ins_id))
    cols.append(("search_id", batch.search_id))
    cols.append(("rank", batch.rank))
    cols.append(("cmatch", batch.cmatch))
    return cols


def write_archive(path: str, batch: SlotRecordBatch) -> None:
    cols = _columns(batch)
    header = {
        "num": batch.num,
        "sparse_slots": [s.name for s in batch.schema.sparse_slots],
        "float_slots": [s.name for s in batch.schema.float_slots],
        "columns": [{"name": n, "dtype": str(a.dtype), "len": len(a)}
                    for n, a in cols],
    }
    hdr = json.dumps(header).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(hdr)).tobytes())
        f.write(hdr)
        for _, a in cols:
            f.write(np.ascontiguousarray(a).tobytes())
        # fsync before the rename: without it a power loss can leave the
        # final name pointing at zero-length bytes (rename persisted, data
        # not) — the tmp->fsync->replace discipline of atomic_file
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: readers never see partial archives


def read_archive(path: str, schema: DataFeedSchema) -> SlotRecordBatch:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC!r} archive")
    off = len(MAGIC)
    hlen = int(np.frombuffer(buf, np.uint64, 1, off)[0])
    off += 8
    header = json.loads(buf[off:off + hlen].decode("utf-8"))
    off += hlen
    want_sparse = [s.name for s in schema.sparse_slots]
    want_float = [s.name for s in schema.float_slots]
    if (header["sparse_slots"] != want_sparse
            or header["float_slots"] != want_float):
        raise ValueError(
            f"{path}: archive slots {header['sparse_slots']}/"
            f"{header['float_slots']} do not match schema "
            f"{want_sparse}/{want_float}")
    num = int(header["num"])
    float_widths = {s.name: s.max_len for s in schema.float_slots}
    arrays: dict[str, np.ndarray] = {}
    for col in header["columns"]:
        dt = np.dtype(col["dtype"])
        n = int(col["len"])
        group, _, name = col["name"].partition("/")
        if group == "float_values":
            want = num * float_widths[name]
            if n != want or dt != np.float32:
                raise ValueError(
                    f"{path}: float slot {name!r} was archived with "
                    f"{n // max(num, 1)} values/example "
                    f"({dt}), schema expects {float_widths[name]} "
                    "(float32) — stale archive?")
        arrays[col["name"]] = np.frombuffer(buf, dt, n, off).copy()
        off += n * dt.itemsize
    return SlotRecordBatch(
        schema=schema, num=num,
        sparse_values=[arrays[f"sparse_values/{n}"] for n in want_sparse],
        sparse_offsets=[arrays[f"sparse_offsets/{n}"] for n in want_sparse],
        float_values=[arrays[f"float_values/{n}"] for n in want_float],
        ins_id=arrays["ins_id"], search_id=arrays["search_id"],
        rank=arrays["rank"], cmatch=arrays["cmatch"],
    )


def archive_filelist(files: Sequence[str], schema: DataFeedSchema,
                     out_dir: str, **read_kw) -> list[str]:
    """Convert text files to archives (one .pbar per input), returning the
    new filelist — the 'pay parse once' preprocessing step. ``read_kw``
    are ``reader.read_file``'s (pipe_command, with_ins_id, ...)."""
    from paddlebox_tpu_torch.data.reader import read_file
    os.makedirs(out_dir, exist_ok=True)
    out: list[str] = []
    seen: set[str] = set()
    for path in files:
        batch = read_file(path, schema, **read_kw)
        name = os.path.basename(path) + ARCHIVE_SUFFIX
        if name in seen:
            raise ValueError(
                f"archive name collision: two inputs map to {name!r}")
        seen.add(name)
        dst = os.path.join(out_dir, name)
        write_archive(dst, batch)
        out.append(dst)
    return out
