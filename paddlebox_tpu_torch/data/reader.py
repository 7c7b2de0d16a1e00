"""File reader — the port of ``data/reader.py`` for local files.

Reads one local MultiSlot text file (gzip when the name ends in ``.gz``)
into a columnar batch. The JAX package's other ingestion modes (pipe
commands, parser plugins, remote filesystems, pre-tokenized archives)
are not ported yet (ROADMAP).
"""

from __future__ import annotations

import gzip

from paddlebox_tpu_torch.data.parser import parse_multislot_buffer
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch


def read_file(path: str, schema: DataFeedSchema) -> SlotRecordBatch:
    """Read one file into a columnar batch."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        buf = f.read()
    return parse_multislot_buffer(buf, schema)
