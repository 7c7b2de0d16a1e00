"""User-side data generator — the port of ``data/data_generator.py``.

The reference's ``MultiSlotDataGenerator`` protocol: subclass it, define
``generate_sample(line)`` yielding ``[(slot_name, values), ...]`` per
example, and run the script as a dataset's ``pipe_command``; the dataset
parses the MultiSlot text it prints on stdout. The script needs only
this package (no JAX).

With ``with_ins_id=True`` (a port addition for datasets loaded with
``with_ins_id``) each yielded item is ``(ins_id, example)`` and the line
is printed as ``<ins_id>\\t<example>``.
"""

from __future__ import annotations

import sys
from typing import Iterable, Iterator

from paddlebox_tpu_torch.data.parser import format_multislot_example
from paddlebox_tpu_torch.data.schema import DataFeedSchema


class MultiSlotDataGenerator:
    """Subclass and override ``generate_sample``."""

    def __init__(self, schema: DataFeedSchema, with_ins_id: bool = False):
        self.schema = schema
        self.with_ins_id = with_ins_id

    def generate_sample(self, line: str) -> Iterator:
        """Yield zero or more examples for one raw input line; each
        example is a sequence of (slot_name, values) pairs (an
        ``(ins_id, example)`` pair with ``with_ins_id``)."""
        raise NotImplementedError

    # ---- the pipe_command entry points ----

    def process(self, lines: Iterable[str], out=None) -> int:
        out = out or sys.stdout
        n = 0
        for line in lines:
            for item in self.generate_sample(line.rstrip("\n")):
                if self.with_ins_id:
                    ins_id, item = item
                    out.write(f"{ins_id}\t")
                out.write(format_multislot_example(item, self.schema))
                out.write("\n")
                n += 1
        return n

    def run_from_stdin(self) -> None:
        """``cat raw | python my_generator.py`` as the dataset's
        pipe_command."""
        self.process(sys.stdin)
