"""File readers — the port of ``data/reader.py``: the three ingestion
modes of SlotPaddleBoxDataFeed, plus pre-tokenized archives.

- a ``.pbar`` archive (``data/archive.py``) loads its columns as they
  are, with no parse;
- a ``pipe_command`` runs as ``{cmd} < {path}`` in a shell (the path
  quoted) and its stdout is MultiSlot text;
- a parser plugin is any callable ``(iter[str], DataFeedSchema) ->
  SlotRecordBatch``, registered by module path (``"pkg.mod:func"``,
  :func:`load_parser_plugin`);
- otherwise the file's own bytes are MultiSlot text (gzip when the name
  ends in ``.gz``).

Remote paths (a ``scheme://`` other than ``file://``) raise
``RemoteFSNotPorted``: remote filesystems, and the pipe feed thread that
streams a remote file into a command's stdin, are not ported yet
(ROADMAP, queue 1 item 5).
"""

from __future__ import annotations

import gzip
import importlib
import shlex
import subprocess
from typing import Callable, Iterable, Iterator

from paddlebox_tpu_torch.data.archive import read_archive
from paddlebox_tpu_torch.data.parser import ParseStats, parse_multislot_buffer
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.utils import fs as fs_lib

ParserPlugin = Callable[[Iterable[str], DataFeedSchema], SlotRecordBatch]


def _local(path: str) -> str:
    """The local path of ``path`` (``file://`` stripped); a remote path
    raises RemoteFSNotPorted."""
    if fs_lib.is_remote(path):
        raise fs_lib.RemoteFSNotPorted(path)
    return fs_lib.resolve(path)[1]


def open_lines(path: str) -> Iterator[str]:
    """Stream the text lines of a local file (gzip when ``.gz``)."""
    local = _local(path)
    if path.endswith(".gz"):
        with gzip.open(local, "rt", encoding="utf-8",
                       errors="replace") as f:
            yield from f
        return
    with open(local, "rb") as raw:
        for line in raw:
            yield line.decode("utf-8", errors="replace")


def load_parser_plugin(spec: str) -> ParserPlugin:
    """Resolve ``"package.module:callable"`` (``:parse`` by default) —
    the counterpart of the reference's dlopen'd ``ISlotParser``."""
    mod_name, _, attr = spec.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr or "parse")
    if not callable(fn):
        raise TypeError(f"parser plugin {spec!r} is not callable")
    return fn


def read_file(path: str, schema: DataFeedSchema,
              pipe_command: str | None = None,
              parser_plugin: ParserPlugin | None = None,
              with_ins_id: bool = False, stats: ParseStats | None = None,
              parse_threads: int = 0) -> SlotRecordBatch:
    """Read one file into a columnar batch through the configured
    ingestion mode. ``stats`` collects the parse counters;
    ``parse_threads`` is the native parser's thread count (0 = one per
    hardware thread)."""
    if path.endswith(".pbar"):
        return read_archive(_local(path), schema)
    if pipe_command:
        # quoted: a path with spaces or shell metacharacters stays one
        # redirect target
        cmd = (f"{pipe_command} < {shlex.quote(_local(path))}" if path
               else pipe_command)
        proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        try:
            buf = proc.stdout.read()
        finally:
            proc.stdout.close()
            ret = proc.wait()
        if ret != 0:
            raise RuntimeError(f"pipe_command {pipe_command!r} exited {ret}")
        return parse_multislot_buffer(buf, schema, with_ins_id=with_ins_id,
                                      stats=stats, n_threads=parse_threads)
    if parser_plugin is not None:
        return parser_plugin(open_lines(path), schema)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(_local(path), "rb") as f:
        buf = f.read()
    return parse_multislot_buffer(buf, schema, with_ins_id=with_ins_id,
                                  stats=stats, n_threads=parse_threads)
