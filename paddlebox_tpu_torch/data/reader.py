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

A remote path (a ``scheme://`` registered with ``utils.fs``, e.g. through
``init_afs_api``) reads through its filesystem in every mode: text
streams over the filesystem's ``cat``; a ``.pbar`` archive is fetched to
a temp dir first (npz wants a seekable file); under a ``pipe_command``
a feed thread streams the remote bytes into the command's stdin while
this thread reads its stdout, so neither pipe buffer filling can
deadlock the pair (the reference's HDFS reads ride the pipe the same
way).
"""

from __future__ import annotations

import gzip
import importlib
import os
import shlex
import shutil
import subprocess
import tempfile
from typing import Callable, Iterable, Iterator

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.data.archive import read_archive
from paddlebox_tpu_torch.data.parser import ParseStats, parse_multislot_buffer
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.utils import fs as fs_lib

ParserPlugin = Callable[[Iterable[str], DataFeedSchema], SlotRecordBatch]


def open_lines(path: str) -> Iterator[str]:
    """Stream the text lines of a local or remote file (gzip when
    ``.gz``)."""
    fs, p = fs_lib.resolve(path)
    raw = fs.open_read(p)
    try:
        if path.endswith(".gz"):
            with gzip.open(raw, "rt", encoding="utf-8",
                           errors="replace") as f:
                yield from f
        else:
            for line in raw:
                yield line.decode("utf-8", errors="replace")
    finally:
        raw.close()


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
    remote = bool(path) and fs_lib.is_remote(path)
    if path.endswith(".pbar"):
        fs, p = fs_lib.resolve(path)
        if not remote:
            return read_archive(p, schema)
        with tempfile.TemporaryDirectory(prefix="pbt_pbar_") as d:
            local = os.path.join(d, os.path.basename(p))
            fs.get(p, local)
            return read_archive(local, schema)
    if pipe_command:
        buf = (_pipe_remote(path, pipe_command) if remote
               else _pipe_local(path, pipe_command))
        return parse_multislot_buffer(buf, schema, with_ins_id=with_ins_id,
                                      stats=stats, n_threads=parse_threads)
    if parser_plugin is not None:
        return parser_plugin(open_lines(path), schema)
    fs, p = fs_lib.resolve(path)
    if remote:
        with fs.open_read(p) as f:
            buf = f.read()
        if path.endswith(".gz"):
            buf = gzip.decompress(buf)
    else:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(p, "rb") as f:
            buf = f.read()
    return parse_multislot_buffer(buf, schema, with_ins_id=with_ins_id,
                                  stats=stats, n_threads=parse_threads)


def _pipe_local(path: str, pipe_command: str) -> bytes:
    """``{cmd} < {path}`` in a shell (the path quoted: spaces or shell
    metacharacters stay one redirect target); its stdout."""
    cmd = (f"{pipe_command} < {shlex.quote(fs_lib.resolve(path)[1])}"
           if path else pipe_command)
    proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
    try:
        buf = proc.stdout.read()
    finally:
        proc.stdout.close()
        ret = proc.wait()
    if ret != 0:
        raise RuntimeError(f"pipe_command {pipe_command!r} exited {ret}")
    return buf


def _pipe_remote(path: str, pipe_command: str) -> bytes:
    """A remote file streamed into ``pipe_command``'s stdin by a feed
    thread while this thread reads its stdout: writing all of stdin
    before reading stdout deadlocks once either pipe buffer fills. A
    consumer that exits early (a sampling ``head``) is not an error; a
    failed read of the remote file is, after the command ends."""
    fs, p = fs_lib.resolve(path)
    src = fs.open_read(p)
    proc = subprocess.Popen(pipe_command, shell=True, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE)
    feed_err: list = []

    def feed():
        try:
            try:
                shutil.copyfileobj(src, proc.stdin)
            # pblint: disable=silent-except -- the consumer exited early
            # (a sampling command closes the pipe after enough bytes):
            # by design not an error, nothing to count
            except BrokenPipeError:
                pass
            except BaseException as e:      # surfaced after the read
                feed_err.append(e)
        finally:
            try:
                proc.stdin.close()
            except Exception as e:
                # a teardown failure of the pipe is not fatal (it may be
                # broken already) but never invisible
                monitor.counter_add("reader.close_errors")
                monitor.event("reader_close_error", path=path,
                              error=repr(e)[:200])
            try:
                # the remote cat's exit status: a truncated read must not
                # parse as a short success
                src.close()
            except Exception as e:
                feed_err.append(e)

    feeder = mon_ctx.spawn(feed, name="pbt-pipe-feed")
    feeder.start()
    try:
        buf = proc.stdout.read()
    finally:
        proc.stdout.close()
        ret = proc.wait()
        feeder.join()
    if feed_err:
        raise RuntimeError(f"remote read of {path} into pipe_command "
                           f"{pipe_command!r} failed") from feed_err[0]
    if ret != 0:
        raise RuntimeError(f"pipe_command {pipe_command!r} exited {ret}")
    return buf
