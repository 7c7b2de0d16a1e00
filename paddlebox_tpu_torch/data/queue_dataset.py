"""Streaming dataset — the port of ``data/queue_dataset.py``.

The reference's ``QueueDataset`` streams files through bounded channels
straight to the trainers: one epoch, no global shuffle, memory bounded
by the channel's capacity rather than by the pass. Here reader threads
parse files into columnar chunks that feed a bounded queue, and the
consumer stitches chunks into fixed-size ``PackedBatch``es across file
boundaries. Memory high-water: ``queue_capacity`` chunks plus one batch
remainder.

A pass's unique keys are not known up front when streaming, so a
QueueDataset feeds ``train.heter.HeterTrainer`` (the table stays in the
host store; no pass working set), as in the reference, where
QueueDataset is the CPU-trainer mode.

Each finished stream leaves its numbers in ``last_stream_stats``; the
reader threads count ``queue_dataset_examples`` in the monitor, as the
JAX package's do, and are spawned with the caller's pass context.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from paddlebox_tpu_torch.data.dataset import parse_threads_per_file
from paddlebox_tpu_torch.data.parser import ParseStats
from paddlebox_tpu_torch.data.reader import ParserPlugin, read_file
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import PackedBatch, SlotRecordBatch
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor import counter_add as stat_add

_STOP = object()


class QueueDataset:
    """Bounded-memory streaming over a filelist."""

    def __init__(self, schema: DataFeedSchema, num_threads: int = 2,
                 queue_capacity: int = 8):
        self.schema = schema
        self.filelist: list[str] = []
        self.pipe_command: str | None = None
        self.parser_plugin: ParserPlugin | None = None
        self.with_ins_id = False
        self.num_threads = max(1, num_threads)
        self.queue_capacity = queue_capacity
        self.last_stream_stats: dict = {}

    # ---- configuration ----
    def set_filelist(self, files: Sequence[str]) -> None:
        self.filelist = list(files)

    def set_pipe_command(self, cmd: str | None) -> None:
        self.pipe_command = cmd

    def set_parser_plugin(self, plugin: ParserPlugin | None) -> None:
        self.parser_plugin = plugin

    # ---- streaming ----
    def _chunks(self, files: Sequence[str]) -> Iterator[SlotRecordBatch]:
        """Parse ``files`` on reader threads; yield columnar chunks in
        completion order (with one thread: file order).

        A reader's error is raised to the consumer once the others stop.
        Abandoning the iterator (break, close) cancels the readers: their
        puts wait in short slices, so a reader blocked on the full queue
        sees the cancel, and every thread is joined before the generator
        returns."""
        q: queue.Queue = queue.Queue(maxsize=self.queue_capacity)
        it = iter(files)
        it_lock = threading.Lock()
        cancel = threading.Event()
        errors: list[BaseException] = []
        n = min(self.num_threads, max(1, len(files)))
        stats = ParseStats()
        parse_threads = parse_threads_per_file(n)
        records = [0]

        def _put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                while not cancel.is_set():
                    with it_lock:
                        path = next(it, None)
                    if path is None:
                        break
                    chunk = read_file(path, self.schema,
                                      pipe_command=self.pipe_command,
                                      parser_plugin=self.parser_plugin,
                                      with_ins_id=self.with_ins_id,
                                      stats=stats,
                                      parse_threads=parse_threads)
                    with it_lock:
                        records[0] += chunk.num
                    stat_add("queue_dataset_examples", chunk.num)
                    if not _put(chunk):
                        return
            except BaseException as e:  # raised on the consumer side
                errors.append(e)
            finally:
                # the sentinel must always land: after a cancel the
                # consumer drains until it has every thread's
                _put(_STOP) or q.put(_STOP)

        threads = [mon_ctx.spawn(worker, name="pbt-queue-reader")
                   for _ in range(n)]
        for t in threads:
            t.start()
        done = 0
        try:
            while done < n:
                item = q.get()
                if item is _STOP:
                    done += 1
                    continue
                yield item
        finally:
            cancel.set()
            # unblock any reader stuck on a full queue, then reap
            while done < n:
                if q.get() is _STOP:
                    done += 1
            for t in threads:
                t.join()
            self.last_stream_stats = {
                "files": len(files), "records": records[0],
                "reader_threads": n, "parse_threads": parse_threads,
                **stats.as_dict()}
        if errors:
            raise errors[0]

    def batches(self, batch_size: int | None = None,
                drop_last: bool = True,
                files: Sequence[str] | None = None
                ) -> Iterator[PackedBatch]:
        """Stream fixed-size PackedBatches; chunk remainders are stitched
        across file boundaries."""
        bs = batch_size or self.schema.batch_size
        pending: list[SlotRecordBatch] = []
        have = 0
        for chunk in self._chunks(self.filelist if files is None else files):
            pending.append(chunk)
            have += chunk.num
            if have < bs:
                continue
            # one concat per stitch group, then a sliding pack cursor;
            # only the < bs tail is re-materialized
            merged = SlotRecordBatch.concat(pending)
            off = 0
            while off + bs <= merged.num:
                yield merged.pack(off, off + bs)
                off += bs
            have = merged.num - off
            pending = ([merged.select(np.arange(off, merged.num))]
                       if have else [])
        if have and not drop_last:
            merged = SlotRecordBatch.concat(pending)
            yield merged.pack(0, merged.num)

    def shard_batches(self, shard: int, num_shards: int,
                      batch_size: int | None = None,
                      drop_last: bool = True) -> Iterator[PackedBatch]:
        """File-level sharding for multi-worker streaming: whole files
        round-robin to the shards."""
        files = [f for i, f in enumerate(self.filelist)
                 if i % num_shards == shard]
        return self.batches(batch_size, drop_last, files=files)
