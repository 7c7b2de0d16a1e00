"""Pass-scoped in-memory dataset — the port of ``data/dataset.py``.

One pass of training data held columnar in host memory: files are read
by a thread pool through the configured ingestion mode (text through
the native parser, a pipe command, a parser plugin, ``.pbar``
archives), concatenated, optionally shuffled on this host, unrolled by
the plugin's ``unroll`` hook, and handed to the trainer as the pass's
unique keys plus fixed-shape packed batches. ``preload_into_memory``
loads the next pass on a background thread while this one trains
(``wait_preload_done`` joins). In-memory transforms: ``slots_shuffle``
(feature ablation), ``merge_by_ins_id`` / ``merge_by_search_id`` and
``prepare_train`` / ``shard_batches``.

Each load leaves its numbers in ``last_load_stats`` and counts
``dataset.records_loaded`` / ``dataset.feasigns_loaded`` in the monitor,
as the JAX package does. With a ``shuffle_service``
(``data.shuffle.TcpShuffleService``) ``load_into_memory`` routes the
records between hosts (``routing``: random from the persistent shuffle
generator, or by ``ins_id`` / ``search_id``), exchanges them and draws
this host's permutation over what it received; without one, the global
shuffle is this host's permutation. ``member_shards`` and
``reroute_records`` are the elastic shrink's views of the records
(``distributed/resilience.py``).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
from typing import Iterator, Sequence

import numpy as np

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data.parser import ParseStats
from paddlebox_tpu_torch.data.reader import ParserPlugin, read_file
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import (PackedBatch,
                                                  SlotRecordBatch,
                                                  batch_iterator)
from paddlebox_tpu_torch.data.shuffle import (LocalShuffler, RoutingMode,
                                              TcpShuffleService,
                                              elastic_reroute,
                                              route_records)
from paddlebox_tpu_torch.monitor import counter_add as stat_add


def parse_threads_per_file(n_file_threads: int) -> int:
    """Native parser threads for each of ``n_file_threads`` concurrent
    file reads: the host's cores shared out, at least 1 (the parser's
    default, one thread per core for every call, would start cores x
    files threads). The parse result does not depend on it."""
    return max(1, (os.cpu_count() or 1) // max(1, n_file_threads))


class SlotDataset:
    """One pass of training data, held columnar in host memory."""

    def __init__(self, schema: DataFeedSchema,
                 shuffle_service: TcpShuffleService | None = None,
                 seed: int = 0):
        self.schema = schema
        self.filelist: list[str] = []
        self.pipe_command: str | None = None
        self.parser_plugin: ParserPlugin | None = None
        self.with_ins_id = False
        self.date: int | None = None
        # records are swapped by a preload thread while the trainer may
        # read them: every access goes through the lock
        self._lock = threading.Lock()
        self._records: SlotRecordBatch | None = None
        self._preload: concurrent.futures.Future | None = None
        self._shuffler = LocalShuffler(seed)
        self._service = shuffle_service
        # per-device slices set by prepare_train
        self._shards: list[SlotRecordBatch] = []
        self.last_load_stats: dict = {}

    @property
    def records(self) -> SlotRecordBatch | None:
        with self._lock:
            return self._records

    @records.setter
    def records(self, value: SlotRecordBatch | None) -> None:
        with self._lock:
            self._records = value

    # ---- configuration (the reference's BoxPSDataset API) ----

    def set_filelist(self, files: Sequence[str]) -> None:
        self.filelist = list(files)

    def set_pipe_command(self, cmd: str | None) -> None:
        self.pipe_command = cmd

    def set_parser_plugin(self, plugin: ParserPlugin | None) -> None:
        self.parser_plugin = plugin

    def set_date(self, date: int) -> None:
        self.date = date

    # ---- ingest ----

    def load_into_memory(self, global_shuffle: bool = True,
                         routing: RoutingMode = "random") -> None:
        """Read the filelist on ``flags.dataset_load_thread_num`` threads,
        in file order, each file's native parse on
        :func:`parse_threads_per_file` threads, then (``global_shuffle``)
        shuffle: across hosts by ``routing`` through the shuffle service
        when there is one, else this host's permutation."""
        t0 = time.perf_counter()
        n_threads = min(flags.dataset_load_thread_num,
                        max(1, len(self.filelist)))
        parse_threads = parse_threads_per_file(n_threads)
        stats = ParseStats()

        def read_one(path: str) -> SlotRecordBatch:
            return read_file(path, self.schema,
                             pipe_command=self.pipe_command,
                             parser_plugin=self.parser_plugin,
                             with_ins_id=self.with_ins_id, stats=stats,
                             parse_threads=parse_threads)

        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            parts = list(pool.map(read_one, self.filelist))
        parts = [p for p in parts if p.num > 0]
        batch = (SlotRecordBatch.concat(parts) if parts
                 else SlotRecordBatch.empty(self.schema))
        if global_shuffle and batch.num > 0:
            batch = self._global_shuffle(batch, routing)
        # the UnrollInstance hook: a parser plugin may carry an
        # `unroll(SlotRecordBatch) -> SlotRecordBatch` attribute (e.g.
        # expanding PV-merged page views back into instances), applied
        # once after load and shuffle
        unroll = getattr(self.parser_plugin, "unroll", None)
        if unroll is not None and batch.num > 0:
            batch = unroll(batch)
        self.records = batch
        feasigns = int(sum(len(v) for v in batch.sparse_values))
        # STAT_ADD counters, like data_feed's feasign stats
        stat_add("dataset.records_loaded", batch.num)
        stat_add("dataset.feasigns_loaded", float(feasigns))
        self.last_load_stats = {
            "files": len(self.filelist),
            "records": batch.num,
            "feasigns": feasigns,
            "seconds": time.perf_counter() - t0,
            "file_threads": n_threads,
            "parse_threads": parse_threads,
            **stats.as_dict()}
        if self._service is not None and global_shuffle:
            self.last_load_stats["exchange"] = dict(
                self._service.last_exchange)

    def _global_shuffle(self, batch: SlotRecordBatch,
                        routing: RoutingMode) -> SlotRecordBatch:
        if self._service is None:
            return self._shuffler.shuffle(batch)
        # random routing draws from the persistent shuffle generator, so
        # shuffle_state() checkpoints the routing decisions too
        routed = route_records(batch, self._service.world, routing,
                               rng=self._shuffler.rng)
        received = self._service.exchange(routed, self.schema)
        merged = (SlotRecordBatch.concat(received) if received
                  else SlotRecordBatch.empty(self.schema))
        return self._shuffler.shuffle(merged) if merged.num else merged

    def preload_into_memory(self, **kw) -> None:
        """Load the next pass on a background thread while this one
        trains (PreLoadIntoMemory); ``kw`` are load_into_memory's."""
        ex = concurrent.futures.ThreadPoolExecutor(1)
        self._preload = ex.submit(self.load_into_memory, **kw)
        ex.shutdown(wait=False)

    def wait_preload_done(self) -> None:
        """Join the preload; its error, if any, is raised here."""
        if self._preload is not None:
            fut, self._preload = self._preload, None
            fut.result()

    # ---- in-memory transforms ----

    def _loaded(self) -> SlotRecordBatch:
        records = self.records
        if records is None:
            raise RuntimeError("no records: call load_into_memory first")
        return records

    def local_shuffle(self) -> None:
        records = self.records
        if records is not None and records.num:
            self.records = self._shuffler.shuffle(records)

    def shuffle_state(self) -> dict:
        """The shuffle RNG cursor (JAX ``dataset.py:147``): the numpy
        bit-generator state, JSON-serializable and the same dict in both
        packages. A pass snapshot records it, so a resumed run draws the
        permutations the interrupted one would have."""
        return self._shuffler.state_dict()

    def set_shuffle_state(self, state: dict) -> None:
        self._shuffler.load_state_dict(state)

    def member_shards(self, world_size: int) -> list[SlotRecordBatch]:
        """Per-member slices of the current records, the round-robin
        split ``prepare_train`` uses, returned instead of stored. Every
        rank computes the same partition from the same shuffled records,
        so after a rank loss the survivors know which records the
        departed rank held without having talked to it."""
        r = self._loaded()
        return [r.select(np.arange(d, r.num, world_size))
                for d in range(world_size)]

    def reroute_records(self, batch: SlotRecordBatch, world_size: int
                        ) -> list[SlotRecordBatch | None]:
        """``batch`` re-routed over ``world_size`` survivors from the
        persistent shuffle generator (:meth:`shuffle_state`'s cursor):
        ``data.shuffle.elastic_reroute``."""
        return elastic_reroute(batch, world_size, self._shuffler.rng)

    def slots_shuffle(self, slot_names: Sequence[str], seed: int = 0) -> None:
        """Permute the values of the named sparse slots across examples
        (the reference's slots_shuffle, for feature-ablation eval): example
        i receives example perm[i]'s whole value list, one permutation per
        slot drawn from ``seed``."""
        rec = self.records
        if rec is None or rec.num == 0:
            return
        rng = np.random.default_rng(seed)
        sparse_names = [s.name for s in self.schema.sparse_slots]
        # resolve every name before mutating: an unknown slot must not
        # leave the records half-shuffled
        slot_idx = [sparse_names.index(name) for name in slot_names]
        for s in slot_idx:
            vals, offs = rec.sparse_values[s], rec.sparse_offsets[s]
            lens = offs[1:] - offs[:-1]
            perm = rng.permutation(rec.num)
            new_lens = lens[perm]
            new_offs = np.zeros(rec.num + 1, dtype=np.int64)
            np.cumsum(new_lens, out=new_offs[1:])
            total = int(new_offs[-1])
            # ragged gather: output position t inside example j reads
            # vals[offs[perm[j]] + (t - new_offs[j])]
            src_start = np.repeat(offs[:-1][perm], new_lens)
            local = (np.arange(total, dtype=np.int64)
                     - np.repeat(new_offs[:-1], new_lens))
            rec.sparse_values[s] = vals[src_start + local]
            rec.sparse_offsets[s] = new_offs

    def merge_by_ins_id(self, merge_size: int = 0) -> int:
        """Merge examples sharing an ins_id into one (MergeByInsId): sort
        by ins_id, group, and concatenate each group's sparse slot values
        member by member. With ``merge_size > 0`` groups of another size
        are dropped (the reference's strict mode, e.g. exactly one click
        log and one show log per instance). Float slots and metadata come
        from the group's first member. Returns the number of dropped
        examples."""
        r = self._loaded()
        if r.num == 0:
            return 0
        if not r.ins_id.any():
            raise ValueError(
                "merge_by_ins_id needs real instance ids; load with "
                "with_ins_id=True (all ins_id are 0 — merging would "
                "collapse the whole dataset into one group)")
        order = np.argsort(r.ins_id, kind="stable")
        ids = r.ins_id[order]
        starts = np.flatnonzero(
            np.concatenate([[True], ids[1:] != ids[:-1]]))
        sizes = np.diff(np.append(starts, len(ids)))
        keep = ((sizes == merge_size) if merge_size > 0
                else np.ones(len(starts), bool))
        dropped = int(sizes[~keep].sum())
        kept_starts, kept_sizes = starts[keep], sizes[keep]
        if not len(kept_starts):
            self.records = SlotRecordBatch.empty(self.schema)
            stat_add("dataset.merge_by_ins_id_dropped", dropped)
            return dropped
        # one ragged gather, then offsets sampled at group boundaries
        # (offsets are cumulative, so a group's span is the offsets at
        # its member boundaries)
        member_rows = np.concatenate(
            [order[st:st + sz] for st, sz in zip(kept_starts, kept_sizes)])
        picked = r.select(member_rows)
        bounds = np.concatenate([[0], np.cumsum(kept_sizes)])
        firsts = r.select(order[kept_starts])
        self.records = SlotRecordBatch(
            schema=r.schema, num=len(kept_starts),
            sparse_values=picked.sparse_values,
            sparse_offsets=[off[bounds] for off in picked.sparse_offsets],
            float_values=firsts.float_values,
            ins_id=firsts.ins_id, search_id=firsts.search_id,
            rank=firsts.rank, cmatch=firsts.cmatch)
        stat_add("dataset.merge_by_ins_id_dropped", dropped)
        return dropped

    def merge_by_search_id(self) -> np.ndarray:
        """Group examples into page views (the reference's MergePvInstance):
        reorders the records so same-search_id examples are adjacent and
        returns each example's group id (rank_attention builds its
        rank_offset from these)."""
        r = self._loaded()
        order = np.argsort(r.search_id, kind="stable")
        self.records = r.select(order)
        _, group = np.unique(self.records.search_id, return_inverse=True)
        return group

    # ---- hand-off to the trainers ----

    def unique_keys(self, device=None) -> np.ndarray:
        """The pass's feature-sign working set (sorted on ``device`` when
        it is a CUDA card: ``SlotRecordBatch.unique_keys``)."""
        return self._loaded().unique_keys(device)

    def prepare_train(self, num_shards: int) -> None:
        """Slice the records round-robin into per-device shards
        (PadBoxSlotDataset::PrepareTrain)."""
        r = self._loaded()
        self._shards = [r.select(np.arange(d, r.num, num_shards))
                        for d in range(num_shards)]

    def shard_batches(self, shard: int, batch_size: int | None = None,
                      drop_last: bool = True) -> Iterator[PackedBatch]:
        bs = batch_size or self.schema.batch_size
        return batch_iterator(self._shards[shard], bs, drop_last=drop_last)

    def batches(self, batch_size: int | None = None,
                drop_last: bool = True) -> Iterator[PackedBatch]:
        bs = batch_size or self.schema.batch_size
        return batch_iterator(self._loaded(), bs, drop_last=drop_last)

    @property
    def num_examples(self) -> int:
        records = self.records
        return 0 if records is None else records.num

    def release_memory(self) -> None:
        self.records = None
        self._shards = []
