"""Pass-scoped in-memory dataset — the port of ``data/dataset.py``.

One pass of training data held columnar in host memory: files are parsed
by a thread pool, concatenated, optionally shuffled on this host, and
handed to the trainer as the pass's unique keys plus fixed-shape packed
batches. ``preload_into_memory`` loads the next pass on a background
thread while this one trains (``wait_preload_done`` joins), so its keys
exist for ``Trainer.train_pass(preload_keys=...)``. Cross-host shuffling
(the TCP shuffle service) is not ported yet;
``load_into_memory(global_shuffle=True)`` on one host is the same local
permutation the JAX package draws when it has no service.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Iterator, Sequence

import numpy as np

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data.reader import read_file
from paddlebox_tpu_torch.data.schema import DataFeedSchema
from paddlebox_tpu_torch.data.slot_record import (PackedBatch,
                                                  SlotRecordBatch,
                                                  batch_iterator)


class LocalShuffler:
    """Single-host shuffle: a permutation from a persistent generator."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def shuffle(self, batch: SlotRecordBatch) -> SlotRecordBatch:
        return batch.shuffle(self.rng)

    def state_dict(self) -> dict:
        return self.rng.bit_generator.state

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state


class SlotDataset:
    """One pass of training data, held columnar in host memory."""

    def __init__(self, schema: DataFeedSchema, seed: int = 0):
        self.schema = schema
        self.filelist: list[str] = []
        # records are swapped by a preload thread while the trainer may
        # read them: every access goes through the lock
        self._lock = threading.Lock()
        self._records: SlotRecordBatch | None = None
        self._preload: concurrent.futures.Future | None = None
        self._shuffler = LocalShuffler(seed)

    @property
    def records(self) -> SlotRecordBatch | None:
        with self._lock:
            return self._records

    @records.setter
    def records(self, value: SlotRecordBatch | None) -> None:
        with self._lock:
            self._records = value

    def set_filelist(self, files: Sequence[str]) -> None:
        self.filelist = list(files)

    def load_into_memory(self, global_shuffle: bool = True) -> None:
        n_threads = min(flags.dataset_load_thread_num,
                        max(1, len(self.filelist)))
        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            parts = list(pool.map(self._read_one, self.filelist))
        parts = [p for p in parts if p.num > 0]
        batch = (SlotRecordBatch.concat(parts) if parts
                 else SlotRecordBatch.empty(self.schema))
        if global_shuffle and batch.num > 0:
            batch = self._shuffler.shuffle(batch)
        self.records = batch

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

    def _read_one(self, path: str) -> SlotRecordBatch:
        return read_file(path, self.schema)

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

    def unique_keys(self) -> np.ndarray:
        """The pass's feature-sign working set."""
        records = self.records
        if records is None:
            raise RuntimeError("unique_keys before load_into_memory")
        return records.unique_keys()

    def batches(self, batch_size: int | None = None,
                drop_last: bool = True) -> Iterator[PackedBatch]:
        records = self.records
        if records is None:
            raise RuntimeError("batches before load_into_memory")
        bs = batch_size or self.schema.batch_size
        return batch_iterator(records, bs, drop_last=drop_last)

    @property
    def num_examples(self) -> int:
        records = self.records
        return 0 if records is None else records.num
