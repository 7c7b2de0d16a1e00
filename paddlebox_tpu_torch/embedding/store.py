"""Host-tier embedding store — the port of ``HostEmbeddingStore``.

Between passes every row lives here, in host memory: a batch KeyIndex
over one growing float32 rows array. The device only ever holds a pass's
working set (``working_set.py``). New keys get a deterministic splitmix
row init — bit-identical to the JAX package's, so the same key gets the
same initial row in both. Checkpointing (``save_base``/``save_delta``)
and shrink are not ported yet (ROADMAP).
"""

from __future__ import annotations

import threading

import numpy as np

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native.key_index import KeyIndex


class HostEmbeddingStore:
    _GROW = 1.5

    def __init__(self, cfg: EmbeddingConfig, initial_capacity: int = 1024):
        self.cfg = cfg
        self._index = KeyIndex(initial_capacity)
        self._keys = np.zeros(initial_capacity, dtype=np.uint64)
        self._rows = np.zeros((initial_capacity, cfg.row_width), np.float32)
        self._n = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    def _init_rows(self, keys: np.ndarray) -> np.ndarray:
        """Hash-based uniform init in [-initial_range, initial_range) of
        the embedx columns: same key → same row on every host."""
        cfg = self.cfg
        rows = np.zeros((len(keys), cfg.row_width), dtype=np.float32)
        if cfg.total_dim:
            k = keys.astype(np.uint64)[:, None]
            j = np.arange(cfg.total_dim, dtype=np.uint64)[None, :]
            with np.errstate(over="ignore"):
                z = (k * np.uint64(0x9E3779B97F4A7C15)
                     + (j + np.uint64(cfg.seed))
                     * np.uint64(0xBF58476D1CE4E5B9))
                z ^= z >> np.uint64(30)
                z *= np.uint64(0x94D049BB133111EB)
                z ^= z >> np.uint64(27)
            u = (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)
            rows[:, cfg.embedx_cols] = ((2.0 * u - 1.0)
                                        * cfg.initial_range).astype(np.float32)
        return rows

    def lookup_or_init(self, keys: np.ndarray) -> np.ndarray:
        """Rows for ``keys``, creating fresh rows for unseen keys (called
        by the pass builder, not per batch)."""
        keys = np.asarray(keys).astype(np.uint64)
        with self._lock:
            idx, added = self._index.lookup_or_insert(keys)
            if added:
                # new ids are sequential from the old size, first-occurrence
                # order: append their keys and init rows in id order
                new_pos = np.flatnonzero(idx >= self._n)
                _, take = np.unique(idx[new_pos], return_index=True)
                new_keys = keys[new_pos[take]]
                self._reserve(self._n + added)
                self._keys[self._n:self._n + added] = new_keys
                self._rows[self._n:self._n + added] = \
                    self._init_rows(new_keys)
                self._n += added
            return self._rows[idx].copy()

    def write_back(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Persist updated rows after a pass (EndPass)."""
        keys = np.asarray(keys).astype(np.uint64)
        with self._lock:
            idx = self._lookup_strict(keys)
            self._rows[idx] = np.asarray(rows, dtype=np.float32)

    def peek_rows(self, keys: np.ndarray) -> np.ndarray:
        """Rows without creating missing ones: unseen keys get their
        deterministic init row but are not inserted."""
        keys = np.asarray(keys).astype(np.uint64)
        rows = self._init_rows(keys)
        with self._lock:
            idx = self._index.lookup(keys)
            hit = idx >= 0
            rows[hit] = self._rows[idx[hit]]
        return rows

    def _lookup_strict(self, keys: np.ndarray) -> np.ndarray:
        idx = self._index.lookup(keys)
        if len(idx) and idx.min() < 0:
            raise KeyError(int(keys[idx < 0][0]))
        return idx

    def _reserve(self, need: int) -> None:
        cap = len(self._keys)
        if need <= cap:
            return
        new_cap = max(need, int(cap * self._GROW))
        self._keys = np.resize(self._keys, new_cap)
        rows = np.zeros((new_cap, self.cfg.row_width), np.float32)
        rows[:self._n] = self._rows[:self._n]
        self._rows = rows
