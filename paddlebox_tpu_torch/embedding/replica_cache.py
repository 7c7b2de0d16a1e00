"""Replica caches and the string-keyed input table — the port of
``paddlebox_tpu/embedding/replica_cache.py``.

Reference (box_wrapper.h:140-248):

- ``GpuReplicaCache`` — a small embedding table mirrored whole into the
  card's memory (``ToHBM``) and read by the ``pull_cache_value`` op, for
  high-frequency features whose table fits on the card
  (FLAGS_use_gpu_replica_cache, flags.cc:486): :class:`ReplicaCache`
  and :func:`pull_cache_value`;
- ``InputTable`` — a CPU table mapping content-feature strings to dense
  indices (``LookupInput``): :class:`InputTable`.

:class:`TrainerReplicaCache` is the same idea on the TRAINING pull path
under ``flags.use_replica_cache``: the device tier above the spill
store's RAM cache, rebuilt at each pass boundary from the TierManager's
ranking, serving the feed manager's fresh keys from a plane on the card.
It stays bit-consistent with the store through the stale-key log and the
feed manager's ``note_written`` calls. The serving server keeps its own
count of live hot keys (``health()["hot_cached_keys"]``) and reads no
cache on a request, as the reference's server builds one and reads none.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device


class ReplicaCache:
    """Host-built cache mirrored whole onto the device (GpuReplicaCache).
    Row 0 is the null row; key → row translation is on the host."""

    def __init__(self, dim: int):
        self.dim = dim
        self._index: dict[int, int] = {}
        self._rows: list[np.ndarray] = [np.zeros(dim, np.float32)]
        self._device_table: torch.Tensor | None = None
        self._sorted_keys: np.ndarray | None = None  # translate() cache
        self._sorted_rows: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self._rows)

    @classmethod
    def from_keys_rows(cls, keys: np.ndarray, rows: np.ndarray
                       ) -> "ReplicaCache":
        """Bulk build: rows get ids 1.. in key order, row 0 stays null."""
        keys = np.asarray(keys).astype(np.uint64)
        rows = np.asarray(rows, np.float32)
        if len(keys) != len(rows):
            raise ValueError(
                f"keys ({len(keys)}) and rows ({len(rows)}) length "
                "mismatch")
        c = cls(dim=rows.shape[1] if rows.ndim == 2 else 0)
        if len(keys):
            c._index = {int(k): i + 1 for i, k in enumerate(keys.tolist())}
            if len(c._index) != len(keys):
                raise ValueError("duplicate keys in replica-cache build")
            c._rows = [np.zeros(c.dim, np.float32)] + list(rows)
        return c

    def add(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Install or overwrite rows on the host."""
        keys = np.asarray(keys).astype(np.uint64)
        values = np.asarray(values, np.float32)
        if keys.shape[0] != values.shape[0]:
            raise ValueError(
                f"keys ({keys.shape[0]}) and values ({values.shape[0]}) "
                "length mismatch")
        for k, v in zip(keys.tolist(), values):
            j = self._index.get(int(k), -1)
            if j < 0:
                self._index[int(k)] = len(self._rows)
                self._rows.append(v.copy())
            else:
                self._rows[j] = v.copy()
        self._device_table = None
        self._sorted_keys = None

    def translate(self, keys: np.ndarray) -> np.ndarray:
        """uint64 keys → int32 cache rows (0 for misses), on the host."""
        keys = np.asarray(keys).astype(np.uint64)
        if self._sorted_keys is None:
            ks = np.fromiter(self._index.keys(), np.uint64, len(self._index))
            rows = np.fromiter(self._index.values(), np.int32,
                               len(self._index))
            order = np.argsort(ks)
            self._sorted_keys = ks[order]
            self._sorted_rows = rows[order]
        flat = keys.reshape(-1)
        if len(self._sorted_keys):
            pos = np.minimum(np.searchsorted(self._sorted_keys, flat),
                             len(self._sorted_keys) - 1)
            hit = self._sorted_keys[pos] == flat
            out = np.where(hit, self._sorted_rows[pos], 0).astype(np.int32)
        else:
            out = np.zeros(flat.shape, np.int32)
        return out.reshape(keys.shape)

    def to_hbm(self, device: str | torch.device | None = None
               ) -> torch.Tensor:
        """The table on ``device`` (the card unless "cpu"; ToHBM,
        box_wrapper.h:159), copied once until the next ``add``."""
        dev = resolve_device(device)
        t = self._device_table
        if t is None or t.device != dev:
            t = torch.from_numpy(np.stack(self._rows)).to(dev)
            self._device_table = t
        return t


def pull_cache_value(cache_table: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """The ``pull_cache_value`` op: idx of any shape → idx.shape + (dim,)
    rows of the replicated table."""
    return cache_table.index_select(0, idx.reshape(-1).long()).reshape(
        *idx.shape, cache_table.shape[1])


class _ReplicaServe:
    """One serve()'s consistent answer: the hit mask over the asked keys,
    and the hit rows as host bytes (``rows``, the fill for quantized and
    compressed transfers) and as device-plane indices (``plane`` /
    ``src``, the fill on the card for plain f32). Taken under the
    replica lock, so a refresh never mixes generations."""

    __slots__ = ("hit", "rows", "plane", "src", "n")


class TrainerReplicaCache:
    """The trainer's replica hot tier (flags.use_replica_cache): the top
    of the disk → RAM → device hierarchy (GpuReplicaCache on the TRAINING
    pull path).

    ``refresh()`` (each pass boundary) takes the rows the spill store's
    TierManager holds in its RAM cache, keeps the ``capacity_rows``
    hottest by score, and copies them to a plane on ``device``. The feed
    manager then asks ``serve()`` for a pass's fresh keys: hits skip the
    RAM/disk fault path and fill the staged plane from the replica.

    Bit-consistency:
    - rows are read from the spill file (the authoritative tier) under
      the store lock, so replica bytes are store bytes at refresh time;
    - mutations outside the push cycle (shrink, delta replay, restore)
      enter the store's stale-key log; ``serve()`` folds
      ``stale_keys_since`` in before answering, and a log it cannot read
      (None) drops the whole replica;
    - ``store.write_back`` does not enter that log (it is the training
      push), so the feed manager calls ``note_written`` at every
      write-back site. Write-backs target keys of the previous pass and
      serves the fresh keys of the next, so the two cannot collide
      within one boundary.
    """

    def __init__(self, store, device: str | torch.device | None = None,
                 capacity_rows: int = 1 << 14):
        self.store = store
        self.device = resolve_device(device)
        self.capacity_rows = max(1, int(capacity_rows))
        self._row_width = int(store.cfg.row_width)
        self._lock = threading.Lock()
        self._keys = np.zeros(0, np.uint64)          # sorted
        self._rows = np.zeros((0, self._row_width), np.float32)
        self._valid = np.zeros(0, bool)
        self._marker = None          # store mutation marker at refresh
        self._plane: torch.Tensor | None = None
        self.replica_hits = 0        # cumulative
        self._stat_hits = 0          # batched → tiering.replica_hits
        self.refreshes = 0

    def __len__(self) -> int:
        return int(self._valid.sum())

    # ---- pass boundary (main thread) ----------------------------------

    def refresh(self) -> int:
        """Rebuild the replica from the tier's current ranking; returns
        its row count. Flushes the batched hit count first
        (``tiering.replica_hits``), so the hits a pass's staging recorded
        land in that pass's flight record; sets the
        ``tiering.replica_rows`` gauge and emits ``replica_refresh``. An
        untiered store has no ranking: the replica stays empty."""
        from paddlebox_tpu_torch.embedding import tiering as tiering_lib
        from paddlebox_tpu_torch.monitor import counter_add, event, gauge_set
        marker_fn = getattr(self.store, "mutation_marker", None)
        # the marker is taken BEFORE the harvest: a mutation landing
        # mid-harvest is re-checked by the next serve() — conservative
        marker = marker_fn() if marker_fn is not None else None
        ks: list[np.ndarray] = []
        rs: list[np.ndarray] = []
        sc: list[np.ndarray] = []
        for sub in tiering_lib._spill_subs(self.store):
            with sub._lock:
                live = sub._ctags[sub._ctags >= 0]
                if not live.size:
                    continue
                rid = np.unique(live)
                ks.append(sub._keys[rid])
                # from the memory map (authoritative), not the RAM cache
                # plane: the read perturbs no tier signal
                rs.append(np.array(sub._rows[rid], dtype=np.float32))
                sc.append(np.asarray(sub.tier.score(rid), np.float64))
        if ks:
            keys = np.concatenate(ks)
            rows = np.concatenate(rs)
            scores = np.concatenate(sc)
            if len(keys) > self.capacity_rows:
                top = np.argpartition(
                    -scores, self.capacity_rows - 1)[:self.capacity_rows]
                keys, rows = keys[top], rows[top]
            order = np.argsort(keys)
            keys = keys[order]
            rows = np.ascontiguousarray(rows[order])
            # the plane is built before the replica lock: the copy may
            # block, and serve() runs on the feed thread
            plane = torch.from_numpy(rows).to(self.device)
        else:
            keys = np.zeros(0, np.uint64)
            rows = np.zeros((0, self._row_width), np.float32)
            plane = None
        with self._lock:
            flush, self._stat_hits = self._stat_hits, 0
            self._keys, self._rows = keys, rows
            self._valid = np.ones(len(keys), bool)
            self._marker = marker if len(keys) else None
            self._plane = plane
        if flush:
            counter_add("tiering.replica_hits", flush)
        self.refreshes += 1
        n = len(keys)
        gauge_set("tiering.replica_rows", n)
        event("replica_refresh", rows=int(n), hits_flushed=int(flush))
        return n

    # ---- staging path (feed thread) -----------------------------------

    def serve(self, keys: np.ndarray) -> _ReplicaServe | None:
        """Answer a staging's fresh-key pull from the replica: the hit
        mask plus the hit rows. None = nothing to serve (empty or dropped
        replica, no hits, or a stale-key log that overflowed since the
        refresh, which drops everything)."""
        keys = np.asarray(keys).astype(np.uint64)
        marker = self._marker
        if len(keys) == 0 or marker is None:
            return None
        marker_fn = getattr(self.store, "mutation_marker", None)
        stale_fn = getattr(self.store, "stale_keys_since", None)
        if marker_fn is None or stale_fn is None:
            return None
        # the NEW marker before the staleness since the OLD one: a
        # mutation racing between the two calls is both invalidated now
        # and re-checked next serve. Store calls run outside the replica
        # lock (they take the store's own).
        new_marker = marker_fn()
        stale = stale_fn(marker)
        with self._lock:
            if self._marker != marker or not len(self._keys):
                return None          # a refresh swapped state mid-serve
            if stale is None:
                self._valid[:] = False
                self._marker = None
                return None
            if len(stale):
                pos = np.searchsorted(self._keys,
                                      np.asarray(stale, np.uint64))
                pos = np.minimum(pos, len(self._keys) - 1)
                m = self._keys[pos] == stale
                if m.any():
                    self._valid[pos[m]] = False
            self._marker = new_marker
            pos = np.searchsorted(self._keys, keys)
            pos = np.minimum(pos, len(self._keys) - 1)
            hit = (self._keys[pos] == keys) & self._valid[pos]
            n = int(hit.sum())
            if not n:
                return None
            self.replica_hits += n
            self._stat_hits += n
            out = _ReplicaServe()
            out.hit = hit
            out.n = n
            out.src = pos[hit].astype(np.int64)
            out.rows = self._rows[out.src]
            out.plane = self._plane
            return out

    def note_written(self, keys: np.ndarray) -> None:
        """Invalidate keys the feed manager just pushed through
        ``store.write_back``, the one mutation the stale-key log does
        not record."""
        keys = np.asarray(keys).astype(np.uint64)
        if len(keys) == 0 or not len(self._keys):
            return
        with self._lock:
            if not len(self._keys):
                return
            pos = np.searchsorted(self._keys, keys)
            pos = np.minimum(pos, len(self._keys) - 1)
            m = self._keys[pos] == keys
            if m.any():
                self._valid[pos[m]] = False


class InputTable:
    """CPU string → index table (LookupInput, box_wrapper.h:215):
    thread-safe append on miss; index 0 is the miss/padding index."""

    def __init__(self):
        self._index: dict[str, int] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._index)

    def lookup(self, tokens: list[str], insert: bool = True) -> np.ndarray:
        out = np.zeros(len(tokens), np.int32)
        with self._lock:
            for i, t in enumerate(tokens):
                j = self._index.get(t, 0)
                if j == 0 and insert:
                    j = len(self._index) + 1
                    self._index[t] = j
                out[i] = j
        return out
