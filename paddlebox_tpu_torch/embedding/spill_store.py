"""Disk spill tier for the host embedding store — the port of
``paddlebox_tpu/embedding/spill_store.py``.

PaddleBox's table lives across SSD, host DRAM and device memory:
``LoadSSD2Mem`` pulls a pass's range up before the pass and the
working-set build reads from there (box_wrapper.h:487-494).
:class:`SpillEmbeddingStore` is ``HostEmbeddingStore`` with its row array
replaced by a **memory-mapped row file** (the disk tier, bounded by disk)
under a fixed **set-associative RAM row cache** (the host-DRAM hot tier).
Reads come from the cache when warm and fault in from the file
otherwise; writes go through to the file (the authoritative tier) and
install into the cache.

Geometry (``flags.spill_cache_assoc`` ways, default 4): ``n_sets =
cache_rows // assoc`` sets, ``set = row_id % n_sets``. Placement within
a set is the tier manager's (``tiering.TierManager``): the victim is
the set's coldest way by the show-weighted score (empty ways first) and
the candidate must reach the victim's score, re-scored at every pass
boundary (``tier_end_pass``). ``tier_policy="direct"`` keeps the 1-way
always-install geometry as the baseline; ``assoc=1`` under ``freq``
places rows exactly as a direct-mapped cache (``slot = row_id %
cache_rows``).

Checkpointing: base and delta payloads **stream from the memory map in
bounded chunks** (``_write_rows_npz``; the row plane never materializes
in RAM) behind the ``tiering.save.pre_flush`` fault window, and read
back with ``np.load`` exactly as ``np.savez_compressed`` output does, so
chains load in either package and in either store class. The key
index, dirty and tombstone tracking, manifests, load, shrink and flush
hooks are inherited; the two stores give bit-equal rows under the same
operations. The counters ``cache_hits``, ``cache_misses``,
``conflict_misses`` and ``fault_in_seconds`` are attributes; each pass
boundary (``tier_end_pass``) also flushes the pass's counts into the
monitor under the reference's names (``tiering.admitted`` /
``evicted`` / ``conflict_misses``, ``spill.cache_hits`` / ``cache_misses``
/ ``prefetched_rows``, the ``tiering.hot_rows`` / ``spill_bytes``
gauges), so they land in that pass's flight record.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import time
import zipfile

import numpy as np
from numpy.lib import format as npy_format

from paddlebox_tpu_torch.config import flags as config_flags
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.tiering import TierManager
from paddlebox_tpu_torch.monitor import counter_add, gauge_set
from paddlebox_tpu_torch.utils import faultpoint

# rows per chunk of a streamed base/delta payload: bounds the resident
# footprint of a checkpoint save to chunk * row_width * 4 bytes
_STREAM_CHUNK_ROWS = 1 << 16


def _write_rows_npz(f, keys: np.ndarray, rows_src, idx: np.ndarray | None,
                    n_rows: int, removed: np.ndarray | None = None) -> None:
    """np.savez_compressed-compatible archive (members ``keys.npy`` /
    ``rows.npy`` [/ ``removed.npy``]) with the row plane streamed from
    ``rows_src`` (the memmap) in bounded chunks — ``idx=None`` streams
    the leading ``n_rows`` rows (base), an index vector gathers the
    dirty rows chunk by chunk (delta). ``np.load`` reads it exactly like
    the savez output it replaces."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED) as zf:
        small = [("keys.npy", np.ascontiguousarray(keys))]
        if removed is not None:
            small.append(("removed.npy", np.ascontiguousarray(removed)))
        for name, arr in small:
            # force_zip64 on EVERY member, like np.savez does: a >4GiB
            # keys plane (~537M uint64 keys — the scale this tier is
            # for) would otherwise abort the save at member close
            with zf.open(name, "w", force_zip64=True) as m:
                npy_format.write_array(m, arr, allow_pickle=False)
        with zf.open("rows.npy", "w", force_zip64=True) as m:
            npy_format.write_array_header_1_0(
                m, {"descr": npy_format.dtype_to_descr(
                        np.dtype(np.float32)),
                    "fortran_order": False,
                    "shape": (int(n_rows), int(rows_src.shape[1]))})
            for lo in range(0, int(n_rows), _STREAM_CHUNK_ROWS):
                hi = min(int(n_rows), lo + _STREAM_CHUNK_ROWS)
                chunk = (rows_src[lo:hi] if idx is None
                         else rows_src[idx[lo:hi]])
                m.write(np.ascontiguousarray(
                    chunk, dtype=np.float32).tobytes())


class SpillEmbeddingStore(HostEmbeddingStore):
    _rows_persistent = True    # the row file keeps its bytes across grows

    def __init__(self, cfg: EmbeddingConfig, spill_dir: str | None = None,
                 cache_rows: int = 1 << 16, initial_capacity: int = 1024,
                 tier_policy: str = "freq", cache_assoc: int | None = None):
        self._spill_dir = spill_dir or tempfile.mkdtemp(prefix="pbtpu_spill_")
        os.makedirs(self._spill_dir, exist_ok=True)
        self._rows_path = os.path.join(self._spill_dir, "rows.dat")
        # set-associative geometry: row_id % n_sets picks the SET, the
        # tier manager picks the way within it. cache_assoc=None resolves
        # to flags.spill_cache_assoc for the freq policy and to 1 for
        # "direct" (the measured direct-mapped baseline keeps its legacy
        # geometry at the same total budget).
        if cache_assoc is None:
            cache_assoc = (1 if tier_policy == "direct"
                           else max(1, int(config_flags.spill_cache_assoc)))
        self._init_geometry(cache_rows, cache_assoc, cfg.row_width)
        self.cache_hits = 0
        self.cache_misses = 0
        # misses whose whole set was live — the geometry's share of the
        # miss rate (a bigger budget would NOT have helped; more ways
        # would)
        self.conflict_misses = 0
        # cumulative wall seconds spent faulting rows in from the disk
        # tier (the memmap read below) — the feed manager diffs it across
        # a boundary for the spill_fault_in share of its split
        self.fault_in_seconds = 0.0
        # this pass's hit / miss / conflict counts, handed back and reset
        # by tier_end_pass (the autotune's window), and the rows this
        # pass's prefetches advised
        self._stat_prefetched = 0
        self._stat_hits = 0
        self._stat_misses = 0
        self._stat_conflicts = 0
        self.tier = TierManager(max(initial_capacity, 1),
                                policy=tier_policy)
        super().__init__(cfg, initial_capacity)

    def _init_geometry(self, cache_rows: int, assoc: int,
                       row_width: int) -> None:
        """(Re)shape the cache plane: ``n_sets`` sets of ``assoc`` ways,
        set-major layout (``slot = set * assoc + way``). The total slot
        count rounds DOWN to a whole number of sets so every set has
        exactly ``assoc`` ways; ``assoc=1`` degenerates to the legacy
        direct-mapped ``slot = row_id % cache_rows``."""
        budget = max(1, int(cache_rows))
        self._assoc = max(1, min(int(assoc), budget))
        self._n_sets = max(1, budget // self._assoc)
        self._cache_slots = self._n_sets * self._assoc
        self._ctags = np.full(self._cache_slots, -1, dtype=np.int64)
        self._cdata = np.zeros((self._cache_slots, row_width),
                               dtype=np.float32)

    def _probe(self, idx: np.ndarray):
        """(hit, slot, set_full): multi-way tag probe. ``slot`` holds the
        matching way's slot at hit positions (undefined at misses);
        ``set_full`` marks rows whose whole set is live — a miss there is
        a conflict miss."""
        base = (idx % self._n_sets) * self._assoc
        if self._assoc == 1:
            tags = self._ctags[base]
            hit = tags == idx
            return hit, base, tags >= 0
        cand = base[:, None] + np.arange(self._assoc, dtype=np.int64)
        tags = self._ctags[cand]
        match = tags == idx[:, None]
        hit = match.any(axis=1)
        slot = base + match.argmax(axis=1)
        return hit, slot, (tags >= 0).all(axis=1)

    # ---- storage hooks -------------------------------------------------

    def _alloc_rows(self, capacity: int) -> np.memmap:
        w = self.cfg.row_width
        nbytes = capacity * w * 4
        # grow the backing file (existing bytes are preserved; new bytes
        # read as zeros), then remap at the larger shape
        with open(self._rows_path, "ab") as f:
            pass
        cur = os.path.getsize(self._rows_path)
        if cur < nbytes:
            with open(self._rows_path, "r+b") as f:
                f.truncate(nbytes)
        self.tier.ensure_capacity(capacity)
        return np.memmap(self._rows_path, dtype=np.float32, mode="r+",
                         shape=(capacity, w))

    def _victim_slots(self, idx: np.ndarray) -> np.ndarray:
        """Per candidate, the slot it would install into: its set's ways
        in victim-priority order — empty ways first, then occupants
        coldest-first by tier score — with batch-internal candidates of
        the same set spread across successive priority ranks, so one
        batch can fill a whole set instead of contending for its first
        empty way (``assoc=1``: the single candidate slot, i.e. the
        legacy direct-mapped victim)."""
        base = (idx % self._n_sets) * self._assoc
        if self._assoc == 1:
            return base
        cand = base[:, None] + np.arange(self._assoc, dtype=np.int64)
        tags = self._ctags[cand]
        occ = tags >= 0
        scores = np.where(occ, self.tier.score(np.where(occ, tags, 0)),
                          -np.inf)
        # per-set victim priority: ways sorted empty-first then coldest
        # (stable, so ties keep way order)
        order = np.argsort(scores, axis=1, kind="stable")
        # occurrence rank of each candidate within its set in THIS batch
        set_id = base // self._assoc
        sort = np.argsort(set_id, kind="stable")
        ss = set_id[sort]
        starts = np.flatnonzero(np.r_[True, ss[1:] != ss[:-1]])
        runs = np.diff(np.r_[starts, len(ss)])
        rank = np.empty(len(idx), np.int64)
        rank[sort] = np.arange(len(ss)) - np.repeat(starts, runs)
        way = order[np.arange(len(idx)), rank % self._assoc]
        return base + way

    def _install(self, idx: np.ndarray, rows: np.ndarray) -> None:
        """Frequency-aware cache install: each candidate contests its
        set's victim way's occupant through the tier manager (ties →
        the newcomer, a strictly hotter resident stays)."""
        slot = self._victim_slots(idx)
        adm = self.tier.admit(idx, self._ctags[slot])
        if not adm.any():
            return
        s_a, i_a, r_a = slot[adm], idx[adm], rows[adm]
        if len(s_a) > 1:
            # batch-internal slot collisions: the LAST admitted
            # candidate per slot wins, and the counters count each slot
            # once (not once per colliding candidate)
            uniq, rev = np.unique(s_a[::-1], return_index=True)
            pos = len(s_a) - 1 - rev
            s_a, i_a, r_a = s_a[pos], i_a[pos], r_a[pos]
        self.tier.count_install(len(s_a),
                                int((self._ctags[s_a] >= 0).sum()))
        self._ctags[s_a] = i_a
        self._cdata[s_a] = r_a

    def _read_rows(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        out = np.empty((len(idx), self.cfg.row_width), dtype=np.float32)
        hit, slot, set_full = self._probe(idx)
        out[hit] = self._cdata[slot[hit]]
        miss = ~hit
        self.tier.note_access(idx)
        if miss.any():
            mi = idx[miss]
            t0 = time.perf_counter()
            rows = np.asarray(self._rows[mi])       # disk-tier read
            self.fault_in_seconds += time.perf_counter() - t0
            out[miss] = rows
            self._install(mi, rows)
        nh, nm = int(hit.sum()), int(miss.sum())
        nc = int((miss & set_full).sum())            # full-set misses
        self.cache_hits += nh
        self.cache_misses += nm
        self.conflict_misses += nc
        self._stat_hits += nh
        self._stat_misses += nm
        self._stat_conflicts += nc
        return out

    def prefetch_rows(self, keys: np.ndarray) -> int:
        """madvise(WILLNEED)-style async readahead of `keys`' spill-file
        rows that are NOT already in the RAM cache: the kernel starts
        paging the ranges in immediately and returns, so the fault-in of
        the following working-set build overlaps the build's host work
        instead of serializing inside it (the LoadSSD2Mem pairing — the
        reference pulls a pass's SSD range up BEFORE the build reads it,
        box_wrapper.h:487-494). Never inserts; unknown keys are skipped.
        Returns the number of rows advised (0 where the platform has no
        madvise — the build then faults in synchronously as before)."""
        keys = np.asarray(keys).astype(np.uint64)
        if len(keys) == 0:
            return 0
        with self._lock:
            # slot geometry + tags read under the lock: a concurrent
            # resize_cache (the autotune) swaps both together
            idx = self._index.lookup(keys)
            idx = idx[idx >= 0].astype(np.int64)
            if len(idx) == 0:
                return 0
            hit, _, _ = self._probe(idx)
            idx = np.unique(idx[~hit])                      # misses only
        if len(idx) == 0:
            return 0
        mm = getattr(self._rows, "_mmap", None)
        adv = getattr(mmap, "MADV_WILLNEED", None)
        if mm is None or adv is None or not hasattr(mm, "madvise"):
            return 0
        row_b = self.cfg.row_width * 4
        page = mmap.ALLOCATIONGRANULARITY
        n = 0
        # coalesce contiguous row runs into one page-aligned advise each
        for run in np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1):
            start = int(run[0]) * row_b
            length = (int(run[-1]) - int(run[0]) + 1) * row_b
            aligned = (start // page) * page
            try:
                mm.madvise(adv, aligned, start + length - aligned)
            except (OSError, ValueError):
                break                     # advisory only — never fatal
            n += len(run)
        self._stat_prefetched += n
        return n

    def resize_cache(self, cache_rows: int,
                     assoc: int | None = None) -> None:
        """Re-budget the RAM hot tier (the spill_cache_rows autotune),
        keeping the current associativity unless ``assoc`` re-shapes it.
        Contents drop — the spill file is authoritative, rows re-fault
        and re-contest admission off their persisted tier signals — so
        a resize is a budget change, never a math change."""
        n = max(1, int(cache_rows))
        a = self._assoc if assoc is None else max(1, int(assoc))
        if n == self._cache_slots and a == self._assoc:
            return
        # under the store lock: a background feed staging may be inside
        # lookup_or_init/_read_rows (which hold it) — the geometry and
        # the tag/data arrays must swap atomically against those reads
        with self._lock:
            self._init_geometry(n, a, self.cfg.row_width)

    def _write_rows(self, idx: np.ndarray, rows: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.float32)
        self._rows[idx] = rows                      # write-through to disk
        # the write-through hands us each row's show/clk counters
        # (columns 0/1) for free — the show-count weight of the
        # admission score, clicks counting on top of impressions
        self.tier.note_written(idx, rows[:, 0] + rows[:, 1])
        hit, slot, _ = self._probe(idx)
        if hit.any():
            self._cdata[slot[hit]] = rows[hit]
        miss = ~hit
        if miss.any():
            # a just-written row installs into its set (it used to only
            # refresh HITS, so a just-trained hot row faulted back in
            # from disk on its next read); admission is still
            # score-contested so cold write-backs cannot thrash the tier
            self._install(idx[miss], rows[miss])

    def _rows_compacted(self) -> None:
        # shrink/remove reassigned row ids; cached tags and per-row tier
        # signals are meaningless
        self._ctags[:] = -1
        self.tier.invalidate()

    # ---- pass-boundary re-evaluation (the tier manager's clock) --------

    def tier_end_pass(self) -> dict:
        """Re-score placement off this pass's traffic: decay the
        cross-pass EMA, demote cached rows that went cold (their slot
        then admits without a contest), and hand back this pass's
        admission, eviction, hit, miss and conflict counts with the
        tier's size. Crash window ``tiering.evict.pre``: the cache is
        never authoritative, so dying anywhere in here leaves resume
        bit-exact."""
        faultpoint.hit("tiering.evict.pre")
        stats = self.tier.end_pass()
        demoted = 0
        if self.tier.policy == "freq":
            live = np.flatnonzero(self._ctags >= 0)
            if len(live):
                cold = self.tier.score(self._ctags[live]) \
                    < self.tier.evict_below
                demoted = int(cold.sum())
                if demoted:
                    self._ctags[live[cold]] = -1
        if demoted:
            self.tier.total_evicted += demoted
            stats["evicted"] += demoted
        if stats["admitted"]:
            counter_add("tiering.admitted", stats["admitted"])
        if stats["evicted"]:
            counter_add("tiering.evicted", stats["evicted"])
        hot = int((self._ctags >= 0).sum())
        gauge_set("tiering.hot_rows", hot)
        gauge_set("tiering.spill_bytes", self.spill_file_bytes)
        # the pass window the cache-budget autotune reads
        stats["pass_hits"] = int(self._stat_hits)
        stats["pass_misses"] = int(self._stat_misses)
        stats["pass_conflicts"] = int(self._stat_conflicts)
        if self._stat_conflicts:
            counter_add("tiering.conflict_misses", self._stat_conflicts)
        if self._stat_hits:
            counter_add("spill.cache_hits", self._stat_hits)
        if self._stat_misses:
            counter_add("spill.cache_misses", self._stat_misses)
        if self._stat_prefetched:
            counter_add("spill.prefetched_rows", self._stat_prefetched)
        self._stat_hits = self._stat_misses = self._stat_conflicts = 0
        self._stat_prefetched = 0
        stats["hot_rows"] = hot
        stats["spill_bytes"] = int(self.spill_file_bytes)
        stats["cache_rows"] = int(self._cache_slots)
        return stats

    # ---- persistence: stream from the memmap ---------------------------

    def _save_base_payload(self, f) -> None:
        faultpoint.hit("tiering.save.pre_flush")
        self._rows.flush()                          # msync the spill file
        _write_rows_npz(f, self._keys[:self._n], self._rows, None, self._n)

    def _save_delta_payload(self, f, keys: np.ndarray, idx: np.ndarray,
                            removed: np.ndarray) -> None:
        faultpoint.hit("tiering.save.pre_flush")
        self._rows.flush()
        _write_rows_npz(f, keys, self._rows, idx, len(idx),
                        removed=removed)

    @property
    def spill_dir(self) -> str:
        return self._spill_dir

    @property
    def spill_file_bytes(self) -> int:
        return os.path.getsize(self._rows_path)
