"""Tiered table placement: disk + host RAM + device memory — the port of
``paddlebox_tpu/embedding/tiering.py``.

PaddleBox trains tables larger than device or host memory by stacking
three tiers: SSD holds the table, ``LoadSSD2Mem`` pulls a pass's range
into host DRAM, and device memory sees only the pass working set
(box_wrapper.h:487-494). Here:

- **disk** — ``spill_store.SpillEmbeddingStore``'s memory-mapped row
  file, under ``flags.table_tiering = "spill"``;
- **RAM** — its set-associative row cache, placed by
  :class:`TierManager`: a show-count-weighted admission and eviction
  policy re-scored at every pass boundary off the pass's per-row traffic;
- **device** — the pass working set and the feed manager's resident
  reuse, plus, under ``flags.use_replica_cache``, the trainer's replica
  of the rows the TierManager ranks hottest
  (``replica_cache.TrainerReplicaCache``).

Chains keep their format: spill stores stream base and delta payloads
from the memory map, and the crash windows are the fault points
``tiering.save.pre_flush`` and ``tiering.evict.pre``. The
``tiering.*`` / ``spill.*`` counters and gauges flush into the monitor at
each pass boundary, before the flight record commits, so they land in
that pass's ``stats_delta``; ``end_pass_rebalance`` also returns its
counts and ``spill_stats`` carries the totals. ``store_from_flags(cfg,
n_shards > 1)`` builds a ``store.ShardedEmbeddingStore`` whose every
shard takes the flags' tier (one spill file per shard under
``<spill_dir>/shard-SS``).
"""

from __future__ import annotations

import os

import numpy as np

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.embedding.store import (HostEmbeddingStore,
                                                 ShardedEmbeddingStore)

TIER_MODES = ("off", "spill")
POLICIES = ("freq", "direct")

# spill_cache_rows autotune bounds (flags.spill_cache_autotune): the
# re-budget never leaves this window, whatever the telemetry says
CACHE_MIN_ROWS = 256
CACHE_MAX_ROWS = 1 << 22
# thrash = the pass missed more than it hit AND eviction churn covered
# at least half the slots; idle = nearly-all-hits with a mostly-empty
# cache — the two signals the flight record already carries
_GROW_BELOW_HIT_RATE = 0.5
_SHRINK_ABOVE_HIT_RATE = 0.9


class TierManager:
    """Row-placement policy for one spill store's RAM hot tier.

    Keeps three 4-byte/row signals (small next to the ~16B/row key
    index, same budget note as the spill store's docstring):

    - ``_freq``  — accesses observed since the last pass boundary (the
      per-row traffic counter: every working-set fetch and write-back
      bumps it).
    - ``_score`` — the cross-pass EMA: at each pass boundary
      ``score = decay * score + freq`` (the re-evaluation window the
      flight record frames).
    - ``_show``  — the row's last-written show+clk counters (row
      columns 0/1), captured for free on the write-through path. The
      show column accumulates one count per impression INSIDE the
      training step, so it is the exchange's per-row traffic counter,
      persisted — the publisher-style show-count weighting with no
      disk scan. Decayed at pass boundaries like the EMA (and
      refreshed to the absolute counter on every write), so a
      formerly-popular row that went idle loses its pin within a few
      passes instead of holding its slot forever.

    A candidate row is admitted over a cached occupant iff its combined
    score ``score + freq + show_weight * show`` is >= the occupant's —
    recency wins ties, a strictly hotter resident is never displaced by
    a cold fault-in (the anti-thrash property the direct-mapped "last
    wins" install lacked). ``policy="direct"`` keeps the legacy
    always-install behavior as the baseline.
    """

    def __init__(self, n_rows: int, policy: str = "freq",
                 show_weight: float = 0.25, decay: float = 0.5,
                 evict_below: float = 0.25):
        if policy not in POLICIES:
            raise ValueError(
                f"tier policy {policy!r} (want one of {POLICIES})")
        self.policy = policy
        self.show_weight = float(show_weight)
        self.decay = float(decay)
        # boundary demotion threshold: a row read once scores 1.0 and
        # halves per idle pass, so the default demotes after ~2 idle
        # passes — the slot then admits without a score contest
        self.evict_below = float(evict_below)
        n = max(1, int(n_rows))
        self._freq = np.zeros(n, np.float32)
        self._score = np.zeros(n, np.float32)
        self._show = np.zeros(n, np.float32)
        # this pass's installs, handed back by end_pass
        self.pending_admitted = 0
        self.pending_evicted = 0
        # cumulative, for tests/observability
        self.total_admitted = 0
        self.total_evicted = 0
        self.passes = 0

    # ---- capacity / lifecycle -----------------------------------------

    def ensure_capacity(self, n_rows: int) -> None:
        """Grow the per-row signal arrays (row ids are stable across
        grows — the spill file keeps its bytes)."""
        n = int(n_rows)
        if n <= len(self._freq):
            return
        pad = n - len(self._freq)
        z = np.zeros(pad, np.float32)
        self._freq = np.concatenate([self._freq, z])
        self._score = np.concatenate([self._score, z])
        self._show = np.concatenate([self._show, z])

    def invalidate(self) -> None:
        """Row ids were reassigned (shrink/remove/restore rebuild) —
        per-row signals are meaningless; rebuild from fresh traffic."""
        self._freq[:] = 0.0
        self._score[:] = 0.0
        self._show[:] = 0.0

    # ---- traffic ------------------------------------------------------

    def note_access(self, idx: np.ndarray) -> None:
        if self.policy == "direct":
            return                     # last-wins reads no signals —
        np.add.at(self._freq, idx, 1.0)  # keep the baseline's hot path
        # (and the freq-vs-direct A/B) free of accumulation cost

    def note_written(self, idx: np.ndarray,
                     shows: np.ndarray | None) -> None:
        if self.policy == "direct":
            return
        np.add.at(self._freq, idx, 1.0)
        if shows is not None:
            self._show[idx] = shows

    def score(self, idx: np.ndarray) -> np.ndarray:
        return (self._score[idx] + self._freq[idx]
                + self.show_weight * self._show[idx])

    # ---- admission (the victim selection) -----------------------------

    def admit(self, cand_idx: np.ndarray,
              occupant_idx: np.ndarray) -> np.ndarray:
        """Bool mask per candidate: install over its slot's occupant
        (-1 = empty slot). ``direct`` = always (the legacy last-wins
        baseline); ``freq`` = only when the candidate's score reaches
        the occupant's."""
        if self.policy == "direct":
            return np.ones(len(cand_idx), bool)
        adm = np.ones(len(cand_idx), bool)
        live = occupant_idx >= 0
        if live.any():
            adm[live] = (self.score(cand_idx[live])
                         >= self.score(occupant_idx[live]))
        return adm

    def count_install(self, n_admitted: int, n_evicted: int) -> None:
        self.pending_admitted += int(n_admitted)
        self.pending_evicted += int(n_evicted)
        self.total_admitted += int(n_admitted)
        self.total_evicted += int(n_evicted)

    # ---- pass boundary ------------------------------------------------

    def end_pass(self) -> dict:
        """Fold this pass's traffic into the cross-pass score (the
        re-evaluation step) and hand back this pass's admission and
        eviction counts."""
        np.multiply(self._score, self.decay, out=self._score)
        np.add(self._score, self._freq, out=self._score)
        # the show weight decays too: an absolute (monotone) counter
        # would otherwise pin a formerly-popular row's slot forever and
        # keep its score above evict_below for good — writes refresh it
        # to the live counter, idleness fades it
        np.multiply(self._show, self.decay, out=self._show)
        self._freq[:] = 0.0
        self.passes += 1
        out = {"admitted": self.pending_admitted,
               "evicted": self.pending_evicted}
        self.pending_admitted = 0
        self.pending_evicted = 0
        return out


# ---------------------------------------------------------------------------
# flag-driven construction
# ---------------------------------------------------------------------------

def shard_store_factory(tiering: str | None = None,
                        cache_rows: int | None = None,
                        spill_dir: str | None = None,
                        policy: str = "freq",
                        assoc: int | None = None):
    """A store factory ``(cfg, initial_capacity, shard) -> store``
    selecting the storage tier per ``flags.table_tiering`` /
    ``flags.spill_cache_rows`` / ``flags.spill_dir`` (explicit arguments
    override the flags). Shard ``s``'s spill file lands under
    ``<spill_dir>/shard-SS``, as in the reference, so a one-shard table
    finds its file where a JAX run of the same flags put it."""

    def factory(cfg: EmbeddingConfig, initial_capacity: int, shard: int):
        mode = flags.table_tiering if tiering is None else tiering
        if mode not in TIER_MODES:
            raise ValueError(
                f"flags.table_tiering={mode!r} (want one of {TIER_MODES})")
        if mode == "off":
            return HostEmbeddingStore(cfg, initial_capacity)
        from paddlebox_tpu_torch.embedding.spill_store import \
            SpillEmbeddingStore
        rows = flags.spill_cache_rows if cache_rows is None else cache_rows
        root = (flags.spill_dir or None) if spill_dir is None else spill_dir
        sub_dir = (os.path.join(root, f"shard-{shard:02d}")
                   if root else None)
        return SpillEmbeddingStore(cfg, spill_dir=sub_dir, cache_rows=rows,
                                   initial_capacity=initial_capacity,
                                   tier_policy=policy, cache_assoc=assoc)

    return factory


def store_from_flags(cfg: EmbeddingConfig, n_shards: int = 1,
                     initial_capacity: int = 1024):
    """Build the host table the flags describe: ``n_shards > 1`` wraps
    the tier in a hash-partitioned ``ShardedEmbeddingStore``, and
    ``flags.table_tiering`` picks each (sub-)store's storage tier."""
    factory = shard_store_factory()
    if int(n_shards) > 1:
        return ShardedEmbeddingStore(cfg, int(n_shards), initial_capacity,
                                     store_factory=factory)
    return factory(cfg, initial_capacity, 0)


# ---------------------------------------------------------------------------
# pass-boundary drive (BoxPS.end_pass / trainer-owned passes)
# ---------------------------------------------------------------------------

def _spill_subs(store) -> list:
    subs = getattr(store, "_shards", None)
    if subs is None:
        subs = [store]
    return [s for s in subs if hasattr(s, "tier_end_pass")]


def autotune_cache_rows(sub, stats: dict) -> int | None:
    """One spill store's cache-budget decision off its pass telemetry
    (``tier_end_pass``'s hit/miss/eviction window): a thrashing cache
    (hit rate < 0.5, eviction churn >= half the slots) doubles; a
    mostly-idle one (hit rate > 0.9, occupancy < a quarter of the slots)
    halves. Bounded by [CACHE_MIN_ROWS, CACHE_MAX_ROWS]; returns the new
    slot count when a resize happened, None otherwise."""
    seen = stats.get("pass_hits", 0) + stats.get("pass_misses", 0)
    if not seen:
        return None
    hit_rate = stats.get("pass_hits", 0) / seen
    slots = int(sub._cache_slots)
    if (hit_rate < _GROW_BELOW_HIT_RATE
            and stats.get("evicted", 0) >= slots // 2):
        target = min(max(slots * 2, CACHE_MIN_ROWS), CACHE_MAX_ROWS)
    elif (hit_rate > _SHRINK_ABOVE_HIT_RATE
            and stats.get("hot_rows", 0) < slots // 4):
        target = max(slots // 2, CACHE_MIN_ROWS)
    else:
        return None
    # keep the budget a whole number of sets: the store rounds a ragged
    # budget down, which would make the next decision's `slots` drift
    assoc = int(getattr(sub, "_assoc", 1))
    target = max(assoc, (target // assoc) * assoc)
    if target == slots:
        return None
    sub.resize_cache(target)
    return target


def end_pass_rebalance(store) -> dict | None:
    """Re-evaluate RAM-tier placement of a spill-backed store at a pass
    boundary: decay and re-score off the pass's per-row traffic, demote
    cold cached rows, and return the pass's tier counts
    (``tier_end_pass``). Under ``flags.spill_cache_autotune`` the same
    counts re-budget the cache (``autotune_cache_rows``), and the dict
    carries ``cache_rows`` and ``cache_resized`` (also the
    ``tiering.cache_rows`` gauge and the flight record's
    ``spill_cache_rows``). None for an untiered store."""
    subs = _spill_subs(store)
    if not subs:
        return None
    from paddlebox_tpu_torch.monitor import gauge_set, hub
    agg: dict[str, int] = {}
    resized = 0
    for sub in subs:
        stats = sub.tier_end_pass()
        if flags.spill_cache_autotune:
            if autotune_cache_rows(sub, stats) is not None:
                resized += 1
            stats["cache_rows"] = int(sub._cache_slots)
        for k, v in stats.items():
            agg[k] = agg.get(k, 0) + int(v)
    if flags.spill_cache_autotune:
        agg["cache_resized"] = resized
        gauge_set("tiering.cache_rows", agg["cache_rows"])
        # the chosen budget rides this pass's flight record
        hub().record_train(spill_cache_rows=int(agg["cache_rows"]))
    return agg


def describe(store) -> str | None:
    """The table's storage-tier identity: "spill" for a spill-backed
    store, "sharded+spill" when spill sub-stores sit under a sharded
    partition, None when untiered."""
    if not _spill_subs(store):
        return None
    if getattr(store, "_shards", None) is not None:
        return "sharded+spill"
    return "spill"


def fault_in_seconds(store) -> float:
    """Cumulative disk-tier fault-in wall seconds of a spill-backed store
    (0.0 for an untiered one). The feed manager diffs it across a
    boundary for the ``spill_fault_in`` share of its split."""
    return float(sum(getattr(s, "fault_in_seconds", 0.0)
                     for s in _spill_subs(store)))


def spill_stats(store) -> dict | None:
    """Hot-tier statistics of a spill-backed store — the operator view.
    None when the store has no spill tier."""
    subs = _spill_subs(store)
    if not subs:
        return None
    out = {"cache_rows": 0, "cache_hits": 0, "cache_misses": 0,
           "conflict_misses": 0, "hot_rows": 0, "spill_bytes": 0,
           "admitted": 0, "evicted": 0,
           "assoc": int(getattr(subs[0], "_assoc", 1))}
    for s in subs:
        out["cache_rows"] += int(s._cache_slots)
        out["cache_hits"] += int(s.cache_hits)
        out["cache_misses"] += int(s.cache_misses)
        out["conflict_misses"] += int(getattr(s, "conflict_misses", 0))
        out["hot_rows"] += int((s._ctags >= 0).sum())
        out["spill_bytes"] += int(s.spill_file_bytes)
        out["admitted"] += int(s.tier.total_admitted)
        out["evicted"] += int(s.tier.total_evicted)
    seen = out["cache_hits"] + out["cache_misses"]
    out["hit_rate"] = round(out["cache_hits"] / seen, 4) if seen else None
    return out
