"""Per-host shard ownership of the working-set build.

The reference's FeedPass builds each card's working set from the shards
its PS owns, so build cost divides by the world instead of every host
re-reading the GLOBAL working set (box_wrapper.h:994-1072 pairs the
background FeedPass with libbox_ps's hash-sharded tables); Parallax
(arXiv:1808.02621) makes the same argument from sparsity — partition the
sparse plane so per-worker build/transfer cost scales DOWN with world
size.

:class:`ShardOwnership` is that partition for the host tier: the
``ShardedEmbeddingStore``'s splitmix64 hash partition is host-stable
(the same key lands on the same shard on every host, every pass), so
assigning each store shard to one world rank — round-robin,
``shard % world_size`` — gives every host a disjoint slice of the key
space. ``FeedPassManager`` filters every incoming key set through it,
so a host's working-set build (store fetch + H2D + spill fault-in)
covers exactly its shards' keys: 1/world of the global build.

Elastic resize (the PR-6 generation machinery): when the world re-forms
— a rank died, or a replacement host joined a degraded world —
``with_world`` derives the new partition and
``FeedPassManager.set_ownership`` rebinds it: pending rows flush, the
resident set drops, and the next ``begin_pass`` rebuilds exactly the
newly-owned shards' set (a replacement host fetches its shards' rows
and nothing else, instead of waiting on a full-world restart).
"""

from __future__ import annotations

import numpy as np


class ShardOwnership:
    """Round-robin assignment of store shards to world ranks.

    ``n_shards`` is the ``ShardedEmbeddingStore``'s partition width (the
    checkpoint identity — it never changes with the world); ``rank`` /
    ``world_size`` are the live world's. Ranks beyond the shard count
    own nothing (they contribute dense compute only).
    """

    def __init__(self, n_shards: int, world_size: int, rank: int):
        n_shards, world_size, rank = int(n_shards), int(world_size), int(rank)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank {rank} outside world of {world_size}")
        self.n_shards = n_shards
        self.world_size = world_size
        self.rank = rank

    @classmethod
    def for_store(cls, store, world_size: int,
                  rank: int) -> "ShardOwnership | None":
        """Ownership over ``store``'s partition, or None for unsharded
        stores (there is nothing to split — every host owns the table)."""
        n = getattr(store, "n_shards", None)
        if n is None or int(n) <= 1:
            return None
        return cls(int(n), world_size, rank)

    def with_world(self, world_size: int, rank: int) -> "ShardOwnership":
        """The elastic-resize derivation: same shard partition, new
        world — what ``FeedPassManager.set_ownership`` rebinds after a
        generation-sealed re-formation."""
        return ShardOwnership(self.n_shards, world_size, rank)

    @property
    def owned(self) -> np.ndarray:
        """This rank's shard ids (ascending)."""
        return np.arange(self.rank, self.n_shards, self.world_size,
                         dtype=np.int64)

    def owns_all(self) -> bool:
        return self.world_size == 1

    def owns(self, shard_ids: np.ndarray) -> np.ndarray:
        """Bool mask: which of ``shard_ids`` this rank owns."""
        return (np.asarray(shard_ids, dtype=np.int64) % self.world_size
                == self.rank)

    def filter_keys(self, store, keys: np.ndarray) -> np.ndarray:
        """The keys of ``keys`` that hash onto this rank's shards — the
        slice of a pass's key set THIS host builds. Requires the store's
        ``shard_of`` partition (``ShardedEmbeddingStore``); the hash is
        host-stable, so the world's slices are disjoint and cover."""
        keys = np.asarray(keys).astype(np.uint64)
        if self.owns_all() or len(keys) == 0:
            return keys
        shard_of = getattr(store, "shard_of", None)
        if shard_of is None:
            raise TypeError(
                "per-host shard ownership needs a sharded store with "
                f"shard_of (got {type(store).__name__}); unsharded "
                "stores have no partition to split")
        return keys[self.owns(shard_of(keys))]

    def diff(self, other: "ShardOwnership | None") -> dict:
        """The rebind delta from ``other`` (the PREVIOUS partition) to
        this one: ``{"gained": [...], "lost": [...], "kept": [...]}`` of
        shard ids. This is what an elastic resize costs THIS host —
        ``gained`` shards' working sets are rebuilt on the next
        ``begin_pass``, ``lost`` shards' resident rows drop — and what
        the grow tests assert: a newcomer's ``gained`` must equal its
        ``owned`` exactly (it rebuilds its shards' boundary set and
        nothing else). ``other=None`` means no prior partition (all
        owned shards are gained)."""
        mine = set(self.owned.tolist())
        prev = set() if other is None else set(other.owned.tolist())
        return {"gained": sorted(mine - prev),
                "lost": sorted(prev - mine),
                "kept": sorted(mine & prev)}

    def __eq__(self, other) -> bool:
        """Partition equality — an elastic re-formation that resolves to
        the same (shards, world, rank) must be a no-op rebind, not a
        resident-set drop."""
        return (isinstance(other, ShardOwnership)
                and (self.n_shards, self.world_size, self.rank)
                == (other.n_shards, other.world_size, other.rank))

    def __hash__(self) -> int:
        return hash((self.n_shards, self.world_size, self.rank))

    def __repr__(self) -> str:
        return (f"ShardOwnership(n_shards={self.n_shards}, "
                f"world_size={self.world_size}, rank={self.rank}, "
                f"owned={self.owned.tolist()})")
