"""Host-tier embedding store — the port of ``HostEmbeddingStore``
(``paddlebox_tpu/embedding/store.py``).

Between passes every row lives here, in host memory: a batch KeyIndex
over one growing float32 rows array. The device only ever holds a pass's
working set (``working_set.py``). New keys get a deterministic splitmix
row init — bit-identical to the JAX package's, so the same key gets the
same initial row in both.

Persistence follows the reference's format and chain protocol exactly,
so a chain written by either package loads in the other:

- ``save_base`` (:369) — ``base.npz`` with ``keys`` and ``rows``;
- ``save_delta`` (:400) — ``delta-NNNNN.npz`` with the rows dirtied and
  the keys evicted since the last save (``keys``, ``rows``, ``removed``);
- each save then writes ``meta.json`` and commits ``MANIFEST.json``
  LAST (``_write_chain_manifest`` :473: the chain, each member's size
  and CRC32, its parent);
- ``restore`` (:559) / ``load`` (:617) replay ``base + deltas[:seq]``
  after checking the prefix against the manifest (``_verify_chain``
  :529), so a torn mid-chain member raises CheckpointCorruptError;
- ``shrink`` (:314) decays show counters and evicts cold rows,
  tombstoning them for the next delta.

Row order and delta key order follow the store's insertion order, as in
the reference: the same sequence of operations gives the same arrays in
both packages. The dirty mask is set by ``write_back`` (:245), by
``_ingest`` (:647, delta replay) and by a tombstoned key re-added in
``lookup_or_init`` (:218); a fresh key is not dirty (its init row is
deterministic).

The bounded stale-key log (``mutation_marker`` / ``stale_keys_since``,
reference :104-150) tells ``FeedPassManager`` which keys' stored bytes a
mutation changed, so a device-resident working set re-fetches exactly
those rows instead of rebuilding. Every ``_mutations`` bump appends one
entry: ``shrink`` the evicted keys on pure eviction (``decay == 1.0``),
else ``None``; ``restore`` ``None``; ``_remove`` the present keys;
``_ingest`` the ingested keys. The reference's spill-tier hooks and
``export_serving`` are not ported yet (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading

import numpy as np

from paddlebox_tpu_torch.embedding.config import EmbeddingConfig
from paddlebox_tpu_torch.native.key_index import KeyIndex, sorted_unique
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

# Bounds of the stale-key log: more events than the ring holds, or one
# event touching more keys than the cap, degrades to "unknown" (None) and
# the consumer falls back to the full rebuild.
_STALE_LOG_EVENTS = 64
_STALE_LOG_MAX_KEYS = 1 << 21
_EMPTY_KEYS = np.zeros(0, dtype=np.uint64)


def _delta_name(seq: int) -> str:
    return f"delta-{seq:05d}.npz"


class HostEmbeddingStore:
    _GROW = 1.5
    # single-trainer-owned: the device tier may retain rows across passes
    # and write back lazily (embedding/feed_pass.py)
    supports_resident_reuse = True

    def __init__(self, cfg: EmbeddingConfig, initial_capacity: int = 1024):
        self.cfg = cfg
        self._index = KeyIndex(initial_capacity)
        self._keys = np.zeros(initial_capacity, dtype=np.uint64)
        self._rows = np.zeros((initial_capacity, cfg.row_width), np.float32)
        self._n = 0
        self._dirty = np.zeros(initial_capacity, dtype=bool)
        self._tombstones: set[int] = set()  # evicted since the last save
        self._lock = threading.Lock()
        self._save_seq = 0
        # monotonic count of saves (base or delta, any directory): each
        # save consumes the dirty mask and tombstones, so a checkpointer
        # must know whether ANY other save ran since its last one —
        # save_seq cannot tell (a foreign save_base resets it to 0)
        self._save_count = 0
        # bumped whenever rows change outside the pass pull/push cycle
        # (shrink, removal, delta replay, restore)
        self._mutations = 0
        # (seq, affected keys | None) per mutation event; None = the event
        # touched an unknowable set. Every _mutations bump appends exactly
        # one entry (stale_keys_since's completeness check counts them).
        self._stale_log: collections.deque = collections.deque(
            maxlen=_STALE_LOG_EVENTS)
        # run before any read of row values for persistence or hygiene
        # (save, shrink, get_rows): a device tier holding unsynced rows
        # writes them back first
        self._flush_hooks: list = []

    @property
    def mutation_count(self) -> int:
        return self._mutations

    # ---- stale-key log (the incremental-feed contract) ----

    def _log_mutation(self, keys: np.ndarray | None) -> None:
        """Record one mutation event's affected keys (under the lock,
        right after the ``_mutations`` bump). ``None`` = an unknowable
        set (a restore's reset)."""
        if keys is not None:
            keys = sorted_unique(np.asarray(keys).astype(np.uint64))
            if len(keys) > _STALE_LOG_MAX_KEYS:
                keys = None
        self._stale_log.append((self._mutations, keys))

    def mutation_marker(self) -> int:
        """Opaque marker for :meth:`stale_keys_since`."""
        return int(self._mutations)

    def stale_keys_since(self, marker) -> np.ndarray | None:
        """Keys whose stored bytes changed or vanished since ``marker``
        (sorted unique uint64; empty = nothing mutated). None = the log
        cannot prove completeness (the ring rolled over, an event's key
        set was unknowable, or the union outgrew the cap): the caller
        must rebuild in full."""
        marker = int(marker)
        with self._lock:
            if self._mutations == marker:
                return _EMPTY_KEYS
            events = [e for e in self._stale_log if e[0] > marker]
            if len(events) != self._mutations - marker:
                return None               # the ring rolled past the marker
            parts, total = [], 0
            for _, k in events:
                if k is None:
                    return None
                parts.append(k)
                total += len(k)
                if total > _STALE_LOG_MAX_KEYS:
                    return None
            if not parts:
                return _EMPTY_KEYS
        return sorted_unique(np.concatenate(parts))

    @property
    def save_seq(self) -> int:
        """Delta chain position of the last save (0 = at a base)."""
        return self._save_seq

    @property
    def save_count(self) -> int:
        """Monotonic number of save_base/save_delta calls on this store
        object (all directories) — the dirty-mask consumption counter."""
        return self._save_count

    def register_flush_hook(self, fn) -> None:
        self._flush_hooks.append(fn)

    def unregister_flush_hook(self, fn) -> None:
        if fn in self._flush_hooks:
            self._flush_hooks.remove(fn)

    def has_flush_hooks(self) -> bool:
        """Whether a device tier (a FeedPassManager) is attached."""
        return bool(self._flush_hooks)

    def _run_flush_hooks(self) -> None:
        # outside the lock: hooks call write_back, which takes it
        for fn in list(self._flush_hooks):
            fn()

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

    # ---- pull/push at pass granularity ----

    def lookup_or_init(self, keys: np.ndarray) -> np.ndarray:
        """Rows for ``keys``, creating fresh rows for unseen keys (called
        by the pass builder, not per batch)."""
        keys = np.asarray(keys).astype(np.uint64)
        with self._lock:
            idx, added = self._index.lookup_or_insert(keys)
            if added:
                new_keys = self._append_new_keys(idx, keys, added)
                self._rows[self._n - added:self._n] = \
                    self._init_rows(new_keys)
                if self._tombstones:
                    tomb = np.fromiter(self._tombstones, dtype=np.uint64,
                                       count=len(self._tombstones))
                    res = np.isin(new_keys, tomb)
                    if res.any():
                        # a re-created key is live again: drop its pending
                        # tombstone AND dirty its fresh init row — the next
                        # delta must carry the new row, or load(base +
                        # deltas) would resurrect the pre-eviction row
                        self._dirty[self._n - added
                                    + np.flatnonzero(res)] = True
                        self._tombstones.difference_update(
                            int(k) for k in new_keys[res].tolist())
            return self._rows[idx].copy()

    def write_back(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Persist updated rows after a pass (EndPass)."""
        keys = np.asarray(keys).astype(np.uint64)
        with self._lock:
            idx = self._lookup_strict(keys)
            self._rows[idx] = np.asarray(rows, dtype=np.float32)
            self._dirty[idx] = True

    def peek_rows(self, keys: np.ndarray) -> np.ndarray:
        """Rows without creating missing ones (test/eval mode): unseen
        keys get their deterministic init row but are not inserted."""
        keys = np.asarray(keys).astype(np.uint64)
        rows = self._init_rows(keys)
        with self._lock:
            idx = self._index.lookup(keys)
            hit = idx >= 0
            rows[hit] = self._rows[idx[hit]]
        return rows

    def get_rows(self, keys: np.ndarray) -> np.ndarray:
        """Rows of present keys (KeyError for an absent one), after the
        flush hooks have made any device-held rows visible."""
        self._run_flush_hooks()
        keys = np.asarray(keys).astype(np.uint64)
        with self._lock:
            return self._rows[self._lookup_strict(keys)].copy()

    def keys(self) -> np.ndarray:
        """The stored keys, in insertion (row) order."""
        with self._lock:
            return self._keys[:self._n].copy()

    def _append_new_keys(self, idx: np.ndarray, keys: np.ndarray,
                         added: int) -> np.ndarray:
        """Append the ``added`` new keys the index just assigned (ids are
        sequential from the old size, first-occurrence order). Returns the
        new keys in id order; their rows are the caller's job."""
        new_pos = np.flatnonzero(idx >= self._n)
        # np.unique returns first-occurrence positions ordered by id
        _, take = np.unique(idx[new_pos], return_index=True)
        new_keys = keys[new_pos[take]]
        self._reserve(self._n + added)
        self._keys[self._n:self._n + added] = new_keys
        self._n += added
        return new_keys

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
        dirty = np.zeros(new_cap, dtype=bool)
        dirty[:self._n] = self._dirty[:self._n]
        self._dirty = dirty
        rows = np.zeros((new_cap, self.cfg.row_width), np.float32)
        rows[:self._n] = self._rows[:self._n]
        self._rows = rows

    def _compact(self, keep: np.ndarray) -> np.ndarray:
        """Drop the rows where ``keep`` is False (over the live prefix),
        keeping order, dirty bits and the index in step. Returns the
        dropped keys. Call under the lock."""
        n = self._n
        gone = self._keys[:n][~keep]
        kept_keys = self._keys[:n][keep]
        kept_rows = self._rows[:n][keep]
        kept_dirty = self._dirty[:n][keep]
        self._index.rebuild(kept_keys)
        self._n = len(kept_keys)
        self._keys[:self._n] = kept_keys
        self._rows[:self._n] = kept_rows
        self._dirty[:] = False
        self._dirty[:self._n] = kept_dirty
        return gone

    # ---- hygiene (ShrinkTable) ----

    def shrink(self, min_show: float, decay: float = 1.0) -> int:
        """Decay show counters and evict rows below ``min_show``; the
        evicted keys are tombstoned for the next delta. Returns the number
        of evicted rows."""
        self._run_flush_hooks()
        with self._lock:
            self._mutations += 1
            if decay != 1.0:
                self._rows[:self._n, 0] *= decay
                # decayed counters must reach the next delta checkpoint
                self._dirty[:self._n] = True
            keep = self._rows[:self._n, 0] >= min_show
            evicted = int((~keep).sum())
            gone = _EMPTY_KEYS
            if evicted:
                gone = self._compact(keep)
                # tombstone evictions so load(base + deltas) does not
                # resurrect them
                self._tombstones.update(int(k) for k in gone.tolist())
            # a decay rewrote every surviving row's show counter (the whole
            # key space is stale); pure eviction touches the evicted keys
            self._log_mutation(gone if decay == 1.0 else None)
            return evicted

    # ---- checkpoint (SaveBase/SaveDelta/Load) ----

    def save_base(self, path: str, pass_id: int | None = None) -> str:
        """Full snapshot. Atomic-durable: base.npz lands via
        tmp+fsync+replace, then meta, then the MANIFEST commit.

        As in the reference, re-saving a base INTO A DIRECTORY THAT
        ALREADY HOLDS ONE replaces base.npz before the reset manifest
        commits: a kill in that window leaves a directory whose manifest
        fails verification (detected, with nothing local to fall back
        to). PassCheckpointer's chain-NNNN rotation and FleetUtil's
        per-day base directories write each base into a fresh one."""
        self._run_flush_hooks()
        os.makedirs(path, exist_ok=True)
        with self._lock:
            fname = os.path.join(path, "base.npz")
            with ckpt_lib.atomic_file(
                    fname,
                    fault_point="store.save_base.pre_replace") as tmp:
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, keys=self._keys[:self._n],
                                        rows=self._rows[:self._n])
            self._save_seq = 0
            self._save_count += 1
            self._write_meta(path)
            self._write_chain_manifest(path, reset=True, pass_id=pass_id)
            self._dirty[:] = False
            self._tombstones.clear()
        return fname

    def save_delta(self, path: str, pass_id: int | None = None) -> str:
        """Incremental save: rows dirtied and keys tombstoned since the
        last save. The chain manifest commits LAST, so a crash between the
        delta file and the manifest leaves the chain at the previous
        save_seq and the stale delta unreachable (the re-run overwrites
        it)."""
        self._run_flush_hooks()
        os.makedirs(path, exist_ok=True)
        with self._lock:
            # the sequence number commits only after the delta file lands:
            # a failed write must not burn a seq and leave a gap
            seq = self._save_seq + 1
            idx = np.flatnonzero(self._dirty[:self._n])
            fname = os.path.join(path, _delta_name(seq))
            removed = np.fromiter(sorted(self._tombstones), dtype=np.uint64,
                                  count=len(self._tombstones))
            with ckpt_lib.atomic_file(
                    fname,
                    fault_point="store.save_delta.pre_replace") as tmp:
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, keys=self._keys[idx],
                                        rows=self._rows[idx],
                                        removed=removed)
            self._save_seq = seq
            self._save_count += 1
            self._write_meta(path)
            faultpoint.hit("store.save_delta.pre_manifest")
            self._write_chain_manifest(path, pass_id=pass_id)
            self._dirty[:] = False
            self._tombstones.clear()
        return fname

    # ---- chain protocol (PassCheckpointer records and verifies exactly
    # these members' CRCs) ----

    def chain_members(self, seq: int) -> list[str]:
        """Relative names of the chain prefix ``base + deltas[:seq]`` in
        replay order."""
        return ["base.npz"] + [_delta_name(i) for i in range(1, seq + 1)]

    def chain_file_entries(self, path: str, seq: int) -> dict[str, dict]:
        """{relative name: {bytes, crc32}} for the chain prefix, read
        from the directory's own manifest (nothing is re-hashed)."""
        manifest = ckpt_lib.read_manifest(path)
        return {name: manifest["files"][name]
                for name in self.chain_members(seq)}

    def chain_increment_members(self, seq: int) -> list[str]:
        """Relative names a single ``save_delta`` at ``seq`` touched."""
        return [_delta_name(seq), "meta.json", ckpt_lib.MANIFEST_NAME]

    def _write_meta(self, path: str) -> None:
        meta = dataclasses.asdict(self.cfg)
        meta["save_seq"] = self._save_seq
        meta["num_keys"] = self._n
        with ckpt_lib.atomic_file(os.path.join(path, "meta.json")) as tmp:
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)

    def _write_chain_manifest(self, path: str, reset: bool = False,
                              pass_id: int | None = None) -> None:
        """Commit MANIFEST.json describing the live chain: base + ordered
        deltas up to ``save_seq``, per-member size + CRC32, and each
        member's chain parent. ``reset=True`` (save_base) starts a fresh
        chain. Earlier members' entries are reused from the previous
        manifest (only the file just written is hashed); members absent
        from this directory are skipped (a self-contained delta directory
        holds one link of a chain kept elsewhere)."""
        prev = None if reset else ckpt_lib.read_manifest(path)
        prev_files = (prev or {}).get("files", {})
        logical = self.chain_members(self._save_seq)
        chain, files = [], {}
        for i, name in enumerate(logical):
            full = os.path.join(path, name)
            if not os.path.exists(full):
                continue
            fresh = (name == "base.npz" if reset
                     else name == _delta_name(self._save_seq))
            ent = (dict(prev_files[name])
                   if not fresh and name in prev_files
                   else ckpt_lib.file_entry(full))
            ent["parent"] = logical[i - 1] if i else None
            files[name] = ent
            chain.append(name)
        files["meta.json"] = ckpt_lib.file_entry(
            os.path.join(path, "meta.json"))
        ckpt_lib.write_manifest(path, files, save_seq=self._save_seq,
                                chain=chain, num_keys=self._n,
                                pass_id=pass_id)

    def apply_delta_file(self, fname: str) -> None:
        """Replay one delta-*.npz (possibly from another directory) on top
        of the current state."""
        try:
            ctx = np.load(fname)
        except Exception as e:           # BadZipFile / truncation / OSError
            raise CheckpointCorruptError(fname, str(e))
        with ctx as z:
            try:
                keys, rows = z["keys"], z["rows"]
                removed = z["removed"] if "removed" in z else None
            except Exception as e:
                raise CheckpointCorruptError(
                    fname, f"member unreadable ({e})")
        self._ingest(keys, rows)
        if removed is not None and len(removed):
            self._remove(removed)

    def _verify_chain(self, path: str, seq: int) -> None:
        """Check the ``chain_members(seq)`` prefix against the directory
        MANIFEST (size + CRC32 per member). No manifest verifies nothing;
        a manifest that does not cover the prefix, or a member that fails
        its checksum, raises CheckpointCorruptError naming the position."""
        manifest = ckpt_lib.read_manifest(path)
        if manifest is None:
            return
        need = self.chain_members(seq)
        covered = manifest.get("files", {})
        for i, name in enumerate(need):
            if name not in covered:
                raise CheckpointCorruptError(
                    os.path.join(path, name),
                    f"chain member #{i} ({name}) not covered by the "
                    f"manifest (manifest save_seq="
                    f"{manifest.get('save_seq')}, wanted replay up to "
                    f"{seq}) — fall back to an earlier snapshot")
        try:
            ckpt_lib.verify_manifest(path, manifest, only=need)
        except CheckpointCorruptError as e:
            raise CheckpointCorruptError(
                e.fname,
                f"chain member failed verification at position "
                f"{need.index(os.path.basename(e.fname))} of "
                f"base+{seq} deltas: {e} — fall back to an earlier "
                f"snapshot") from e

    def restore(self, path: str, upto_seq: int | None = None,
                verify: bool = True) -> "HostEmbeddingStore":
        """In place: reset this store and replay ``base + deltas[:seq]``
        from ``path``. ``upto_seq`` pins the horizon (a pass snapshot
        records the save_seq it committed at); without it the chain
        MANIFEST's save_seq is the horizon, falling back to meta.json for
        a directory without one. ``verify`` checks the prefix first. The
        dirty mask is clear after the replay: replayed state is on-disk
        state."""
        if upto_seq is None:
            manifest = ckpt_lib.read_manifest(path)
            if manifest is not None and "save_seq" in manifest:
                seq = int(manifest["save_seq"])
            else:
                with open(os.path.join(path, "meta.json")) as f:
                    seq = int(json.load(f)["save_seq"])
        else:
            seq = int(upto_seq)
        if verify:
            self._verify_chain(path, seq)
        with self._lock:
            self._mutations += 1
            self._log_mutation(None)
            self._index = KeyIndex(max(1024, len(self._keys)))
            self._n = 0
            self._dirty[:] = False
            self._tombstones.clear()
        base = os.path.join(path, "base.npz")
        try:
            ctx = np.load(base)
        except Exception as e:
            raise CheckpointCorruptError(base, str(e))
        with ctx as z:
            self._ingest(z["keys"], z["rows"])
        for i in range(1, seq + 1):
            fname = os.path.join(path, _delta_name(i))
            if not os.path.exists(fname):
                raise CheckpointCorruptError(
                    fname, f"mid-chain delta #{i} of {seq} missing — the "
                           f"chain cannot be replayed; fall back to an "
                           f"earlier snapshot")
            self.apply_delta_file(fname)
        self._save_seq = seq
        self._dirty[:self._n] = False
        return self

    @classmethod
    def load(cls, path: str, cfg: EmbeddingConfig | None = None,
             upto_seq: int | None = None,
             verify: bool = True) -> "HostEmbeddingStore":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if cfg is None:
            fields = {f.name for f in dataclasses.fields(EmbeddingConfig)}
            cfg = EmbeddingConfig(**{k: v for k, v in meta.items()
                                     if k in fields})
        return cls(cfg).restore(path, upto_seq=upto_seq, verify=verify)

    def _remove(self, keys: np.ndarray) -> None:
        with self._lock:
            self._mutations += 1
            present = self._index.lookup(keys) >= 0
            self._log_mutation(keys[present])
            if not present.any():
                return
            self._compact(~np.isin(self._keys[:self._n], keys[present]))

    def _ingest(self, keys: np.ndarray, rows: np.ndarray) -> None:
        with self._lock:
            self._mutations += 1
            keys = np.asarray(keys).astype(np.uint64)
            self._log_mutation(keys)
            idx, added = self._index.lookup_or_insert(keys)
            if added:
                self._append_new_keys(idx, keys, added)
            if self._tombstones:
                tomb = np.fromiter(self._tombstones, dtype=np.uint64,
                                   count=len(self._tombstones))
                res = np.isin(keys, tomb)
                if res.any():
                    # a re-added key is live again: drop its tombstone
                    # (its row is dirtied below with the rest)
                    self._tombstones.difference_update(
                        int(k) for k in keys[res].tolist())
            # last occurrence wins for duplicate keys (replay order)
            self._rows[idx] = np.asarray(rows, dtype=np.float32)
            # every ingested row diverges from what the last save captured:
            # the next delta must carry it (restore clears the mask after
            # its replay, so the first post-load delta stays small)
            self._dirty[idx] = True
