"""Incremental, overlapped pass boundary — the port of ``FeedPassManager``
(``paddlebox_tpu/embedding/feed_pass.py``).

- **Resident reuse.** The previous pass's device table is retained; the
  next pass's table is built on the device from it (one ``index_select``
  of the resident rows, then the fresh rows copied into their slots), so
  rows present in both passes never cross host <-> device again. Only
  the fresh keys' rows are fetched from the host store and copied H2D.
- **Lazy write-back.** ``end_pass`` moves nothing; it marks the pass's
  touched rows unsynced. Rows cross D2H only when they retire (absent
  from the next pass) or when ``flush()`` runs, which the host store
  triggers through its flush hooks before ``save_base``, ``save_delta``,
  ``get_rows`` and ``shrink``.
- **Overlap.** ``begin_feed_pass(next_keys)`` runs the key diff, the host
  fetch and the H2D copy of pass N+1's fresh rows on a background thread
  while pass N trains; ``wait_feed_pass_done()`` joins it. The copy goes
  from a pinned host buffer on a CUDA stream the manager owns, and the
  feed thread waits on that stream only; the consuming stream waits on
  it (``wait_stream``) and the staged tensor is marked used there
  (``record_stream``) before the combine reads it.
- **Incremental delta feeds** (``flags.incremental_feed``). A store
  mutation whose reach the stale-key log proves
  (``store.stale_keys_since``) re-fetches only the stale resident keys,
  and a staging overtaken by such a mutation is patched with those rows
  instead of discarded. An unprovable mutation (a restore, a decay
  shrink, an oversized event, or the flag off) forces the full rebuild.

- **Storage tiers.** A quantized table stages, combines and patches as
  its two planes; under ``flags.transfer_compress_embedx`` the staged
  embedx crosses as bfloat16 (``working_set.upload_rows``). With a spill
  store, ``flags.spill_prefetch`` reads ahead the disk rows a staging is
  about to fault in, and the boundary split gains ``spill_fault_in``
  (the store's fault-in seconds over the boundary). With the replica
  tier attached (``set_replica``), a staging's fresh keys that the
  replica can prove current are served from it: their rows are copied
  on the device from the replica's plane into the staged plane
  (``index_copy_``), or, for quantized and compressed transfers, filled
  on the host before the conversion, so the staged bytes round exactly
  as store-fetched rows do. Every write-back site tells the replica
  which keys it pushed (``note_written``).

- **Timers** (``timers=``, a ``monitor.StageTimers``; the trainer passes
  its own, a standalone manager makes one): ``feed_begin`` is all of
  ``begin_pass`` (``last_boundary_seconds`` is read from that scope),
  ``feed_wait`` each join on the feed thread that ``begin_pass`` and
  ``begin_feed_pass`` make, and ``writeback`` the retiring rows' D2H
  and store write. They emit no hub event; under a torch.profiler
  session each opens the range ``pbt/<stage>``.

The reference's combine and patch are XLA programs, not Pallas kernels;
here they are plain torch (``index_select`` and indexed assignment).
The working set keeps the port's row rule, ``max(min_rows, K + 1)``
rows; ``bucket_size`` sizes only the staged H2D plane, as the
reference's does, and the patch plane is not padded.

Telemetry, under the reference's names: the ``feed_pass.*`` row and
byte counters (fresh, reused, stale, patched, retired, flushed rows;
H2D and D2H bytes) and boundary gauges land in each pass's flight
record, and the ``feed_pass_staged`` / ``feed_pass_flush`` events are
emitted from the thread that did the work (the feed thread is spawned
through ``monitor.context``, so they carry the pass's tags). The
``last_*`` attributes carry the same numbers for the last boundary.

- **The mesh** (``mesh=``, a ``parallel.mesh.Mesh`` of several ranks).
  Every rank is given the pass-wide key set and builds a
  ``working_set.ShardLayout`` from it (the same on every rank): the
  keys this rank owns (``working_set.key_owners``) become its shard,
  built, reused across passes and written back exactly as one device's
  working set, and the pass-wide index translates every rank's batch
  slice to global rows. ``end_pass`` ORs the ranks' touch marks
  (``PassWorkingSet.sync_touched``), a collective every rank makes at
  the same point. ``ownership=`` (a ``distributed.ShardOwnership``)
  makes a rank own its store shards' keys; without one a key's rank is
  its splitmix64 hash mod the world. Without a mesh, an ownership
  filters every key set to the owned keys, as in the JAX package (a
  host builds 1/world of the global set). ``set_ownership`` rebinds it:
  pending rows flush and the resident set drops.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding import quant, tiering
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.working_set import (PassWorkingSet,
                                                       ShardLayout,
                                                       bucket_size,
                                                       embedx_compressed,
                                                       fetch_rows,
                                                       key_owners,
                                                       upload_rows)
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor import counter_add as stat_add
from paddlebox_tpu_torch.monitor import event as mon_event
from paddlebox_tpu_torch.monitor import gauge_set as stat_set
from paddlebox_tpu_torch.monitor.timers import StageTimers
from paddlebox_tpu_torch.native.key_index import sorted_unique
from paddlebox_tpu_torch.utils import faultpoint

_EMPTY_KEYS = np.zeros(0, dtype=np.uint64)
_SPLIT_KEYS = ("build", "h2d", "spill_fault_in")
# the manager's timer stages (module doc)
FEED_STAGES = ("feed_begin", "feed_wait", "writeback")


def _planes(table) -> list[torch.Tensor]:
    """A working-set table's tensors: [table], or a QuantTable's
    [fp, qx]."""
    return [table.fp, table.qx] if quant.is_quant(table) else [table]


def _from_planes(planes: list[torch.Tensor]):
    return quant.QuantTable(*planes) if len(planes) == 2 else planes[0]


class _Staging:
    """Result of one feed pass: fresh rows staged on the device + the
    diff."""

    __slots__ = ("keys", "pos_prev", "fresh_dev", "n_fresh", "h2d_bytes",
                 "prev", "store_gen", "full_ws", "timings", "marker",
                 "patch_keys", "n_stale", "replica_hits", "n_rows")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class FeedPassManager:
    """Owns the persistent device working set across passes."""

    def __init__(self, store: HostEmbeddingStore,
                 device: str | torch.device | None = None,
                 min_rows: int = 8, mesh=None, ownership=None,
                 timers: StageTimers | None = None):
        self.store = store
        self.timers = (timers if timers is not None
                       else StageTimers(list(FEED_STAGES), emit_stages=set()))
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.min_rows = min_rows
        # the mesh this manager's table shards over (None: one device, or
        # a world of one, which lays out exactly as one device), and the
        # per-host shard ownership (None: the hash partition on a mesh,
        # every key without one)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.ownership = ownership
        # the H2D copies of staged rows run here, off the training stream
        self._side = (torch.cuda.Stream(device=self.device)
                      if self.device.type == "cuda" else None)
        # stores shared between trainers forbid resident reuse and lazy
        # write-back: rebuild + eager write-back
        self._eager = not getattr(store, "supports_resident_reuse", True)
        self._current: PassWorkingSet | None = None
        # the trainer's replica hot tier (set_replica), or None
        self._replica = None
        self._gen = -1                    # store.mutation_count at retain
        self._marker = None               # store.mutation_marker at retain
        # rows of _current whose device values are fresher than the store
        self._unsynced: np.ndarray | None = None
        self._thread: threading.Thread | None = None
        self._staged: _Staging | None = None
        self._feed_error: BaseException | None = None
        # set while a training pass updates the table in place: a flush
        # then would read rows mid-update, so it must refuse
        self._in_pass = False
        # the store flushes us before any read of row values. WeakMethod:
        # a collected manager must not pin its device table through the
        # store's hook list
        ref = weakref.WeakMethod(self.flush)

        def hook():
            fn = ref()
            if fn is not None:
                fn()

        self._hook = hook
        store.register_flush_hook(hook)
        # run at the start of flush(), before row values move D2H (the
        # trainer's deferred-push flush); weakly held like the store hook
        self._pre_flush: list = []
        self.last_h2d_bytes = 0
        self.last_d2h_bytes = 0
        self.last_fresh_rows = 0
        self.last_reused_rows = 0
        # resident rows re-fetched because a store mutation touched them,
        # and staged rows patched because the mutation landed after staging
        self.last_stale_rows = 0
        self.last_patched_rows = 0
        self.last_boundary_seconds = 0.0     # begin_pass side (the build)
        self.last_end_seconds = 0.0          # end_pass side (lazy: ~0)
        # the last boundary's host build (key diff + store fetch + table
        # assembly), H2D copy and the spill tier's fault-in inside the
        # build, charged where the work ran: a staged (overlapped) feed's
        # parts can exceed the boundary's wall time
        self.last_boundary_split = dict.fromkeys(_SPLIT_KEYS, 0.0)
        # fresh rows the last staging took from the replica tier
        self.last_replica_hits = 0

    # -- helpers -----------------------------------------------------------

    def _layout(self, keys: np.ndarray):
        """(this rank's keys, the pass's ShardLayout or None) for a
        sorted unique key set."""
        if self.mesh is None:
            o = self.ownership
            if o is None or o.owns_all():
                return keys, None
            return o.filter_keys(self.store, keys), None
        m = self.mesh
        lay = ShardLayout(keys, key_owners(keys, m.world, self.store,
                                           self.ownership),
                          m.world, m.rank, self.min_rows)
        return lay.local_keys, lay

    @staticmethod
    def _attach(ws: PassWorkingSet, layout) -> PassWorkingSet:
        if layout is not None:
            ws.attach_layout(layout)
        return ws

    def _stale_since(self, marker) -> np.ndarray | None:
        """Keys whose store bytes changed since ``marker`` (empty =
        clean); None = unknowable → full rebuild. Gated by
        ``flags.incremental_feed``."""
        if not flags.incremental_feed or marker is None:
            return None
        fn = getattr(self.store, "stale_keys_since", None)
        if fn is None:
            return None
        return fn(marker)

    def _marker_now(self):
        fn = getattr(self.store, "mutation_marker", None)
        return fn() if fn is not None else None

    def _resolve_reuse(self):
        """(prev, stale): the resident working set to diff the next pass
        against, and the resident keys whose store bytes changed since it
        was retained. prev=None → full rebuild."""
        if self._eager or self._current is None:
            return None, None
        if self.store.mutation_count == self._gen:
            return self._current, _EMPTY_KEYS
        stale = self._stale_since(self._marker)
        if stale is None:
            return None, None
        return self._current, stale

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """Queue the copy of one host array to the device. On the card:
        from a pinned buffer, asynchronously on the manager's stream (the
        caller waits with ``_upload``)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._side is None:
            return t.to(self.device)
        with torch.cuda.stream(self._side):
            return t.pin_memory().to(self.device, non_blocking=True)

    def _upload(self, host: np.ndarray):
        """Host f32 rows → the staged table under the storage and
        transfer settings (``upload_rows``), on the manager's stream,
        waited for on that stream only (training keeps running).
        Returns (table, bytes that crossed)."""
        if self._side is None:
            return upload_rows(host, self.store.cfg, self._put)
        with torch.cuda.stream(self._side):
            out = upload_rows(host, self.store.cfg, self._put)
        self._side.synchronize()
        return out

    def _consume(self, table):
        """Hand a table made on the manager's stream to the current one:
        order after the copy, and keep the caching allocator from giving
        its memory to the current stream's work while it is read there."""
        if self._side is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._side)
            for t in _planes(table):
                t.record_stream(cur)
        return table

    # -- feed pass (BeginFeedPass / WaitFeedPassDone) ----------------------

    def begin_feed_pass(self, keys: np.ndarray) -> None:
        """Stage pass N+1's working set on a background thread while pass
        N trains. Safe beside training: it reads only the current pass's
        key index (lookups, no inserts) and the host store (under the
        store lock), and copies the fresh rows on the manager's stream."""
        with self.timers("feed_wait"):
            self.wait_feed_pass_done()    # one feed in flight at a time
        keys = sorted_unique(np.asarray(keys).astype(np.uint64))
        keys, layout = self._layout(keys)
        n_rows = None if layout is None else layout.rows_per_shard
        prev, stale = self._resolve_reuse()
        gen = self.store.mutation_count
        marker = self._marker_now()

        def run():
            try:
                self._staged = self._stage(keys, prev, gen, marker=marker,
                                           stale_keys=stale, n_rows=n_rows)
            except BaseException as e:    # re-raised at the join
                self._feed_error = e

        # spawned with the caller's context: the staging's events carry
        # the pass that preloaded it
        self._thread = mon_ctx.spawn(run, name="pbt-feed-pass")
        self._thread.start()

    def wait_feed_pass_done(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._feed_error is not None:
            e, self._feed_error = self._feed_error, None
            self._staged = None
            raise e

    def _stage(self, keys: np.ndarray, prev: PassWorkingSet | None,
               gen: int, marker=None, stale_keys: np.ndarray | None = None,
               test_mode: bool = False, n_rows: int | None = None
               ) -> _Staging:
        """Diff ``keys`` against ``prev`` and put the fresh rows on the
        device; with prev=None, stage the full build instead.
        ``stale_keys`` (the incremental delta feed) are resident keys
        whose store bytes changed since retain: they re-fetch with the
        fresh rows. ``n_rows``: the table's rows (a mesh shard's
        rows_per_shard). Runs on the feed thread or synchronously."""
        cfg = self.store.cfg
        fault0 = tiering.fault_in_seconds(self.store)
        if prev is None:
            timing: dict = {}
            if self._side is not None:
                with torch.cuda.stream(self._side):
                    ws = PassWorkingSet.begin_pass(
                        self.store, keys, self.device,
                        min_rows=self.min_rows, test_mode=test_mode,
                        timing_out=timing, n_rows=n_rows)
            else:
                ws = PassWorkingSet.begin_pass(
                    self.store, keys, self.device, min_rows=self.min_rows,
                    test_mode=test_mode, timing_out=timing, n_rows=n_rows)
            timing["spill_fault_in"] = (tiering.fault_in_seconds(self.store)
                                        - fault0)
            return _Staging(keys=ws.sorted_keys, prev=None, store_gen=gen,
                            marker=marker, full_ws=ws,
                            n_fresh=len(ws.sorted_keys),
                            h2d_bytes=ws.h2d_bytes, timings=timing,
                            replica_hits=0, n_rows=n_rows)
        t0 = time.perf_counter()
        pos = prev._tindex.lookup(keys)            # -1 = fresh
        n_stale = 0
        if stale_keys is not None and len(stale_keys):
            # resident keys a store mutation touched re-fetch as fresh;
            # every other resident row stays on the device
            sp = np.searchsorted(stale_keys, keys)
            sp[sp >= len(stale_keys)] = 0
            is_stale = (stale_keys[sp] == keys) & (pos >= 0)
            n_stale = int(is_stale.sum())
            if n_stale:
                pos = np.where(is_stale, -1, pos).astype(pos.dtype)
        # the delta-stage crash window: fresh/stale rows are about to
        # leave the host store for the staging plane
        faultpoint.hit("feed_pass.delta_stage.pre")
        fresh_keys = keys[pos < 0]
        # the replica short-circuit: fresh keys the replica tier holds
        # (current per the stale-key log and the write-back invalidation)
        # skip the RAM/disk fault path. Replica keys already exist in the
        # store, so skipping lookup_or_init for them skips no insert.
        served = None
        if self._replica is not None and len(fresh_keys):
            served = self._replica.serve(fresh_keys)
        miss_keys = fresh_keys if served is None else fresh_keys[~served.hit]
        if flags.spill_prefetch:
            prefetch = getattr(self.store, "prefetch_rows", None)
            if prefetch is not None:
                prefetch(miss_keys)
        miss_rows = (self.store.peek_rows(miss_keys) if test_mode
                     else self.store.lookup_or_init(miss_keys))
        n_fresh = len(fresh_keys)
        n_fresh_pad = bucket_size(max(1, n_fresh))
        staged = np.zeros((n_fresh_pad, cfg.row_width), np.float32)
        # quantized and compressed transfers convert the served rows
        # through the same rounding as store-fetched ones, so they fill
        # on the host before the conversion; plain f32 fills on the
        # device from the replica plane below
        host_fill = cfg.storage != "f32" or embedx_compressed(cfg)
        if served is None:
            staged[:n_fresh] = miss_rows
        else:
            staged[np.flatnonzero(~served.hit)] = miss_rows
            if host_fill:
                staged[np.flatnonzero(served.hit)] = served.rows
        t1 = time.perf_counter()
        fresh_dev, nbytes = self._upload(staged)
        if served is not None and not host_fill:
            dst = torch.from_numpy(np.flatnonzero(served.hit)).to(
                self.device)
            src = torch.from_numpy(served.src).to(self.device)
            # the replica's plane is read on the current stream; the
            # staged plane was made on the manager's
            fresh_dev = self._consume(fresh_dev)
            fresh_dev.index_copy_(0, dst, served.plane.index_select(0, src))
        timing = {"build": t1 - t0, "h2d": time.perf_counter() - t1,
                  "spill_fault_in": (tiering.fault_in_seconds(self.store)
                                     - fault0)}
        # emitted from the feed thread when staging ran there
        mon_event("feed_pass_staged", n_fresh=int(n_fresh),
                  n_keys=int(len(keys)),
                  replica_hits=int(served.n if served is not None else 0),
                  h2d_bytes=int(nbytes))
        return _Staging(keys=keys, pos_prev=pos, fresh_dev=fresh_dev,
                        n_fresh=n_fresh, n_stale=n_stale, h2d_bytes=nbytes,
                        prev=prev, store_gen=gen, marker=marker,
                        full_ws=None, timings=timing,
                        replica_hits=0 if served is None else served.n,
                        n_rows=n_rows)

    # -- pass lifecycle ----------------------------------------------------

    def begin_pass(self, keys: np.ndarray,
                   test_mode: bool = False) -> PassWorkingSet:
        """Materialize the pass working set, reusing resident device rows.

        Consumes a matching staged feed if one exists; otherwise does the
        same work synchronously. test_mode passes (eval) reuse resident
        rows but never insert into the store, never retire or consume the
        retained table, and are not retained themselves. Its wall time,
        the queued copies and combine waited for, is
        ``last_boundary_seconds``."""
        with self.timers("feed_begin") as scope:
            ws = self._begin_pass(keys, test_mode)
        self.last_boundary_seconds = scope.seconds
        stat_set("feed_pass.boundary_seconds", round(scope.seconds, 6))
        return ws

    def _begin_pass(self, keys: np.ndarray,
                    test_mode: bool) -> PassWorkingSet:
        keys = sorted_unique(np.asarray(keys).astype(np.uint64))
        keys, layout = self._layout(keys)
        n_rows = None if layout is None else layout.rows_per_shard
        # join + resolve once: mutations happen only on this thread, so
        # the stale set cannot change between here and the consume below
        with self.timers("feed_wait"):
            self.wait_feed_pass_done()
        prev, stale = self._resolve_reuse()
        staged = self._take_staging(keys, test_mode, prev, n_rows)
        if prev is None and self._current is not None:
            # the store mutated beyond what the stale log can prove: the
            # external state wins, stale device rows must not leak back
            self._current = None
            self._unsynced = None
        if (prev is not None and stale is not None and stale.size
                and self._unsynced is not None and self._unsynced.any()):
            # rows the mutation touched: the store wins, so their unsynced
            # marks go before retirement or a flush could ship them
            pos_stale = prev._tindex.lookup(stale)
            live = pos_stale >= 0
            if live.any():
                self._unsynced[pos_stale[live] + 1] = False
        if staged is not None and staged.full_ws is not None:
            ws = staged.full_ws
            self._consume(ws.table)
            n_patch, patch_bytes = self._apply_patch(
                ws, staged.patch_keys, None)
            self._account_begin(staged.h2d_bytes + patch_bytes, 0,
                                staged.n_fresh, 0, split=staged.timings,
                                patched=n_patch)
            self.last_replica_hits = 0
            if not self._eager:
                self._retain(ws)
            return self._attach(ws, layout)
        if prev is None:
            timing: dict = {}
            fault0 = tiering.fault_in_seconds(self.store)
            ws = PassWorkingSet.begin_pass(
                self.store, keys, self.device, min_rows=self.min_rows,
                test_mode=test_mode, timing_out=timing, n_rows=n_rows)
            timing["spill_fault_in"] = (tiering.fault_in_seconds(self.store)
                                        - fault0)
            self._account_begin(ws.h2d_bytes, 0, len(ws.sorted_keys), 0,
                                split=timing)
            self.last_replica_hits = 0
            if not test_mode and not self._eager:
                self._retain(ws)
            return self._attach(ws, layout)
        if staged is None:
            staged = self._stage(keys, prev, self.store.mutation_count,
                                 stale_keys=stale, test_mode=test_mode,
                                 n_rows=n_rows)
        d2h = 0
        if not test_mode:
            with self.timers("writeback"):
                d2h = self._writeback_retiring(prev, keys)
        ws, carried = self._combine(staged, test_mode)
        n_patch, patch_bytes = self._apply_patch(ws, staged.patch_keys,
                                                 carried)
        self._account_begin(staged.h2d_bytes + patch_bytes, d2h,
                            staged.n_fresh, len(keys) - staged.n_fresh,
                            split=staged.timings,
                            patched=n_patch, stale=int(staged.n_stale or 0))
        self.last_replica_hits = int(staged.replica_hits or 0)
        if not test_mode:
            self._retain(ws, carried)
        return self._attach(ws, layout)

    def _apply_patch(self, ws: PassWorkingSet,
                     patch_keys: np.ndarray | None,
                     carried: np.ndarray | None) -> tuple[int, int]:
        """Overwrite the rows the store mutated after the background
        staging fetched them with their live store values, so the staged
        transfer survives the mutation. Returns (rows patched, H2D
        bytes)."""
        if patch_keys is None or len(patch_keys) == 0:
            return 0, 0
        pos = ws._tindex.lookup(patch_keys)
        live = pos >= 0
        pk = patch_keys[live]
        if len(pk) == 0:
            return 0, 0
        # the staged-patch arm of the delta-stage crash window
        faultpoint.hit("feed_pass.delta_stage.pre")
        rows = self.store.lookup_or_init(pk)
        idx = pos[live] + 1
        rows_dev, nbytes = self._upload(rows)
        rows_dev = self._consume(rows_dev)
        sel = torch.from_numpy(idx).to(self.device)
        for plane, new in zip(_planes(ws.table), _planes(rows_dev)):
            plane[sel, :new.shape[1]] = new
        if carried is not None:
            carried[idx] = False       # the store value is authoritative
        stat_add("feed_pass.patched_rows", len(pk))
        return len(pk), nbytes

    def _writeback_retiring(self, prev: PassWorkingSet,
                            new_keys: np.ndarray) -> int:
        """Ship rows that are unsynced and leaving the working set D2H:
        their device copy is about to go, and it is the only fresh one.
        Rows staying resident stay lazy. Returns bytes moved."""
        if self._unsynced is None or not self._unsynced.any():
            return 0
        k = prev.num_keys
        row_ids = np.flatnonzero(self._unsynced[1:1 + k]) + 1
        pkeys = prev.sorted_keys[row_ids - 1]
        # retiring = unsynced keys absent from the new pass (both sorted)
        pos = np.searchsorted(new_keys, pkeys)
        pos[pos >= len(new_keys)] = 0
        if len(new_keys):
            present = new_keys[pos] == pkeys
        else:
            present = np.zeros(len(pkeys), bool)
        retiring = row_ids[~present]
        if len(retiring) == 0:
            return 0
        rows, nbytes = fetch_rows(prev.table, retiring, self.store.cfg)
        rkeys = prev.sorted_keys[retiring - 1]
        self.store.write_back(rkeys, rows)
        if self._replica is not None:
            # write_back does not enter the stale-key log: the replica
            # must be told its copies of these keys are old
            self._replica.note_written(rkeys)
        self._unsynced[retiring] = False
        stat_add("feed_pass.retired_rows", len(retiring))
        return nbytes

    def flush(self) -> int:
        """Write every unsynced resident row back to the host store.
        Registered as a store flush hook, so save_base / save_delta /
        get_rows / shrink see fresh values without their callers knowing
        about the device tier. Returns the bytes moved D2H.

        Not legal while a training pass is open: the push kernels update
        the table in place, so rows read mid-pass would be half a pass
        old. Saves and shrinks belong between passes."""
        for ref in list(self._pre_flush):
            fn = ref()
            if fn is not None:
                fn()
        ws = self._current
        if (ws is None or ws.table is None or self._unsynced is None
                or not self._unsynced.any()):
            return 0
        if self._in_pass:
            raise RuntimeError(
                "sparse flush (store save/shrink/get_rows) while a "
                "training pass is open — finish the pass first")
        if self.store.mutation_count != self._gen:
            stale = self._stale_since(self._marker)
            if stale is None:
                # the store was rewritten beyond the stale log (restore):
                # stale device rows must not overwrite it
                self._unsynced[:] = False
                return 0
            if stale.size:
                # the mutation's rows lose their marks (the store wins for
                # exactly those); every other unsynced row still flushes
                pos = ws._tindex.lookup(stale)
                live = pos >= 0
                if live.any():
                    self._unsynced[pos[live] + 1] = False
            if not self._unsynced.any():
                return 0
        faultpoint.hit("feed_pass.flush.pre")
        k = ws.num_keys
        row_ids = np.flatnonzero(self._unsynced[1:1 + k]) + 1
        rows, nbytes = fetch_rows(ws.table, row_ids, self.store.cfg)
        fkeys = ws.sorted_keys[row_ids - 1]
        self.store.write_back(fkeys, rows)
        if self._replica is not None:
            self._replica.note_written(fkeys)
        self._unsynced[:] = False
        self.last_d2h_bytes += nbytes
        stat_add("feed_pass.d2h_bytes", nbytes)
        stat_add("feed_pass.flushed_rows", len(row_ids))
        mon_event("feed_pass_flush", rows=int(len(row_ids)),
                  d2h_bytes=int(nbytes))
        return nbytes

    def _take_staging(self, keys: np.ndarray, test_mode: bool,
                      prev: PassWorkingSet | None,
                      n_rows: int | None = None) -> _Staging | None:
        """Consume the background staging if it matches ``keys`` against
        the caller-resolved resident set."""
        staged, self._staged = self._staged, None
        if staged is None:
            return None
        if test_mode:
            # a staged feed inserted its fresh keys (train semantics);
            # keep it for the next train pass instead of consuming it
            self._staged = staged
            return None
        if (len(staged.keys) != len(keys)
                or not np.array_equal(staged.keys, keys)):
            return None                   # preloaded keys don't match
        if staged.n_rows != n_rows:
            return None                   # another shard geometry
        if staged.prev is not prev:
            # the resident set the staging diffed against is gone
            return None
        if staged.store_gen != self.store.mutation_count:
            # the store mutated while the staging was in flight: patch the
            # rows dirtied since staging instead of discarding it; a
            # mutation the log cannot bound makes the staging unusable
            patch = self._stale_since(staged.marker)
            if patch is None:
                return None
            staged.patch_keys = patch
        return staged

    def _combine(self, staged: _Staging, test_mode: bool
                 ) -> tuple[PassWorkingSet, np.ndarray]:
        """new_table[i] = fresh[slot] for fresh keys, else prev[src[i]]:
        one device gather of the resident rows, then the fresh rows
        copied into their slots."""
        cfg = self.store.cfg
        prev = staged.prev
        keys = staged.keys
        pos = staged.pos_prev
        k = len(keys)
        n_rows = (max(self.min_rows, k + 1) if staged.n_rows is None
                  else staged.n_rows)
        resident = pos >= 0
        src = np.zeros(n_rows, np.int64)       # fresh and tail rows: row 0
        src[1:1 + k][resident] = pos[resident] + 1
        dev = self.device
        sel = torch.from_numpy(src).to(dev)
        planes = [p.index_select(0, sel) for p in _planes(prev.table)]
        fresh_rows = np.flatnonzero(~resident) + 1   # key order = slot order
        if len(fresh_rows):
            fresh = _planes(self._consume(staged.fresh_dev))
            dst = torch.from_numpy(fresh_rows).to(dev)
            for plane, new in zip(planes, fresh):
                plane[dst, :new.shape[1]] = new[:len(fresh_rows)]
        table = _from_planes(planes)
        # carry the unsynced marks of resident rows into their new slots:
        # their only fresh copy still lives on the device
        carried = np.zeros(n_rows, bool)
        if self._unsynced is not None:
            carried[1:1 + k][resident] = self._unsynced[pos[resident] + 1]
        if not test_mode:
            prev.table = None             # the card holds one train table
        return PassWorkingSet(cfg, keys, table), carried

    def end_pass(self, ws: PassWorkingSet,
                 table: torch.Tensor | None = None) -> int:
        """Close the pass: retain the device table (the authoritative hot
        tier) and mark its touched rows unsynced. No data moves here; the
        bytes cross at retirement or flush. Eager stores write back now.
        Returns the bytes moved D2H."""
        t0 = time.perf_counter()
        if table is not None:
            ws.table = table
        if self.mesh is not None:
            # rows other ranks' batches touched on this shard
            ws.sync_touched(self.mesh)
        if self._eager:
            nbytes = ws.end_pass(self.store)
            if self._replica is not None:
                # the eager write-back pushed the pass's touched rows: the
                # whole key set is invalidated, conservatively
                self._replica.note_written(ws.sorted_keys)
            self.last_d2h_bytes = nbytes
            self.last_end_seconds = time.perf_counter() - t0
            stat_add("feed_pass.d2h_bytes", nbytes)
            return nbytes
        if ws is not self._current:
            self._retain(ws)
        if self._unsynced is None or len(self._unsynced) != len(ws.touched):
            self._unsynced = np.zeros_like(ws.touched)
        np.logical_or(self._unsynced, ws.touched, out=self._unsynced)
        self.last_d2h_bytes = 0
        # the begin-side boundary number stays as it is
        self.last_end_seconds = time.perf_counter() - t0
        stat_set("feed_pass.last_dirty_rows", int(ws.touched.sum()))
        return 0

    def set_replica(self, replica) -> None:
        """Attach the trainer's replica hot tier
        (``replica_cache.TrainerReplicaCache``): from then on a staging
        serves fresh keys from it when it can prove them current, and
        every write-back site invalidates the pushed keys there. None
        detaches."""
        self._replica = replica

    def set_ownership(self, ownership) -> None:
        """Bind or rebind the per-host shard ownership. On a rebind the
        pending device rows flush and the resident working set drops, so
        the next ``begin_pass`` builds exactly the newly owned shards'
        keys; an equal partition keeps the resident set."""
        if ownership is self.ownership or ownership == self.ownership:
            self.ownership = ownership
            return
        self.wait_feed_pass_done()
        if self._current is not None or self._staged is not None:
            self.drop()
        self.ownership = ownership

    def register_pre_flush(self, method) -> None:
        """Run a bound method at the start of flush(), before any row
        value moves D2H (weakly held, like the store hook)."""
        self._pre_flush.append(weakref.WeakMethod(method))

    def pass_opened(self) -> None:
        """Trainer hook: the table is being updated step to step; flushes
        refuse until pass_closed()."""
        self._in_pass = True

    def pass_closed(self) -> None:
        self._in_pass = False

    def drop(self) -> None:
        """Flush pending rows, then release the retained device table
        (the next pass falls back to a full host build)."""
        self.wait_feed_pass_done()
        self.flush()
        self._staged = None
        self._current = None
        self._unsynced = None
        self._gen = -1
        self._marker = None

    def close(self) -> None:
        """Flush, release the device tier and detach from the store's
        flush hooks. A new manager on the same store starts clean."""
        self.drop()
        self.store.unregister_flush_hook(self._hook)

    # -- bookkeeping -------------------------------------------------------

    def _retain(self, ws: PassWorkingSet,
                carried: np.ndarray | None = None) -> None:
        self._current = ws
        self._gen = self.store.mutation_count
        self._marker = self._marker_now()
        self._unsynced = (carried if carried is not None
                          else np.zeros_like(ws.touched))

    def _account_begin(self, h2d: int, d2h: int, fresh: int, reused: int,
                       split: dict | None = None, patched: int = 0,
                       stale: int = 0) -> None:
        if self.device.type == "cuda":
            # the copies and the combine are queued, not done: wait for
            # them, or the boundary reads near zero and its cost lands in
            # the first steps
            torch.cuda.synchronize(self.device)
        self.last_h2d_bytes = h2d
        self.last_d2h_bytes = d2h
        self.last_fresh_rows = fresh
        self.last_reused_rows = reused
        self.last_patched_rows = patched
        self.last_stale_rows = stale
        self.last_boundary_split = {k: float((split or {}).get(k, 0.0))
                                    for k in _SPLIT_KEYS}
        # counters, so each pass's flight record carries the fresh/reused
        # balance; the gauges mirror the last boundary
        stat_add("feed_pass.h2d_bytes", h2d)
        stat_add("feed_pass.d2h_bytes", d2h)
        stat_add("feed_pass.fresh_rows", fresh)
        if reused:
            stat_add("feed_pass.reused_rows", reused)
        if stale:
            stat_add("feed_pass.stale_rows", stale)
        stat_set("feed_pass.last_fresh_rows", fresh)
        stat_set("feed_pass.last_reused_rows", reused)
        stat_set("feed_pass.last_patched_rows", patched)
        stat_set("feed_pass.last_stale_rows", stale)
        stat_set("feed_pass.boundary_build_s",
                 round(self.last_boundary_split["build"], 6))
        stat_set("feed_pass.boundary_h2d_s",
                 round(self.last_boundary_split["h2d"], 6))
        stat_set("feed_pass.boundary_spill_fault_in_s",
                 round(self.last_boundary_split["spill_fault_in"], 6))
