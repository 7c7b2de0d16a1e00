"""Incremental, overlapped pass boundary — the port of ``FeedPassManager``
(``paddlebox_tpu/embedding/feed_pass.py``) for one device.

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

The reference's combine and patch are XLA programs, not Pallas kernels;
here they are plain torch (``index_select`` and indexed assignment).
The working set keeps the port's row rule, ``max(min_rows, K + 1)``
rows; ``bucket_size`` sizes only the staged H2D plane, as the
reference's does, and the patch plane is not padded.

Not carried (each raises ``NotImplementedError`` naming its ROADMAP
item): a device mesh and per-host shard ownership (queue 1 item 11), the
HBM replica tier, quantized or bf16-compressed staging and spill
prefetch (queue 1 item 9). The reference's telemetry counters wait for
the port's monitor (queue 1 item 12); the ``last_*`` attributes carry
the numbers.
"""

from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.embedding.working_set import (PassWorkingSet,
                                                       bucket_size,
                                                       fetch_rows,
                                                       transfer_bytes)
from paddlebox_tpu_torch.native.key_index import sorted_unique
from paddlebox_tpu_torch.utils import faultpoint

_EMPTY_KEYS = np.zeros(0, dtype=np.uint64)


class _Staging:
    """Result of one feed pass: fresh rows staged on the device + the
    diff."""

    __slots__ = ("keys", "pos_prev", "fresh_dev", "n_fresh", "h2d_bytes",
                 "prev", "store_gen", "full_ws", "timings", "marker",
                 "patch_keys", "n_stale")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class FeedPassManager:
    """Owns the persistent device working set across passes."""

    def __init__(self, store: HostEmbeddingStore,
                 device: str | torch.device | None = None,
                 min_rows: int = 8, mesh=None, ownership=None):
        if mesh is not None:
            raise NotImplementedError(
                "FeedPassManager(mesh=...): multi-device tables are not "
                "ported yet (ROADMAP, queue 1 item 11)")
        if ownership is not None:
            raise NotImplementedError(
                "FeedPassManager(ownership=...): per-host shard ownership "
                "is not ported yet (ROADMAP, queue 1 item 11)")
        self.store = store
        self.device = resolve_device(device)
        self.min_rows = min_rows
        # the H2D copies of staged rows run here, off the training stream
        self._side = (torch.cuda.Stream(device=self.device)
                      if self.device.type == "cuda" else None)
        # stores shared between trainers forbid resident reuse and lazy
        # write-back: rebuild + eager write-back
        self._eager = not getattr(store, "supports_resident_reuse", True)
        self._current: PassWorkingSet | None = None
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
        # assembly) and H2D copy, charged where the work ran: a staged
        # (overlapped) feed's parts can exceed the boundary's wall time
        self.last_boundary_split = {"build": 0.0, "h2d": 0.0}

    # -- helpers -----------------------------------------------------------

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

    def _h2d(self, host: np.ndarray) -> torch.Tensor:
        """Copy host rows to the device. On the card: from a pinned
        buffer, asynchronously on the manager's stream, then wait on that
        stream only (the training stream keeps running)."""
        if self._side is None:
            return torch.from_numpy(host).to(self.device)
        pinned = torch.empty(host.shape, dtype=torch.float32,
                             pin_memory=True)
        pinned.numpy()[...] = host
        with torch.cuda.stream(self._side):
            out = pinned.to(self.device, non_blocking=True)
        self._side.synchronize()
        return out

    def _consume(self, t: torch.Tensor) -> torch.Tensor:
        """Hand a tensor made on the manager's stream to the current one:
        order after the copy, and keep the caching allocator from giving
        its memory to the current stream's work while it is read there."""
        if self._side is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._side)
            t.record_stream(cur)
        return t

    # -- feed pass (BeginFeedPass / WaitFeedPassDone) ----------------------

    def begin_feed_pass(self, keys: np.ndarray) -> None:
        """Stage pass N+1's working set on a background thread while pass
        N trains. Safe beside training: it reads only the current pass's
        key index (lookups, no inserts) and the host store (under the
        store lock), and copies the fresh rows on the manager's stream."""
        self.wait_feed_pass_done()        # one feed in flight at a time
        keys = sorted_unique(np.asarray(keys).astype(np.uint64))
        prev, stale = self._resolve_reuse()
        gen = self.store.mutation_count
        marker = self._marker_now()

        def run():
            try:
                self._staged = self._stage(keys, prev, gen, marker=marker,
                                           stale_keys=stale)
            except BaseException as e:    # re-raised at the join
                self._feed_error = e

        # pblint: disable=thread-context -- the port has no
        # monitor.context to inherit yet (ROADMAP queue 1 item 12): the
        # feed thread emits no telemetry
        self._thread = threading.Thread(target=run, name="pbt-feed-pass",
                                        daemon=True)
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
               test_mode: bool = False) -> _Staging:
        """Diff ``keys`` against ``prev`` and put the fresh rows on the
        device; with prev=None, stage the full build instead.
        ``stale_keys`` (the incremental delta feed) are resident keys
        whose store bytes changed since retain: they re-fetch with the
        fresh rows. Runs on the feed thread or synchronously."""
        cfg = self.store.cfg
        if prev is None:
            timing: dict = {}
            if self._side is not None:
                with torch.cuda.stream(self._side):
                    ws = PassWorkingSet.begin_pass(
                        self.store, keys, self.device,
                        min_rows=self.min_rows, test_mode=test_mode,
                        timing_out=timing)
            else:
                ws = PassWorkingSet.begin_pass(
                    self.store, keys, self.device, min_rows=self.min_rows,
                    test_mode=test_mode, timing_out=timing)
            return _Staging(keys=ws.sorted_keys, prev=None, store_gen=gen,
                            marker=marker, full_ws=ws,
                            n_fresh=len(ws.sorted_keys),
                            h2d_bytes=transfer_bytes(cfg, ws.padded_rows),
                            timings=timing)
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
        rows = (self.store.peek_rows(fresh_keys) if test_mode
                else self.store.lookup_or_init(fresh_keys))
        n_fresh = len(fresh_keys)
        n_fresh_pad = bucket_size(max(1, n_fresh))
        staged = np.zeros((n_fresh_pad, cfg.row_width), np.float32)
        staged[:n_fresh] = rows
        t1 = time.perf_counter()
        fresh_dev = self._h2d(staged)
        timing = {"build": t1 - t0, "h2d": time.perf_counter() - t1}
        return _Staging(keys=keys, pos_prev=pos, fresh_dev=fresh_dev,
                        n_fresh=n_fresh, n_stale=n_stale,
                        h2d_bytes=transfer_bytes(cfg, n_fresh_pad),
                        prev=prev, store_gen=gen, marker=marker,
                        full_ws=None, timings=timing)

    # -- pass lifecycle ----------------------------------------------------

    def begin_pass(self, keys: np.ndarray,
                   test_mode: bool = False) -> PassWorkingSet:
        """Materialize the pass working set, reusing resident device rows.

        Consumes a matching staged feed if one exists; otherwise does the
        same work synchronously. test_mode passes (eval) reuse resident
        rows but never insert into the store, never retire or consume the
        retained table, and are not retained themselves."""
        t0 = time.perf_counter()
        keys = sorted_unique(np.asarray(keys).astype(np.uint64))
        # join + resolve once: mutations happen only on this thread, so
        # the stale set cannot change between here and the consume below
        self.wait_feed_pass_done()
        prev, stale = self._resolve_reuse()
        staged = self._take_staging(keys, test_mode, prev)
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
                                staged.n_fresh, 0, t0, ws.table,
                                split=staged.timings, patched=n_patch)
            if not self._eager:
                self._retain(ws)
            return ws
        if prev is None:
            timing: dict = {}
            ws = PassWorkingSet.begin_pass(
                self.store, keys, self.device, min_rows=self.min_rows,
                test_mode=test_mode, timing_out=timing)
            self._account_begin(
                transfer_bytes(self.store.cfg, ws.padded_rows), 0,
                len(ws.sorted_keys), 0, t0, ws.table, split=timing)
            if not test_mode and not self._eager:
                self._retain(ws)
            return ws
        if staged is None:
            staged = self._stage(keys, prev, self.store.mutation_count,
                                 stale_keys=stale, test_mode=test_mode)
        d2h = 0
        if not test_mode:
            d2h = self._writeback_retiring(prev, keys)
        ws, carried = self._combine(staged, test_mode)
        n_patch, patch_bytes = self._apply_patch(ws, staged.patch_keys,
                                                 carried)
        self._account_begin(staged.h2d_bytes + patch_bytes, d2h,
                            staged.n_fresh, len(keys) - staged.n_fresh, t0,
                            ws.table, split=staged.timings,
                            patched=n_patch, stale=int(staged.n_stale or 0))
        if not test_mode:
            self._retain(ws, carried)
        return ws

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
        rows_dev = self._consume(self._h2d(rows))
        sel = torch.from_numpy(idx).to(self.device)
        ws.table[sel, :rows.shape[1]] = rows_dev
        if carried is not None:
            carried[idx] = False       # the store value is authoritative
        return len(pk), transfer_bytes(self.store.cfg, len(pk))

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
        self.store.write_back(prev.sorted_keys[retiring - 1], rows)
        self._unsynced[retiring] = False
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
        self.store.write_back(ws.sorted_keys[row_ids - 1], rows)
        self._unsynced[:] = False
        self.last_d2h_bytes += nbytes
        return nbytes

    def _take_staging(self, keys: np.ndarray, test_mode: bool,
                      prev: PassWorkingSet | None) -> _Staging | None:
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
        n_rows = max(self.min_rows, k + 1)
        resident = pos >= 0
        src = np.zeros(n_rows, np.int64)       # fresh and tail rows: row 0
        src[1:1 + k][resident] = pos[resident] + 1
        dev = self.device
        table = prev.table.index_select(0, torch.from_numpy(src).to(dev))
        fresh_rows = np.flatnonzero(~resident) + 1   # key order = slot order
        if len(fresh_rows):
            fresh = self._consume(staged.fresh_dev)
            table[torch.from_numpy(fresh_rows).to(dev), :cfg.row_width] = \
                fresh[:len(fresh_rows)]
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
        if self._eager:
            nbytes = ws.end_pass(self.store)
            self.last_d2h_bytes = nbytes
            self.last_end_seconds = time.perf_counter() - t0
            return nbytes
        if ws is not self._current:
            self._retain(ws)
        if self._unsynced is None or len(self._unsynced) != len(ws.touched):
            self._unsynced = np.zeros_like(ws.touched)
        np.logical_or(self._unsynced, ws.touched, out=self._unsynced)
        self.last_d2h_bytes = 0
        # the begin-side boundary number stays as it is
        self.last_end_seconds = time.perf_counter() - t0
        return 0

    def set_replica(self, replica) -> None:
        if replica is not None:
            raise NotImplementedError(
                "the HBM replica tier is not ported yet (ROADMAP, queue 1 "
                "item 9)")

    def set_ownership(self, ownership) -> None:
        if ownership is not None:
            raise NotImplementedError(
                "per-host shard ownership is not ported yet (ROADMAP, "
                "queue 1 item 11)")

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
                       t0: float, table: torch.Tensor,
                       split: dict | None = None, patched: int = 0,
                       stale: int = 0) -> None:
        if table.device.type == "cuda":
            # the copies and the combine are queued, not done: wait for
            # them, or the boundary reads near zero and its cost lands in
            # the first steps
            torch.cuda.synchronize(table.device)
        self.last_boundary_seconds = time.perf_counter() - t0
        self.last_h2d_bytes = h2d
        self.last_d2h_bytes = d2h
        self.last_fresh_rows = fresh
        self.last_reused_rows = reused
        self.last_patched_rows = patched
        self.last_stale_rows = stale
        self.last_boundary_split = {k: float((split or {}).get(k, 0.0))
                                    for k in ("build", "h2d")}
