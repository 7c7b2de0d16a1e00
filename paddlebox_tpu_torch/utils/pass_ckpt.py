"""Crash-safe pass snapshots and resume — the port of ``PassCheckpointer``
(``paddlebox_tpu/utils/pass_ckpt.py:85``).

A snapshot restores every plane a pass touches:

- dense params + optimizer state (``dense.npz``, the JAX package's tree
  layout: ``Trainer.dense_state`` / ``restore_dense``);
- the sparse table as a base-or-delta chain (``store.save_base`` /
  ``save_delta`` into ``chain-NNNN/``; a fresh base every ``base_every``
  passes, and whenever another writer saved the store since our last
  snapshot);
- the metric registry's states (``metrics.npz``) and the phase bit;
- the cursor: ``pass_id``, ``global_step``, ``date``, ``phase``,
  ``mid_steps`` and the dataset's ``shuffle_state``.

Commit protocol: every member lands atomically (tmp → fsync → replace);
the snapshot's ``MANIFEST.json`` — the cursor, the chain members' CRC32s
and the snapshot's own files' — is written LAST. ``resume`` walks
snapshots newest-first and restores the first that fully verifies,
falling back past a torn one with a warning. ``keep_last_n`` prunes old
snapshots and any chain no surviving snapshot references. ``save`` first
flushes the trainer's lazily retained device rows
(``Trainer.flush_sparse``), so the sparse member holds every pass's
updates; ``last_save`` records that flush's seconds and bytes.

A mid-pass snapshot (``save(mid_steps > 0)``, written by the trainer's
``enable_midpass_snapshots`` hook or ``drain_and_snapshot``) is named
``pass-PPPPP.midSSSSS``: ``pass_id`` is the last completed pass, the
cursor's ``mid_steps`` the steps of the open pass already trained, and
``dense_override`` carries the live dense state. Its cursor feeds
``Trainer.train_pass(skip_steps=mid_steps)``.

The directory layout and every file are the reference's, so a snapshot
root written by either package, mid-pass ones included, resumes in the
other. Each save and resume counts its seconds and bytes in the monitor
(``ckpt.*``), emits ``checkpoint_save`` / ``checkpoint_resume`` (and
``checkpoint_torn_fallback``, ``checkpoint_timeline_reset``), and marks
a ``checkpoint_commit`` instant in the chrome trace; ``last_save`` /
``last_resume`` keep the same numbers with the flush's.

Remote roots (``hdfs://``, ``afs://``, any scheme registered with
``utils.fs``): the checkpointer stages under ``staging_dir`` (a fresh
temp dir by default), runs the whole local commit there, then mirrors
the snapshot up — the whole chain after a rotation, only the new delta
member after a delta save — and appends a line to the remote
``snapshots.donefile`` only after every byte landed, so the donefile
names complete uploads only. A resume into an empty staging dir reads
the donefile newest-first, downloads up to ``keep_last_n`` entries,
verifies each and falls back past one that fails to download or
verify. Retention prunes the remote root too (the donefile shrinks
first, through a ``.compact`` staging copy that a later save repairs
from if the rewrite was interrupted), and ``resume(at=...)`` masks the
abandoned timeline's entries with a ``reset_after`` line. Uploads and
downloads count under ``ckpt.remote_*`` with their events; the windows
``remote_ckpt.upload.pre`` and ``remote_ckpt.download.pre`` are fault
points. ``last_save["remote_upload"]`` and
``last_resume["remote_download"]`` carry their seconds and bytes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
import warnings
from typing import Any

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags as config_flags
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import fs as fs_lib
from paddlebox_tpu_torch.utils import profiler
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

_PASS_RE = re.compile(r"^pass-(\d+)(?:\.mid(\d+))?$")
_CHAIN_RE = re.compile(r"^chain-(\d+)$")

REMOTE_DONEFILE = "snapshots.donefile"


def _metric_tree(metrics) -> dict[str, Any]:
    return {name: metrics.get_state(name) for name in metrics.names()}


def _tree_bytes(path: str) -> int:
    """Bytes of the files under ``path`` (a file or a directory)."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


class PassCheckpointer:
    """Owns one snapshot root. One instance per training job; the
    training loop calls :meth:`save` at every pass boundary (directly or through
    ``BoxPS.end_pass``) and :meth:`resume` once at startup.

    ``root`` may be a remote URI: snapshots then stage under
    ``staging_dir`` (a fresh temp dir by default; the remote root is the
    authority across host loss) and mirror up after each local
    commit."""

    def __init__(self, root: str, keep_last_n: int | None = None,
                 base_every: int | None = None,
                 staging_dir: str | None = None):
        if fs_lib.is_remote(root):
            fs_lib.resolve(root)    # an unregistered scheme raises here
            self.remote_root: str | None = root.rstrip("/")
            self.root = staging_dir or tempfile.mkdtemp(
                prefix="pbt_ckpt_stage_")
        else:
            self.remote_root = None
            self.root = fs_lib.resolve(root)[1]
        self.keep_last_n = (config_flags.ckpt_keep_last_n
                            if keep_last_n is None else int(keep_last_n))
        if self.keep_last_n < 2:
            # fallback-past-a-torn-newest needs at least one predecessor
            raise ValueError("keep_last_n must be >= 2 for crash safety")
        self.base_every = (config_flags.ckpt_base_every
                           if base_every is None else int(base_every))
        os.makedirs(self.root, exist_ok=True)
        self._chain_gen = 0
        self._chain_dir: str | None = None
        self._deltas_in_chain = 0
        # chains whose whole directory this process already mirrored up:
        # a chain continued across a restart re-uploads whole once, then
        # rides the incremental per-delta path
        self._uploaded_chains: set[str] = set()
        self._remote_synced = False
        # store.save_count as of OUR last save/resume: any foreign save in
        # between (a FleetUtil model sharing the store) consumed the dirty
        # mask and tombstones, so the next snapshot must be a full base
        self._expect_count: int | None = None
        # what the last save / resume cost: {seconds, bytes, ...}
        self.last_save: dict | None = None
        self.last_resume: dict | None = None
        # what the last remote sync cost (a remote root's resume into an
        # empty staging dir): {seconds, bytes, snapshots}
        self.last_download: dict | None = None

    # ---- paths -----------------------------------------------------------

    def snap_name(self, pass_id: int, mid_steps: int = 0) -> str:
        """``pass-PPPPP`` for a pass-boundary snapshot; a mid-pass one is
        ``pass-PPPPP.midSSSSS``. Name order == (pass_id, mid_steps)
        cursor order."""
        name = f"pass-{pass_id:05d}"
        if mid_steps:
            name += f".mid{mid_steps:05d}"
        return name

    def snap_dir(self, pass_id: int, mid_steps: int = 0) -> str:
        return os.path.join(self.root, self.snap_name(pass_id, mid_steps))

    def _chain_path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def _list_snaps(self) -> list[tuple[int, int, str]]:
        """[(pass_id, mid_steps, path)] sorted ascending by cursor."""
        out = []
        for n in os.listdir(self.root):
            m = _PASS_RE.match(n)
            if m and os.path.isdir(os.path.join(self.root, n)):
                out.append((int(m.group(1)), int(m.group(2) or 0),
                            os.path.join(self.root, n)))
        return sorted(out)

    # ---- save ------------------------------------------------------------

    def save(self, trainer, box=None, metrics=None,
             pass_id: int | None = None, mid_steps: int = 0,
             dense_override: tuple | None = None,
             shuffle_state: dict | None = None) -> str:
        """Snapshot the complete post-pass state; returns the snapshot
        directory. Members land in dependency order (sparse chain → dense
        → metrics), manifest last: a kill anywhere before the manifest
        commit leaves this snapshot invisible and the previous one
        intact.

        ``mid_steps`` > 0 marks a mid-pass snapshot: ``pass_id`` is then
        the last completed pass and the cursor records how many steps of
        the open pass are trained. ``dense_override`` = (params,
        opt_state) NumPy trees in the JAX layout replaces
        ``trainer.dense_state()`` (the trainer's mid-pass hook passes
        the live state). ``shuffle_state`` rides the cursor."""
        t_save0 = time.perf_counter()
        if pass_id is None:
            if box is None:
                raise ValueError("save needs pass_id or a BoxPS")
            pass_id = int(box.pass_id)
        metrics = metrics if metrics is not None else (
            box.metrics if box is not None else None)
        # write-back is lazy: the rows the card still holds move to the
        # store first, so the sparse save below sees every pass's updates
        t_flush0 = time.perf_counter()
        flush_bytes = trainer.flush_sparse()
        flush_seconds = time.perf_counter() - t_flush0

        # sparse plane: a fresh base chain on the first save, every
        # base_every-th pass after, and whenever another writer saved the
        # store since our last snapshot (its save consumed the dirty rows
        # a delta would need). Chain bookkeeping commits only after the
        # store save succeeds.
        store = trainer.store
        rotate = (self._chain_dir is None
                  or (self.base_every > 0
                      and self._deltas_in_chain >= self.base_every - 1)
                  or store.save_count != self._expect_count)
        t_sparse0 = time.perf_counter()
        if rotate:
            gen = self._chain_gen + 1
            chain_name = f"chain-{gen:04d}"
            store.save_base(self._chain_path(chain_name), pass_id=pass_id)
            self._chain_gen = gen
            self._chain_dir = chain_name
            self._deltas_in_chain = 0
        else:
            chain_name = self._chain_dir
            store.save_delta(self._chain_path(chain_name), pass_id=pass_id)
            self._deltas_in_chain += 1
        sparse_seconds = time.perf_counter() - t_sparse0
        save_seq = store.save_seq
        self._expect_count = store.save_count
        chain_files = store.chain_file_entries(self._chain_path(chain_name),
                                               save_seq)
        # what a delta save touched: the incremental upload set
        incr_members = (None if rotate
                        else store.chain_increment_members(save_seq))

        snap = self.snap_dir(pass_id, mid_steps)
        os.makedirs(snap, exist_ok=True)
        files: dict[str, dict] = {}
        dense_f = os.path.join(snap, "dense.npz")
        dense_tree = (trainer.dense_state() if dense_override is None
                      else {"params": dense_override[0],
                            "opt_state": dense_override[1]})
        ckpt_lib.save_tree(dense_tree, dense_f)
        files["dense.npz"] = ckpt_lib.file_entry(dense_f)
        if metrics is not None and metrics.names():
            met_f = os.path.join(snap, "metrics.npz")
            ckpt_lib.save_tree(_metric_tree(metrics), met_f)
            files["metrics.npz"] = ckpt_lib.file_entry(met_f)

        cursor = {
            "pass_id": int(pass_id),
            "global_step": int(trainer.global_step),
            "date": None if box is None else box.date,
            "phase": None if metrics is None else int(metrics.phase),
            "mid_steps": int(mid_steps),
            "shuffle_state": shuffle_state,
        }
        if mid_steps:
            parent = self.snap_name(pass_id)          # the completed pass
        else:
            parent = self.snap_name(pass_id - 1) if pass_id > 1 else None
        faultpoint.hit("pass_ckpt.pre_manifest")
        ckpt_lib.write_manifest(
            snap, files, cursor=cursor, save_seq=save_seq,
            chain_dir=chain_name, chain_files=chain_files,
            parent_snapshot=parent)
        faultpoint.hit("pass_ckpt.post_manifest")
        seconds = time.perf_counter() - t_save0
        sparse_member = ("base.npz" if rotate
                         else f"delta-{save_seq:05d}.npz")
        sparse_bytes = chain_files[sparse_member]["bytes"]
        nbytes = sum(e["bytes"] for e in files.values()) + sparse_bytes
        monitor.counter_add("ckpt.saves")
        monitor.counter_add("ckpt.save_seconds", seconds)
        monitor.counter_add("ckpt.bytes", nbytes)
        if rotate:
            monitor.counter_add("ckpt.base_rotations")
        if mid_steps:
            monitor.counter_add("ckpt.midpass_saves")
        monitor.event("checkpoint_save", type="lifecycle",
                      snapshot=os.path.basename(snap), seconds=seconds,
                      bytes=int(nbytes), rotated=bool(rotate),
                      chain=chain_name, save_seq=int(save_seq),
                      mid_steps=int(mid_steps))
        profiler.record_instant("checkpoint_commit",
                                {"snapshot": os.path.basename(snap)})
        self.last_save = {
            "snapshot": os.path.basename(snap), "rotated": bool(rotate),
            "seconds": seconds, "bytes": nbytes,
            "sparse_member": sparse_member, "sparse_seconds": sparse_seconds,
            "sparse_bytes": sparse_bytes, "flush_seconds": flush_seconds,
            "flush_bytes": int(flush_bytes)}
        if self.remote_root is not None:
            self.last_save["remote_upload"] = self._upload(
                snap, chain_name, rotate, save_seq, cursor, incr_members)
        self._prune()
        return snap

    # ---- remote mirror ---------------------------------------------------

    def _remote_fs(self):
        return fs_lib.resolve(self.remote_root)[0]

    def _upload(self, snap: str, chain_name: str, rotated: bool,
                save_seq: int, cursor: dict,
                incr_members: list[str] | None) -> dict:
        """Mirror the just-committed snapshot to the remote root; the
        donefile line lands only after every byte uploaded, so a kill
        anywhere in here leaves the donefile naming complete uploads
        only (the local commit already happened). Returns {seconds,
        bytes}."""
        t0 = time.perf_counter()
        faultpoint.hit("remote_ckpt.upload.pre")
        fs = self._remote_fs()
        rroot = self.remote_root
        snap_name = os.path.basename(snap)
        local_chain = self._chain_path(chain_name)
        remote_chain = f"{rroot}/{chain_name}"
        try:
            fs.makedirs(rroot)
            if (rotated or incr_members is None
                    or chain_name not in self._uploaded_chains):
                # the whole chain: a fresh rotation, or a chain continued
                # across a restart (its remote contents are unknown)
                fs_lib.put_replacing(fs, local_chain, remote_chain)
                nbytes = _tree_bytes(local_chain)
            else:
                # incremental: only what the delta save touched
                for d in sorted({os.path.dirname(m) for m in incr_members
                                 if "/" in m}):
                    fs.makedirs(f"{remote_chain}/{d}")
                nbytes = 0
                for name in incr_members:
                    fs.put(os.path.join(local_chain, name),
                           f"{remote_chain}/{name}")
                    nbytes += _tree_bytes(os.path.join(local_chain, name))
            self._uploaded_chains.add(chain_name)
            # a leftover target (a torn upload, a re-save after an
            # elected rollback) must never nest the source
            fs_lib.put_replacing(fs, snap, f"{rroot}/{snap_name}")
            nbytes += _tree_bytes(snap)
        except BaseException:
            # a half-uploaded chain must not ride the incremental path on
            # the next save: force a whole re-upload
            self._uploaded_chains.discard(chain_name)
            raise
        line = json.dumps({"pass": int(cursor["pass_id"]),
                           "mid": int(cursor["mid_steps"]),
                           "snapshot": snap_name, "chain": chain_name,
                           "save_seq": int(save_seq),
                           "ts": int(time.time())})
        self._repair_donefile(fs)
        # pblint: disable=donefile-discipline -- snapshots.donefile is the
        # checkpoint mirror's own resume channel, not a model-visibility
        # donefile: it needs reset-line masking and two-phase compaction,
        # which FleetUtil.append_donefile does not express
        fs.write_text(f"{rroot}/{REMOTE_DONEFILE}", line + "\n",
                      append=True)
        seconds = time.perf_counter() - t0
        monitor.counter_add("ckpt.remote_uploads")
        monitor.counter_add("ckpt.remote_upload_seconds", seconds)
        monitor.event("checkpoint_remote_upload", type="lifecycle",
                      snapshot=snap_name, chain=chain_name,
                      seconds=seconds)
        return {"seconds": seconds, "bytes": int(nbytes)}

    def _read_donefile_raw(self) -> list[str]:
        """Raw donefile lines; the ``.compact`` staging copy when the
        main file is missing (a compaction uploads the compacted content
        there first, so a kill between the main file's rm and put never
        loses the donefile)."""
        fs = self._remote_fs()
        path = f"{self.remote_root}/{REMOTE_DONEFILE}"
        if not fs.exists(path):
            alt = f"{path}.compact"
            if not fs.exists(alt):
                return []
            path = alt
        return [ln.strip() for ln in fs.read_lines(path) if ln.strip()]

    def _repair_donefile(self, fs) -> None:
        """Finish an interrupted compaction before appending: with only
        the ``.compact`` copy left, an append would recreate the main
        file with one line and shadow the whole history (and the next
        prune would reclaim every "unreferenced" directory)."""
        path = f"{self.remote_root}/{REMOTE_DONEFILE}"
        alt = f"{path}.compact"
        if fs.exists(path) or not fs.exists(alt):
            return
        tmp = os.path.join(self.root, f".donefile.repair.{os.getpid()}")
        try:
            fs.get(alt, tmp)
            # pblint: disable=donefile-discipline -- compaction-crash
            # repair of the mirror's own snapshots.donefile from its
            # .compact staging copy
            fs.put(tmp, path)
            fs.rm(alt)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        monitor.counter_add("ckpt.donefile_repairs")
        monitor.event("donefile_repaired", type="lifecycle")

    def _remote_entries(self, raw_lines: list[str] | None = None
                        ) -> list[dict]:
        """Donefile entries in append order, ``reset_after`` lines
        applied: an elected rollback masks the abandoned timeline's newer
        entries so no later restore resurrects them."""
        out: list[dict] = []
        for raw in (self._read_donefile_raw() if raw_lines is None
                    else raw_lines):
            e = json.loads(raw)
            if "reset_after" in e:
                ra = tuple(e["reset_after"])
                out = [x for x in out
                       if (int(x["pass"]), int(x.get("mid", 0))) <= ra]
            else:
                out.append(e)
        return out

    def _sync_from_remote(self) -> bool:
        """Fill the local staging root from the remote donefile: up to
        ``keep_last_n`` entries, newest first (a chain shared between
        entries crosses the wire once), each downloaded to a temp dir,
        landed and verified; an entry that fails to download or verify
        is skipped with a diagnostic. True when at least one verified
        snapshot landed; ``last_download`` holds {seconds, bytes,
        snapshots}."""
        self._remote_synced = True
        t0 = time.perf_counter()
        try:
            entries = self._remote_entries()
        except (RuntimeError, ValueError, OSError) as e:
            warnings.warn(f"remote snapshot donefile unreadable ({e}); "
                          f"starting fresh")
            return False
        fs = self._remote_fs()
        landed: list[str] = []
        nbytes = 0
        got_chains: set[str] = set()
        for e in reversed(entries):
            if len(landed) >= self.keep_last_n:
                break
            snap_name, chain_name = e["snapshot"], e["chain"]
            try:
                faultpoint.hit("remote_ckpt.download.pre")
                names = [chain_name] if chain_name not in got_chains \
                    else []
                names.append(snap_name)
                with tempfile.TemporaryDirectory(dir=self.root) as tmp:
                    for name in names:
                        fs.get(f"{self.remote_root}/{name}",
                               os.path.join(tmp, name))
                    got = sum(_tree_bytes(os.path.join(tmp, n))
                              for n in names)
                    for name in names:
                        dst = os.path.join(self.root, name)
                        shutil.rmtree(dst, ignore_errors=True)
                        os.replace(os.path.join(tmp, name), dst)
                self._verify_snapshot(os.path.join(self.root, snap_name))
            except (RuntimeError, OSError, CheckpointCorruptError) as err:
                monitor.counter_add("ckpt.remote_fallbacks")
                monitor.event("checkpoint_remote_fallback",
                              type="lifecycle", snapshot=snap_name,
                              error=str(err)[:300])
                warnings.warn(
                    f"remote snapshot {snap_name} failed to restore "
                    f"({err}); falling back to the previous donefile "
                    f"entry")
                continue
            got_chains.add(chain_name)
            landed.append(snap_name)
            nbytes += got
            monitor.counter_add("ckpt.remote_downloads")
            monitor.event("checkpoint_remote_download", type="lifecycle",
                          snapshot=snap_name, chain=chain_name)
        self.last_download = {"seconds": time.perf_counter() - t0,
                              "bytes": int(nbytes), "snapshots": landed}
        return bool(landed)

    # ---- discovery / verification ---------------------------------------

    def _verify_snapshot(self, snap: str) -> dict:
        """Full verification: manifest present, snapshot members checksum
        clean, and the sparse chain prefix it references intact — against
        the CRCs the snapshot itself recorded (the chain's live manifest
        may already describe a newer save)."""
        manifest = ckpt_lib.verify_manifest(snap)
        try:
            int(manifest["cursor"]["pass_id"])     # resume depends on it
            int(manifest["cursor"]["global_step"])
            chain_dir = self._chain_path(manifest["chain_dir"])
            if any("/" in n for n in manifest.get("chain_files", {})):
                # a store-defined layout (the JAX package's sharded
                # store): verify exactly what the snapshot recorded
                need = sorted(manifest["chain_files"])
            else:
                need = (["base.npz"]
                        + [f"delta-{i:05d}.npz"
                           for i in range(1,
                                          int(manifest["save_seq"]) + 1)])
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointCorruptError(
                os.path.join(snap, ckpt_lib.MANIFEST_NAME),
                f"snapshot manifest missing/invalid field ({e!r})")
        chain_files = manifest.get("chain_files", {})
        try:
            ckpt_lib.verify_manifest(chain_dir, {"files": chain_files},
                                     only=need)
        except CheckpointCorruptError as e:
            rel = os.path.relpath(e.fname, chain_dir).replace(os.sep, "/")
            pos = need.index(rel) if rel in need else -1
            raise CheckpointCorruptError(
                e.fname,
                f"chain member #{pos} of the {len(need)} recorded in "
                f"snapshot {os.path.basename(snap)}: {e}") from e
        return manifest

    def intact_cursors(self) -> list[tuple[int, int]]:
        """Every intact snapshot's ``(pass_id, mid_steps)``, ascending."""
        out = []
        for pass_id, mid, snap in self._list_snaps():
            try:
                self._verify_snapshot(snap)
                out.append((pass_id, mid))
            except CheckpointCorruptError:
                continue
        if not out and self.remote_root is not None \
                and not self._remote_synced:
            # an empty staging dir: what the remote donefile delivers
            if self._sync_from_remote():
                return self.intact_cursors()
        return out

    def latest_valid(self) -> tuple[int, str, dict] | None:
        """Newest snapshot that fully verifies, walking past torn ones
        with a warning naming the diagnosis. None = nothing to resume.
        Returns (pass_id, snap_dir, manifest)."""
        for attempt in (0, 1):
            for pass_id, _mid, snap in reversed(self._list_snaps()):
                try:
                    return pass_id, snap, self._verify_snapshot(snap)
                except CheckpointCorruptError as e:
                    # a torn snapshot shows in the flight record and the
                    # exposition, not only in this warning
                    monitor.counter_add("ckpt.torn_fallbacks")
                    monitor.event("checkpoint_torn_fallback",
                                  type="lifecycle",
                                  snapshot=os.path.basename(snap),
                                  error=str(e)[:300])
                    warnings.warn(
                        f"snapshot {snap} failed verification ({e}); "
                        f"falling back to the previous one")
            # nothing intact locally (none, or all torn): a remote root
            # may still deliver — sync once and walk again
            if (attempt == 1 or self.remote_root is None
                    or self._remote_synced
                    or not self._sync_from_remote()):
                break
        return None

    # ---- resume ----------------------------------------------------------

    def resume(self, trainer, box=None, metrics=None,
               at: tuple[int, int] | None = None) -> dict | None:
        """Restore every plane from the newest valid snapshot and return
        its cursor ({pass_id, global_step, date, phase, mid_steps,
        shuffle_state}), or None when no valid snapshot exists. The
        training loop re-enters at ``cursor['pass_id'] + 1``
        (skipping the first ``mid_steps`` steps of that pass).

        ``at=(pass_id, mid_steps)`` restores exactly that snapshot and
        discards newer local ones; it raises if that snapshot is missing
        or torn."""
        t_res0 = time.perf_counter()
        if at is not None:
            at = (int(at[0]), int(at[1]))
            snap = self.snap_dir(*at)
            try:
                manifest = self._verify_snapshot(snap)
            except CheckpointCorruptError as e:
                raise RuntimeError(
                    f"snapshot {self.snap_name(*at)} no longer verifies: "
                    f"{e}") from e
        else:
            found = self.latest_valid()
            if found is None:
                return None
            _, snap, manifest = found
        cursor = dict(manifest["cursor"])
        cursor.setdefault("mid_steps", 0)
        cursor.setdefault("shuffle_state", None)
        chain_name = manifest["chain_dir"]
        seq = int(manifest["save_seq"])

        # sparse plane, in place; the chain was verified against the
        # snapshot's own CRCs above
        trainer.store.restore(self._chain_path(chain_name), upto_seq=seq,
                              verify=False)

        dense = ckpt_lib.load_tree(trainer.dense_state(),
                                   os.path.join(snap, "dense.npz"))
        trainer.restore_dense(dense["params"], dense["opt_state"])
        trainer.global_step = int(cursor["global_step"])

        metrics = metrics if metrics is not None else (
            box.metrics if box is not None else None)
        if metrics is not None and "metrics.npz" in manifest["files"]:
            states = ckpt_lib.load_tree(_metric_tree(metrics),
                                        os.path.join(snap, "metrics.npz"))
            for name, state in states.items():
                metrics.set_state(name, state)
            if cursor.get("phase") is not None:
                metrics.phase = int(cursor["phase"])
        if box is not None:
            box.pass_id = int(cursor["pass_id"])
            box.in_pass = False
            if cursor.get("date") is not None:
                box.date = int(cursor["date"])

        if at is not None:
            self._discard_newer_than(at)

        # continue the chain where the snapshot left it: the next save
        # deltas into the same chain (higher-numbered deltas of the run
        # that crashed are overwritten as the re-run reaches them)
        self._chain_dir = chain_name
        self._chain_gen = max(self._chain_gen,
                              int(_CHAIN_RE.match(chain_name).group(1)))
        self._deltas_in_chain = seq
        self._expect_count = trainer.store.save_count
        seconds = time.perf_counter() - t_res0
        monitor.counter_add("ckpt.resumes")
        monitor.counter_add("ckpt.resume_seconds", seconds)
        monitor.event("checkpoint_resume", type="lifecycle",
                      snapshot=os.path.basename(snap), seconds=seconds,
                      resumed_pass=int(cursor["pass_id"]),
                      mid_steps=int(cursor["mid_steps"]),
                      chain=chain_name, save_seq=seq, elected=at is not None)
        self.last_resume = {
            "snapshot": os.path.basename(snap),
            "seconds": seconds,
            "bytes": (sum(e["bytes"] for e in manifest["files"].values())
                      + sum(e["bytes"] for e in
                            manifest.get("chain_files", {}).values()))}
        if self.remote_root is not None:
            self.last_resume["remote_download"] = self.last_download
        return cursor

    def _discard_newer_than(self, at: tuple[int, int]) -> None:
        """Remove snapshots newer than ``at``: they belong to an abandoned
        timeline and must never win a later newest-first walk. A remote
        root's donefile masks them with a ``reset_after`` line (their
        directories are overwritten as the re-run reaches those
        passes)."""
        dropped = [s for p, m, s in self._list_snaps() if (p, m) > at]
        for s in dropped:
            shutil.rmtree(s, ignore_errors=True)
        if dropped:
            monitor.event("checkpoint_timeline_reset", type="lifecycle",
                          elected=list(at),
                          dropped=[os.path.basename(s) for s in dropped])
        if self.remote_root is None:
            return
        try:
            fs = self._remote_fs()
            if fs.exists(f"{self.remote_root}/{REMOTE_DONEFILE}"):
                line = json.dumps({"reset_after": list(at),
                                   "ts": int(time.time())})
                # pblint: disable=donefile-discipline -- timeline-reset
                # mask on the mirror's own snapshots.donefile
                fs.write_text(f"{self.remote_root}/{REMOTE_DONEFILE}",
                              line + "\n", append=True)
        except RuntimeError as e:
            # the rollback already happened locally; the mask only keeps
            # later restores off the abandoned entries
            warnings.warn(f"remote donefile reset failed ({e})")

    # ---- retention -------------------------------------------------------

    def _prune(self) -> None:
        """Drop snapshots beyond keep_last_n (pass-boundary and mid-pass
        ones in separate pools), then chain dirs no surviving snapshot
        references. Never touches the open chain."""
        snaps = self._list_snaps()
        fulls = [s for s in snaps if s[1] == 0]
        mids = [s for s in snaps if s[1] > 0]
        for _, _, snap in (fulls[:-self.keep_last_n]
                           + mids[:-self.keep_last_n]):
            shutil.rmtree(snap, ignore_errors=True)
        referenced = {self._chain_dir}
        for _, _, snap in self._list_snaps():
            try:
                m = ckpt_lib.read_manifest(snap)
            except CheckpointCorruptError:
                continue     # unusable snapshot; resume skips it too
            if m is not None:
                referenced.add(m.get("chain_dir"))
        for n in os.listdir(self.root):
            if _CHAIN_RE.match(n) and n not in referenced:
                shutil.rmtree(os.path.join(self.root, n),
                              ignore_errors=True)
        if self.remote_root is not None:
            try:
                self._prune_remote()
            except (RuntimeError, OSError, ValueError) as e:
                # retention is hygiene: download-side verification is the
                # backstop, and the next save retries the compaction
                warnings.warn(f"remote snapshot retention failed ({e}); "
                              f"will retry at the next save")

    def _prune_remote(self) -> None:
        """The mirror's retention: keep the newest ``keep_last_n``
        donefile entries per pool (pass-boundary and mid-pass, as
        locally), rewrite the donefile to exactly those lines (dropping
        pruned and masked ones), then remove the remote snapshot and
        chain directories no kept entry references. The donefile shrinks
        first, so a kill leaves orphan directories the next compaction
        reclaims, never a line naming a deleted directory; the rewrite
        stages at ``snapshots.donefile.compact`` before replacing the
        main file."""
        raw = self._read_donefile_raw()
        if not raw:
            return
        entries = self._remote_entries(raw)
        keep = max(1, int(self.keep_last_n))
        fulls = [e for e in entries if not int(e.get("mid", 0))]
        mids = [e for e in entries if int(e.get("mid", 0))]
        kept_ids = {id(e) for e in fulls[-keep:] + mids[-keep:]}
        kept = [e for e in entries if id(e) in kept_ids]
        fs = self._remote_fs()
        donefile = f"{self.remote_root}/{REMOTE_DONEFILE}"
        if len(kept) != len(raw):
            tmp = os.path.join(self.root,
                               f".donefile.compact.{os.getpid()}")
            # pblint: disable=durable-write,donefile-discipline -- local
            # staging copy of the compacted mirror donefile: durability
            # comes from the two-phase remote protocol below
            with open(tmp, "w") as f:
                for e in kept:
                    f.write(json.dumps(e) + "\n")
            try:
                fs.rm(f"{donefile}.compact")
                # pblint: disable=donefile-discipline -- two-phase
                # compaction STAGE upload (readers fall back to .compact
                # if the replace below is interrupted)
                fs.put(tmp, f"{donefile}.compact")
                fs.rm(donefile)
                # pblint: disable=donefile-discipline -- two-phase
                # compaction REPLACE of the mirror's own donefile
                fs.put(tmp, donefile)
                fs.rm(f"{donefile}.compact")
            finally:
                os.remove(tmp)
            monitor.counter_add("ckpt.donefile_compactions")
            monitor.event("donefile_compacted", type="lifecycle",
                          dropped=len(raw) - len(kept), kept=len(kept))
        kept_snaps = {e["snapshot"] for e in kept}
        kept_chains = {e["chain"] for e in kept}
        if self._chain_dir is not None:
            kept_chains.add(self._chain_dir)     # the open chain
        removed = 0
        for path in fs.ls(self.remote_root):
            name = os.path.basename(path.rstrip("/"))
            if _PASS_RE.match(name) and name not in kept_snaps:
                fs.rm(f"{self.remote_root}/{name}")
                removed += 1
            elif _CHAIN_RE.match(name) and name not in kept_chains:
                fs.rm(f"{self.remote_root}/{name}")
                self._uploaded_chains.discard(name)
                removed += 1
        if removed:
            monitor.counter_add("ckpt.remote_pruned_dirs", removed)
