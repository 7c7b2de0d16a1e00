"""Crash-safe pass snapshots and resume — the port of ``PassCheckpointer``
(``paddlebox_tpu/utils/pass_ckpt.py:85``), local roots.

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

The directory layout and every file are the reference's, so a snapshot
root written by either package resumes in the other. Not ported yet
(ROADMAP): remote roots and the mirror (:291-478, :742 — a remote URI
raises ``RemoteFSNotPorted``), and mid-pass snapshot saving (a snapshot
of the JAX package with ``mid_steps`` > 0 does resume: its cursor feeds
``Trainer.train_pass(skip_steps=...)``). The reference's telemetry
events are left out; ``last_save`` / ``last_resume`` keep the seconds and
bytes it counts.
"""

from __future__ import annotations

import os
import re
import shutil
import time
import warnings
from typing import Any

from paddlebox_tpu_torch.config import flags as config_flags
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import fs as fs_lib
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

_PASS_RE = re.compile(r"^pass-(\d+)(?:\.mid(\d+))?$")
_CHAIN_RE = re.compile(r"^chain-(\d+)$")


def _metric_tree(metrics) -> dict[str, Any]:
    return {name: metrics.get_state(name) for name in metrics.names()}


class PassCheckpointer:
    """Owns one snapshot root. One instance per training job; the
    training loop calls :meth:`save` at every pass boundary (directly or through
    ``BoxPS.end_pass``) and :meth:`resume` once at startup."""

    def __init__(self, root: str, keep_last_n: int | None = None,
                 base_every: int | None = None):
        if fs_lib.is_remote(root):
            raise fs_lib.RemoteFSNotPorted(root)
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
        # store.save_count as of OUR last save/resume: any foreign save in
        # between (a FleetUtil model sharing the store) consumed the dirty
        # mask and tombstones, so the next snapshot must be a full base
        self._expect_count: int | None = None
        # what the last save / resume cost: {seconds, bytes, ...}
        self.last_save: dict | None = None
        self.last_resume: dict | None = None

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
             shuffle_state: dict | None = None) -> str:
        """Snapshot the complete post-pass state; returns the snapshot
        directory. Members land in dependency order (sparse chain → dense
        → metrics), manifest last: a kill anywhere before the manifest
        commit leaves this snapshot invisible and the previous one
        intact."""
        if mid_steps:
            raise NotImplementedError(
                "mid-pass snapshot saving (mid_steps > 0) is not ported yet "
                "(ROADMAP, queue 1: mid-pass snapshots); a JAX mid-pass "
                "snapshot resumes through train_pass(skip_steps=...)")
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

        snap = self.snap_dir(pass_id)
        os.makedirs(snap, exist_ok=True)
        files: dict[str, dict] = {}
        dense_f = os.path.join(snap, "dense.npz")
        ckpt_lib.save_tree(trainer.dense_state(), dense_f)
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
            "mid_steps": 0,
            "shuffle_state": shuffle_state,
        }
        parent = self.snap_name(pass_id - 1) if pass_id > 1 else None
        faultpoint.hit("pass_ckpt.pre_manifest")
        ckpt_lib.write_manifest(
            snap, files, cursor=cursor, save_seq=save_seq,
            chain_dir=chain_name, chain_files=chain_files,
            parent_snapshot=parent)
        faultpoint.hit("pass_ckpt.post_manifest")
        sparse_member = ("base.npz" if rotate
                         else f"delta-{save_seq:05d}.npz")
        sparse_bytes = chain_files[sparse_member]["bytes"]
        self.last_save = {
            "snapshot": os.path.basename(snap), "rotated": bool(rotate),
            "seconds": time.perf_counter() - t_save0,
            "bytes": sum(e["bytes"] for e in files.values()) + sparse_bytes,
            "sparse_member": sparse_member, "sparse_seconds": sparse_seconds,
            "sparse_bytes": sparse_bytes, "flush_seconds": flush_seconds,
            "flush_bytes": int(flush_bytes)}
        self._prune()
        return snap

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
        return out

    def latest_valid(self) -> tuple[int, str, dict] | None:
        """Newest snapshot that fully verifies, walking past torn ones
        with a warning naming the diagnosis. None = nothing to resume.
        Returns (pass_id, snap_dir, manifest)."""
        for pass_id, _mid, snap in reversed(self._list_snaps()):
            try:
                return pass_id, snap, self._verify_snapshot(snap)
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"snapshot {snap} failed verification ({e}); "
                    f"falling back to the previous one")
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
        self.last_resume = {
            "snapshot": os.path.basename(snap),
            "seconds": time.perf_counter() - t_res0,
            "bytes": (sum(e["bytes"] for e in manifest["files"].values())
                      + sum(e["bytes"] for e in
                            manifest.get("chain_files", {}).values()))}
        return cursor

    def _discard_newer_than(self, at: tuple[int, int]) -> None:
        """Remove snapshots newer than ``at``: they belong to an abandoned
        timeline and must never win a later newest-first walk."""
        for p, m, s in self._list_snaps():
            if (p, m) > at:
                shutil.rmtree(s, ignore_errors=True)

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
