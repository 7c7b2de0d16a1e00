"""Day/pass model layout and donefiles — the port of
``paddlebox_tpu/fleet/fleet_util.py``.

Models are organised by day and pass under one output root:

    {root}/{day}/base/              full model (save_model :65):
                                    sparse/ chain + dense.npz
    {root}/{day}/delta-{pass}/      self-contained delta (save_delta_model
                                    :78): sparse/ delta + dense.npz

with JSON-line donefiles (``base_model.donefile``,
``delta_model.donefile``) naming each completed model, so a consumer
finds the newest one. ``load_model`` (:258) loads the newest base and
replays every delta recorded after it, in donefile order. The files are
the reference's: a root written by either package loads in the other.

The output root may be remote (``hdfs://...``, any scheme registered
with ``utils.fs``, e.g. through ``init_afs_api``): a save stages the
model in a local temp dir and uploads it with ``put_replacing``, and its
donefile line is appended only after the upload, so a torn upload is
never discoverable; a load downloads each model it replays to a temp
dir. A base whose download fails falls back to the previous donefile
entry with a diagnostic (``fleet.base_fetch_fallbacks``); a delta that
fails to download raises, since skipping it would load a model missing
a pass. Donefile dedups, compactions, repairs and malformed lines count
under the reference's ``fleet.*`` names.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import time
import warnings
from typing import Any

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import fs as fs_lib


class FleetUtil:
    def __init__(self, output_root: str):
        self._fs, resolved = fs_lib.resolve(output_root)
        self._remote = fs_lib.is_remote(output_root)
        # file:// roots resolve to their local path; remote roots keep
        # the scheme (the commands want full URIs)
        self.root = output_root if self._remote else resolved
        self._fs.makedirs(self.root)
        # (donefile, lineno, line) already diagnosed: a tailer re-reads
        # the same file every poll, and one torn line must not re-warn
        self._warned_malformed: set[tuple[str, int, str]] = set()

    # ---- paths ----

    def base_dir(self, day: int) -> str:
        return os.path.join(self.root, str(day), "base")

    def delta_dir(self, day: int, pass_id: int) -> str:
        return os.path.join(self.root, str(day), f"delta-{pass_id}")

    # ---- save ----

    def save_model(self, store: HostEmbeddingStore, dense_state: Any,
                   day: int) -> str:
        """Full day-level base model: sparse base + dense snapshot
        (``dense_state`` a NumPy tree, e.g. ``Trainer.eval_params()``)."""
        path = self.base_dir(day)

        def write(into: str) -> None:
            store.save_base(os.path.join(into, "sparse"))
            ckpt_lib.save_tree(dense_state, os.path.join(into, "dense.npz"))

        self._save_dir(path, write)
        self._write_donefile("base_model.donefile", day, 0, path)
        return path

    def save_delta_model(self, store: HostEmbeddingStore, dense_state: Any,
                         day: int, pass_id: int) -> str:
        """Pass-level delta. Self-contained: the directory named in the
        donefile holds both the sparse delta and the dense snapshot."""
        path = self.delta_dir(day, pass_id)

        def write(into: str) -> None:
            sparse_dir = os.path.join(into, "sparse")
            os.makedirs(sparse_dir, exist_ok=True)
            store.save_delta(sparse_dir)
            ckpt_lib.save_tree(dense_state, os.path.join(into, "dense.npz"))

        self._save_dir(path, write)
        self._write_donefile("delta_model.donefile", day, pass_id, path)
        return path

    def _save_dir(self, path: str, write) -> None:
        """``write(local_dir)``, then land the directory at ``path``: in
        place for a local root; staged in a temp dir and uploaded for a
        remote one (the caller appends the donefile line only after this
        returns, so a torn upload is never discoverable)."""
        if not self._remote:
            os.makedirs(path, exist_ok=True)
            write(path)
            return
        with tempfile.TemporaryDirectory(prefix="pbt_fleet_") as d:
            stage = os.path.join(d, "m")
            os.makedirs(stage)
            write(stage)
            faultpoint.hit("remote_ckpt.upload.pre")
            self._fs.makedirs(path.rsplit("/", 1)[0])
            # a leftover target (a torn upload, a re-save of the same
            # day/pass) must never nest the stage under it
            fs_lib.put_replacing(self._fs, stage, path)

    def _write_donefile(self, name: str, day: int, pass_id: int,
                        path: str) -> None:
        self.append_donefile(name, {"day": day, "pass": pass_id,
                                    "path": path, "ts": int(time.time())},
                             dedup=("day", "pass", "path"))

    def append_donefile(self, name: str, entry: dict[str, Any],
                        dedup: tuple[str, ...] = ("path",)) -> bool:
        """Append one JSON line to a donefile under the output root.

        Crash-replay idempotent: a restarted save that reaches this line
        again skips the append when the last committed line already
        carries the same values for the ``dedup`` keys (returns False). An
        interrupted ``rewrite_donefile`` is repaired first."""
        self._repair_compaction(name)
        last = self.latest(name)
        if last is not None and all(last.get(k) == entry.get(k)
                                    for k in dedup):
            monitor.counter_add("fleet.donefile_dedup")
            return False
        # pblint: disable=donefile-discipline -- this is the port's sole
        # donefile writer (the rule names the JAX package's FleetUtil)
        self._fs.write_text(os.path.join(self.root, name),
                            json.dumps(entry) + "\n", append=True)
        return True

    def rewrite_donefile(self, name: str,
                         entries: list[dict[str, Any]]) -> None:
        """Two-phase compacting rewrite: the content lands in the
        ``.compact`` staging copy first, then replaces the main file,
        then the staging copy goes. Readers fall back to the staging copy
        and ``append_donefile`` repairs an interrupted rewrite, so no kill
        point loses the donefile."""
        path = os.path.join(self.root, name)
        alt = f"{path}.compact"
        content = "".join(json.dumps(e) + "\n" for e in entries)
        # pblint: disable=donefile-discipline -- two-phase compaction
        # STAGE write inside the port's sole donefile writer
        self._fs.write_text(alt, content)
        self._replace_main(path, content)
        self._fs.rm(alt)
        monitor.counter_add("fleet.donefile_compactions")
        monitor.event("donefile_compacted", donefile=name,
                      entries=len(entries))

    def _replace_main(self, path: str, content: str) -> None:
        """Land the rewritten main donefile: atomically on a local root
        (tmp → fsync → os.replace); on a remote one rm then write, whose
        window readers cover through the ``.compact`` staging copy."""
        if self._remote:
            if self._fs.exists(path):
                self._fs.rm(path)
            self._fs.write_text(path, content)
            return
        tmp = f"{path}.rewrite.{os.getpid()}"
        # pblint: disable=donefile-discipline -- the compaction's tmp
        # copy, inside the port's sole donefile writer
        with open(tmp, "w") as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        # pblint: disable=donefile-discipline -- two-phase compaction
        # REPLACE, inside the port's sole donefile writer
        os.replace(tmp, path)

    def _repair_compaction(self, name: str) -> None:
        """Finish an interrupted rewrite_donefile: main file missing but
        the ``.compact`` staging copy present → restore main from it."""
        path = os.path.join(self.root, name)
        alt = f"{path}.compact"
        if self._fs.exists(path) or not self._fs.exists(alt):
            return
        content = "".join(ln if ln.endswith("\n") else ln + "\n"
                          for ln in self._fs.read_lines(alt))
        self._replace_main(path, content)
        self._fs.rm(alt)
        monitor.counter_add("fleet.donefile_repairs")
        monitor.event("donefile_repaired", donefile=name)

    def entries(self, donefile: str) -> list[dict[str, Any]]:
        """All parseable entries of a donefile, in append order."""
        return self._entries(donefile)

    def _entries(self, donefile: str) -> list[dict[str, Any]]:
        fname = os.path.join(self.root, donefile)
        if not self._fs.exists(fname):
            # mid-compaction window: the staging copy is the donefile
            alt = f"{fname}.compact"
            if self._fs.exists(alt):
                fname = alt
            else:
                return []
        out = []
        for lineno, line in enumerate(self._fs.read_lines(fname), 1):
            line = line.strip()
            if not line:
                continue
            # a torn or foreign line must not brick model discovery: skip
            # it with a named warning, never raise mid-parse
            try:
                e = json.loads(line)
                if not isinstance(e, dict):
                    raise ValueError(f"entry is {type(e).__name__}, "
                                     f"not an object")
            except ValueError as err:
                seen = (donefile, lineno, line)
                if seen not in self._warned_malformed:
                    self._warned_malformed.add(seen)
                    monitor.counter_add("fleet.donefile_malformed_lines")
                    monitor.event("donefile_malformed_line",
                                  donefile=donefile, lineno=lineno,
                                  error=str(err)[:200])
                    warnings.warn(
                        f"malformed line {lineno} in donefile {donefile!r} "
                        f"(skipped): {line[:120]!r} ({err})")
                continue
            out.append(e)
        return out

    def latest(self, donefile: str = "base_model.donefile"
               ) -> dict[str, Any] | None:
        entries = self._entries(donefile)
        return entries[-1] if entries else None

    # ---- load ----

    def load_model(self, dense_template: Any, day: int | None = None
                   ) -> tuple[HostEmbeddingStore, Any, int]:
        """Load the newest base model (or the given day's) and replay every
        delta recorded after it, in donefile order. Returns (store, dense
        NumPy tree shaped as ``dense_template``, day)."""
        bases = self._entries("base_model.donefile")
        if day is not None:
            bases = [b for b in bases if int(b["day"]) == day]
        if not bases:
            raise FileNotFoundError(
                f"no base model{f' for day {day}' if day else ''} in "
                f"{self.root}")
        with tempfile.TemporaryDirectory(prefix="pbt_fetch_") as tmp:
            # newest base first; a base whose download fails (an outage
            # that outlasts the CommandFS retries) is diagnosed and
            # skipped: recovery falls back to the previous base and its
            # deltas rather than dying on the freshest
            base, base_local, fetch_err = None, None, None
            for i, cand in enumerate(reversed(bases)):
                try:
                    base_local = self._fetch_dir(cand["path"], tmp,
                                                 f"base{i}")
                    base = cand
                    break
                except RuntimeError as e:
                    fetch_err = e
                    monitor.counter_add("fleet.base_fetch_fallbacks")
                    monitor.event("fleet_base_fetch_fallback",
                                  path=cand["path"], error=str(e)[:300])
                    warnings.warn(
                        f"base model {cand['path']} failed to download "
                        f"({e}); falling back to the previous donefile "
                        f"entry")
            if base is None:
                raise RuntimeError(
                    f"every base model donefile entry failed to download "
                    f"from {self.root} (last: {fetch_err})")
            day = int(base["day"])
            store = HostEmbeddingStore.load(os.path.join(base_local,
                                                         "sparse"))
            dense_file = os.path.join(base_local, "dense.npz")
            # replay deltas recorded after this base (yesterday's base +
            # today's pass deltas)
            for i, d in enumerate(self._entries("delta_model.donefile")):
                if (int(d["ts"]) < int(base["ts"])
                        or d["path"] == base["path"]):
                    continue
                if int(d["day"]) < day:
                    continue
                try:
                    d_local = self._fetch_dir(d["path"], tmp, f"d{i}")
                except RuntimeError as e:
                    # a delta is state: skipping one would load a model
                    # missing a pass
                    raise RuntimeError(
                        f"delta model {d['path']} (day {d['day']} pass "
                        f"{d['pass']}) failed to download during recovery "
                        f"replay: {e}") from e
                for f in sorted(glob.glob(os.path.join(d_local, "sparse",
                                                       "delta-*.npz"))):
                    store.apply_delta_file(f)
                cand = os.path.join(d_local, "dense.npz")
                if os.path.exists(cand):
                    dense_file = cand
                day = max(day, int(d["day"]))
            dense = ckpt_lib.load_tree(dense_template, dense_file)
        return store, dense, day

    def _fetch_dir(self, path: str, tmp: str, tag: str) -> str:
        """A model directory's local view: itself on a local root, a
        download into ``tmp`` on a remote one."""
        if not self._remote:
            return path
        faultpoint.hit("remote_ckpt.download.pre")
        local = os.path.join(tmp, tag)
        self._fs.get(path, local)
        return local
