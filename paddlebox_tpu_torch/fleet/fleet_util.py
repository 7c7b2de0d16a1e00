"""Day/pass model layout and donefiles — the port of
``paddlebox_tpu/fleet/fleet_util.py``, local roots.

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

Remote roots (the reference stages and uploads through ``CommandFS``)
are not ported yet and raise ``RemoteFSNotPorted`` (ROADMAP). The
reference's telemetry counters are left out; a malformed donefile line
still warns once by name.
"""

from __future__ import annotations

import glob
import json
import os
import time
import warnings
from typing import Any

from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import fs as fs_lib


class FleetUtil:
    def __init__(self, output_root: str):
        if fs_lib.is_remote(output_root):
            raise fs_lib.RemoteFSNotPorted(output_root)
        self._fs, self.root = fs_lib.resolve(output_root)
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
        os.makedirs(path, exist_ok=True)
        store.save_base(os.path.join(path, "sparse"))
        ckpt_lib.save_tree(dense_state, os.path.join(path, "dense.npz"))
        self._write_donefile("base_model.donefile", day, 0, path)
        return path

    def save_delta_model(self, store: HostEmbeddingStore, dense_state: Any,
                         day: int, pass_id: int) -> str:
        """Pass-level delta. Self-contained: the directory named in the
        donefile holds both the sparse delta and the dense snapshot."""
        path = self.delta_dir(day, pass_id)
        sparse_dir = os.path.join(path, "sparse")
        os.makedirs(sparse_dir, exist_ok=True)
        store.save_delta(sparse_dir)
        ckpt_lib.save_tree(dense_state, os.path.join(path, "dense.npz"))
        self._write_donefile("delta_model.donefile", day, pass_id, path)
        return path

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

    def _replace_main(self, path: str, content: str) -> None:
        """Land the rewritten main donefile atomically (tmp → fsync →
        os.replace)."""
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
        base = bases[-1]
        day = int(base["day"])
        store = HostEmbeddingStore.load(os.path.join(base["path"], "sparse"))
        dense_file = os.path.join(base["path"], "dense.npz")
        # replay deltas recorded after this base (yesterday's base +
        # today's pass deltas)
        for d in self._entries("delta_model.donefile"):
            if int(d["ts"]) < int(base["ts"]) or d["path"] == base["path"]:
                continue
            if int(d["day"]) < day:
                continue
            for f in sorted(glob.glob(os.path.join(d["path"], "sparse",
                                                   "delta-*.npz"))):
                store.apply_delta_file(f)
            cand = os.path.join(d["path"], "dense.npz")
            if os.path.exists(cand):
                dense_file = cand
            day = max(day, int(d["day"]))
        dense = ckpt_lib.load_tree(dense_template, dense_file)
        return store, dense, day
