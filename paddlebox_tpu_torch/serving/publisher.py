"""ServingPublisher — the port of ``paddlebox_tpu/serving/publisher.py``
(``ServingPublisher`` :56-357, ``_diff_plane`` :360).

Every ``end_pass`` ships the pass's model to the serving plane as a
versioned artifact (``serving/artifact.py``): a full base every
``publish_base_every`` publishes, an exact key-delta otherwise, and one
donefile line (``serving_model.donefile``, through
``FleetUtil.append_donefile``) announces it — only after the committed
version re-hashed clean against its manifest. A kill anywhere in the
three windows ``serving.publish.{pre_manifest, pre_upload,
pre_donefile}`` leaves every announced version verifiable: a torn
publish never serves. A re-publish after a resume re-lands the lost
version idempotently (``publish_if_behind``; the donefile append dedups
a replayed line).

Deltas diff the current pull plane against a retained copy of the last
published one (not the store's dirty mask, which belongs to the
PassCheckpointer). Cold rows cross quantized (int8/int16, a scale a
row); the ``hot_top_k`` hottest keys by show count stay f32 and are
flagged for the server's replica cache. The donefile is compacted past
``compact_after`` entries to the newest ``keep_bases`` bases and their
tails, pruning the dropped version directories.

Each publish runs in a ``publish`` span and counts its seconds and
bytes under the reference's ``serving.*`` names, with the
``serving_publish`` event (compaction and pruning count and report
theirs); the publish-info dict carries the same numbers. A remote root
(``hdfs://...``, any scheme registered with ``utils.fs``) stages each
version under ``staging_dir`` (a temp dir by default), uploads it with
``put_replacing`` inside the ``serving.publish.pre_upload`` window and,
with ``verify_upload`` (the default), downloads it back and re-hashes it
against its manifest before the donefile line; ``seconds`` /
``upload_seconds`` / ``verify_seconds`` in the publish info split the
time. The trace links come with the world trace (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import warnings
from typing import Any

import numpy as np

from paddlebox_tpu_torch.embedding.gating import GateSpec
from paddlebox_tpu_torch.fleet.fleet_util import FleetUtil
from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.inference import export as export_lib
from paddlebox_tpu_torch.serving import artifact as art
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import fs as fs_lib

DONEFILE = "serving_model.donefile"


class ServingPublisher:
    """Owns one serving output root (a local dir or a remote URI) and a
    monotonic version
    sequence continued from its donefile. Drive it per pass through
    ``BoxPS.end_pass(publisher=…, trainer=…)`` or call :meth:`publish`."""

    def __init__(self, root: str, model: Any, schema: Any, *,
                 publish_base_every: int | None = None,
                 quant: str = "int8", hot_top_k: int = 1024,
                 label_slot: str = "label", verify_upload: bool = True,
                 staging_dir: str | None = None,
                 compact_after: int = 256, keep_bases: int = 2,
                 prune_artifacts: bool = True):
        if quant not in ("f32", "int8", "int16"):
            raise ValueError(f"quant must be f32|int8|int16, got {quant!r}")
        self._remote = fs_lib.is_remote(root)
        self._fs, resolved = fs_lib.resolve(root)
        self.root = root.rstrip("/") if self._remote else resolved
        self.verify_upload = bool(verify_upload)
        self._staging = staging_dir
        # donefile discipline (append after commit, idempotent replay,
        # malformed lines skipped) is FleetUtil's
        self._fleet = FleetUtil(self.root)
        self.model = model
        self.schema = schema
        self.label_slot = label_slot
        self.publish_base_every = (8 if publish_base_every is None
                                   else int(publish_base_every))
        if self.publish_base_every < 1:
            raise ValueError("publish_base_every must be >= 1")
        self.quant = quant
        self.hot_top_k = int(hot_top_k)
        self.compact_after = int(compact_after)
        self.keep_bases = max(1, int(keep_bases))
        self.prune_artifacts = bool(prune_artifacts)
        # the donefile is the authority across restarts: one read seeds
        # the version and the entry count compaction tracks
        entries = self._fleet.entries(DONEFILE)
        self._version = int(entries[-1]["version"]) if entries else 0
        self._entry_count = len(entries)
        # deltas need the retained previous plane: a restarted publisher
        # has none, so its first publish is a base
        self._last_pub: tuple[np.ndarray, np.ndarray] | None = None
        self._deltas_since_base = 0
        # compaction failures are reported, never fatal (the donefile is
        # merely longer than the policy wants)
        self.compaction_errors = 0

    def publish(self, store, dense_params, pass_id: int) -> dict:
        """Snapshot ``store``'s pull plane and ``dense_params`` (a
        JAX-layout tree, e.g. ``Trainer.eval_params()``) into the next
        version, verify it, announce it. Returns {version, kind, path,
        seconds, bytes, keys, announced}. Runs inside a ``publish``
        telemetry span."""
        with monitor.span("publish"):
            return self._publish_impl(store, dense_params, pass_id)

    def _publish_impl(self, store, dense_params, pass_id: int) -> dict:
        t0 = time.perf_counter()
        # export_serving flushes the device-held rows first
        keys, vals = store.export_serving()
        version = self._version + 1
        is_base = (self._last_pub is None
                   or self._deltas_since_base >= self.publish_base_every - 1)
        kind = "base" if is_base else "delta"
        name = art.version_name(version)
        meta_kw: dict[str, Any] = {}
        if is_base:
            hot = np.zeros(len(keys), bool)
            if self.hot_top_k > 0 and len(keys):
                k = min(self.hot_top_k, len(keys))
                # hottest by show count (pull column 0)
                hot[np.argpartition(-vals[:, 0], k - 1)[:k]] = True
            meta_kw.update(keys=keys, vals=vals, hot=hot, quant=self.quant,
                           fixed_cols=int(store.cfg.fixed_cols))
            parent = None
        else:
            pk, pv = self._last_pub
            ch_keys, ch_rows, removed = _diff_plane(pk, pv, keys, vals)
            meta_kw.update(keys=ch_keys, vals=ch_rows, removed=removed)
            parent = self._version

        target = self._artifact_target(name)
        tmp_stage = None
        if self._remote:
            if self._staging:
                os.makedirs(self._staging, exist_ok=True)
                stage_root = self._staging
            else:
                tmp_stage = tempfile.mkdtemp(prefix="pbt_serve_pub_")
                stage_root = tmp_stage
            local_dir = os.path.join(stage_root, name)
        else:
            local_dir = target
        upload_s = verify_s = 0.0
        try:
            manifest = art.write_artifact(
                local_dir, version=version, pass_id=int(pass_id),
                kind=kind, parent_version=parent,
                model_meta=export_lib.model_meta(
                    self.model, self.schema,
                    vals.shape[1] if len(vals) else store.cfg.pull_width,
                    self.label_slot),
                dense_params=dense_params,
                gate=GateSpec.from_cfg(store.cfg), ts=int(time.time()),
                **meta_kw)
            faultpoint.hit("serving.publish.pre_upload")
            if self._remote:
                t_up = time.perf_counter()
                self._fs.makedirs(self.root)
                fs_lib.put_replacing(self._fs, local_dir, target)
                upload_s = time.perf_counter() - t_up
            t_ver = time.perf_counter()
            # the verification the donefile contract requires
            self._verify_published(target, manifest)
            verify_s = time.perf_counter() - t_ver
        finally:
            if self._remote:
                # the staged copy is consumed by the upload (a kept
                # staging_dir must not grow one version a publish)
                shutil.rmtree(tmp_stage or local_dir, ignore_errors=True)
        faultpoint.hit("serving.publish.pre_donefile")
        entry = {"version": version, "pass": int(pass_id), "kind": kind,
                 "parent": parent, "path": target, "ts": int(time.time())}
        announced = self._fleet.append_donefile(DONEFILE, entry,
                                                dedup=("version", "path"))
        if announced:
            self._entry_count += 1
        # only a new base makes entries droppable, so only a base
        # publish tries to compact
        if (is_base and self.compact_after > 0
                and self._entry_count > self.compact_after):
            try:
                self.compact_donefile()
            except (OSError, RuntimeError) as e:
                self.compaction_errors += 1
                monitor.counter_add("serving.compaction_errors")
                monitor.event("serving_compaction_error", error=repr(e))
                warnings.warn(f"serving donefile compaction failed: {e!r}")

        self._version = version
        self._deltas_since_base = 0 if is_base else \
            self._deltas_since_base + 1
        # the caller's arrays go back to the live store: keep copies
        self._last_pub = (keys.copy(), vals.copy())
        seconds = time.perf_counter() - t0
        nbytes = sum(e["bytes"] for e in manifest["files"].values())
        monitor.counter_add("serving.publishes")
        monitor.counter_add(f"serving.publish_{kind}s")
        monitor.counter_add("serving.publish_seconds", seconds)
        monitor.counter_add("serving.publish_bytes", nbytes)
        monitor.event("serving_publish", type="lifecycle", version=version,
                      kind=kind, pass_id=int(pass_id), seconds=seconds,
                      bytes=int(nbytes), announced=bool(announced),
                      keys=int(manifest["num_keys"]))
        return {"version": version, "kind": kind, "path": target,
                "seconds": seconds, "bytes": int(nbytes),
                "upload_seconds": upload_s, "verify_seconds": verify_s,
                "keys": int(manifest["num_keys"]),
                "announced": bool(announced)}

    def _artifact_target(self, name: str) -> str:
        return (f"{self.root}/{name}" if self._remote
                else os.path.join(self.root, name))

    def _verify_published(self, target: str, manifest: dict) -> None:
        """Re-hash what landed at ``target`` against the committed
        manifest: in place on a local root; a remote root downloads the
        artifact back (``verify_upload=False`` trusts the transport; the
        server still verifies every fetch)."""
        if not self._remote:
            ckpt_lib.verify_manifest(target)
            return
        if not self.verify_upload:
            return
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="pbt_pub_verify_") as tmp:
            local = os.path.join(tmp, "check")
            self._fs.get(target, local)
            got = ckpt_lib.verify_manifest(local)
            if int(got.get("version", -1)) != int(manifest["version"]):
                raise ckpt_lib.CheckpointCorruptError(
                    target, f"uploaded artifact claims version "
                            f"{got.get('version')} != published "
                            f"{manifest['version']}")
        monitor.counter_add("serving.upload_verify_seconds",
                            time.perf_counter() - t0)

    def latest_announced(self) -> dict | None:
        return self._fleet.latest(DONEFILE)

    def compact_donefile(self, keep_bases: int | None = None) -> int:
        """Keep the newest ``keep_bases`` base entries and every entry
        after the oldest kept one; drop the rest (and, with
        ``prune_artifacts``, their version directories). A cold-starting
        server seeks the newest loadable base and its deltas, so nothing
        it can reach is dropped. The rewrite is FleetUtil's two-phase
        ``.compact`` staging. Returns the entries dropped."""
        keep_bases = (self.keep_bases if keep_bases is None
                      else max(1, int(keep_bases)))
        entries = self._fleet.entries(DONEFILE)
        self._entry_count = len(entries)
        base_idx = [i for i, e in enumerate(entries)
                    if str(e.get("kind", "")) == "base"]
        if len(base_idx) <= keep_bases:
            return 0
        cut = base_idx[-keep_bases]
        kept, dropped = entries[cut:], entries[:cut]
        if not dropped:
            return 0
        self._fleet.rewrite_donefile(DONEFILE, kept)
        self._entry_count = len(kept)
        monitor.counter_add("serving.donefile_compactions")
        monitor.counter_add("serving.donefile_entries_dropped",
                            len(dropped))
        monitor.event("serving_donefile_compacted", type="lifecycle",
                      kept=len(kept), dropped=len(dropped))
        if self.prune_artifacts:
            kept_names = {art.version_name(int(e["version"]))
                          for e in kept if "version" in e}
            for e in dropped:
                try:
                    name = art.version_name(int(e["version"]))
                except (KeyError, TypeError, ValueError):
                    continue            # a foreign or malformed entry
                if name in kept_names:
                    continue
                target = self._artifact_target(name)
                # retention is hygiene: a failed prune (OSError locally,
                # RuntimeError from a remote CommandFS) is reported and
                # the rest of the prune goes on
                try:
                    self._fs.rm(target)
                    monitor.counter_add("serving.artifacts_pruned")
                except (OSError, RuntimeError) as err:
                    monitor.event("serving_artifact_prune_error",
                                  path=target, error=repr(err))
                    warnings.warn(f"serving artifact prune of {target} "
                                  f"failed: {err!r}")
        return len(dropped)

    def publish_if_behind(self, store, dense_params,
                          pass_id: int) -> dict | None:
        """Resume catch-up: a kill between the pass snapshot and the
        donefile append loses that pass's announcement. Called after a
        resume with the restored pass: when the donefile is behind, the
        current plane re-publishes (a base: a restarted publisher holds
        no retained plane). None when serving is caught up."""
        if pass_id < 1:
            return None
        last = self.latest_announced()
        if last is not None and int(last.get("pass", -1)) >= int(pass_id):
            return None
        monitor.counter_add("serving.publish_catchups")
        return self.publish(store, dense_params, pass_id=pass_id)


def _diff_plane(prev_keys: np.ndarray, prev_vals: np.ndarray,
                keys: np.ndarray, vals: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact key-delta between two pull planes: (changed_keys,
    changed_rows, removed_keys). Changed = a new key, or any pull column
    differing bitwise from the retained publish."""
    order_p = np.argsort(prev_keys, kind="stable")
    pk, pv = prev_keys[order_p], prev_vals[order_p]
    pos = np.searchsorted(pk, keys)
    pos_c = np.minimum(pos, max(len(pk) - 1, 0))
    existed = (pk[pos_c] == keys) if len(pk) else np.zeros(len(keys), bool)
    same = np.zeros(len(keys), bool)
    if existed.any():
        same[existed] = (pv[pos_c[existed]] == vals[existed]).all(axis=1)
    changed = ~same
    removed = pk[~np.isin(pk, keys)] if len(pk) else pk
    return keys[changed], vals[changed], removed
