"""ServingServer — the port of ``paddlebox_tpu/serving/server.py``
(``ServingUnavailableError``, ``ServingModel``, ``ServingServer``
:74-772, the CLI :780).

The serve half of the online loop: tail ``serving_model.donefile``,
fetch each announced base or delta, verify it, build the next version
off the request path and swap it in while traffic flows.

- **Verify before build.** Every fetched version re-hashes against its
  manifest (``serving/artifact.py``); bytes that fail CRC never reach a
  table, and a version whose manifest names another version than the
  donefile announced is rejected.
- **Swap without a pause.** The next version's table (a copy-on-write
  merge for a delta) and Predictor build on the poll thread; the swap is
  one rebind of ``self._active``. A request grabs the handle once, so
  in-flight requests finish on the version they started on. The next
  Predictor is a fresh module of the same architecture
  (``Predictor.with_model``): the live module is never written.
- **Degrade, don't die.** A version whose directory is missing or that
  fails to verify is skipped with a named warning; deltas whose
  parent was skipped wait for the next base; the last good version
  keeps serving and ``health()`` reports ``degraded`` or ``stale``.
- **Cold start** seeks the newest loadable base and replays its deltas.
- **Version split and shadow** (``flags.serving_split_fraction``,
  ``flags.serving_shadow``): a new version lands as the candidate beside
  the stable one until ``promote_candidate``; per-version latency,
  scores and AUC go to ``ServingObs``.

Hot keys flagged by the publisher are counted per version
(``health()["hot_cached_keys"]``). The reference also pins them into a
per-version ``ReplicaCache`` that no request reads; the port has the
class (``embedding/replica_cache.py``) and builds none. Scoring runs on
the card unless
``device="cpu"``: every Predictor the server builds gets its device.

``/healthz`` serves ``health()`` as JSON (503 before the first load);
``/metrics`` serves the telemetry hub's Prometheus text, as the
reference's does. Swaps, candidate loads, fallbacks, build seconds,
request, shadow and poll failures count under the reference's
``serving.*`` names, with the ``serving_swap`` /
``serving_version_fallback`` / ``serving_window`` events and the
``serving.active_version`` / ``candidate_version`` / ``pass_lag`` /
``staleness_seconds`` gauges; ``health()`` carries the same numbers. The
request spans and trace links come with the world trace (ROADMAP
queue 1 item 7). A local root's artifacts are read in place. A remote
root (``hdfs://...``, any scheme registered with ``utils.fs``) stages
each announced version under ``staging_dir`` (a temp dir by default):
``fetch_attempts`` tries with exponential backoff from
``fetch_backoff_s`` (``serving.fetch_retries``), the partial download
removed before each retry; a version that exhausts them is diagnosed
like a corrupt one and the last good version keeps serving. The staged
copy is removed once the version is built.
"""

from __future__ import annotations

import http.server
import json
import os
import shutil
import tempfile
import threading
import time
import warnings
from typing import Any

import numpy as np
import torch

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.embedding.gating import GateSpec
from paddlebox_tpu_torch.fleet.fleet_util import FleetUtil
from paddlebox_tpu_torch.inference import export as export_lib
from paddlebox_tpu_torch.inference.predictor import Predictor
from paddlebox_tpu_torch.inference.serving_table import ServingTable
from paddlebox_tpu_torch.models import MODEL_REGISTRY
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.serving import artifact as art
from paddlebox_tpu_torch.serving.obs import ServingObs
from paddlebox_tpu_torch.serving.publisher import DONEFILE
from paddlebox_tpu_torch.utils import fs as fs_lib
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

def _entry_int(entry: dict | None, key: str) -> int | None:
    """An int field of a donefile entry, None when absent or bad."""
    if entry is None:
        return None
    try:
        return int(entry[key])
    except (KeyError, TypeError, ValueError):
        return None


class ServingUnavailableError(RuntimeError):
    """No model version has been loaded yet (empty donefile, or every
    announced version failed verification)."""


class ServingModel:
    """One immutable loaded version — the handle a request grabs once;
    rebinding ``server._active`` is the swap."""

    __slots__ = ("version", "pass_id", "kind", "predictor", "table",
                 "hot_keys", "hot_live", "published_ts", "loaded_ts")

    def __init__(self, version: int, pass_id: int, kind: str,
                 predictor: Predictor, table: ServingTable,
                 hot_keys: np.ndarray, hot_live: int, published_ts: int):
        self.version = version
        self.pass_id = pass_id
        self.kind = kind
        self.predictor = predictor
        self.table = table
        self.hot_keys = hot_keys
        self.hot_live = hot_live          # flagged hot keys in the table
        self.published_ts = published_ts
        self.loaded_ts = time.time()


class ServingServer:
    """Tails one serving root's (local or remote) donefile and serves the newest
    verified version. Step it with :meth:`poll_once` or run the tailer
    with :meth:`start`; score through :meth:`predict` /
    :meth:`predict_batch` (or a BatchingFrontend on top)."""

    def __init__(self, root: str, *, poll_s: float = 1.0,
                 staging_dir: str | None = None,
                 fetch_attempts: int = 3, fetch_backoff_s: float = 0.25,
                 stale_pass_lag: int = 2, stale_after_s: float = 600.0,
                 health_port: int | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self._remote = fs_lib.is_remote(root)
        self._fs, resolved = fs_lib.resolve(root)   # file:// → local path
        self.root = root.rstrip("/") if self._remote else resolved
        self._fleet = FleetUtil(self.root)   # torn-line-safe discovery
        self._staging = staging_dir
        self.fetch_attempts = max(1, int(fetch_attempts))
        self.fetch_backoff_s = float(fetch_backoff_s)
        self.poll_s = float(poll_s)
        self.stale_pass_lag = int(stale_pass_lag)
        self.stale_after_s = float(stale_after_s)
        self._active: ServingModel | None = None
        # version split / shadow: a new version lands here while _active
        # keeps serving, until promotion
        self._candidate: ServingModel | None = None
        self._latest_announced: dict | None = None
        self._skipped: dict[int, str] = {}     # version → diagnosis
        self._unusable: set[str] = set()       # entries diagnosed once
        self._swaps = 0
        self._served = 0
        self._request_failures = 0
        self._shadow_failures = 0
        self._last_error: str | None = None
        self._last_swap_pause_ms = 0.0
        self.last_build_seconds = 0.0
        self._obs: ServingObs | None = None
        # request threads, the tailer and the HTTP thread share the obs
        # bookkeeping, the split accumulator and the request counters
        self._lock = threading.Lock()
        self._split_acc = 0.0                  # deterministic router
        self._win_failures0 = 0                # counters at last commit
        self._win_swaps0 = 0
        self._building = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._http: Any = None
        self.health_port: int | None = None
        if health_port is not None:
            self._start_health_endpoint(int(health_port))

    # ---- discovery + swap ------------------------------------------------

    @property
    def active(self) -> ServingModel | None:
        return self._active

    @property
    def candidate(self) -> ServingModel | None:
        return self._candidate

    def _newest(self) -> ServingModel | None:
        """The candidate when one is held, else the active: donefile
        progress and version lag are measured against it."""
        return self._candidate or self._active

    @staticmethod
    def _split_on() -> bool:
        return (float(flags.serving_split_fraction) > 0.0
                or bool(flags.serving_shadow))

    def poll_once(self) -> int:
        """One tail step: read the donefile, fetch, verify, build and swap
        in every version newer than the newest loaded one, in order.
        Returns the versions applied. Never raises on a bad version."""
        entries = self._fleet.entries(DONEFILE)
        if entries:
            self._latest_announced = entries[-1]
        if self._active is None and entries:
            # cold start: the newest loadable base and its trailing
            # deltas determine the state; bases newest first, so a
            # rotted newest base falls back to the one before
            base_idx = [i for i, e in enumerate(entries)
                        if str(e.get("kind", "")) == "base"]
            applied = 0
            for i in reversed(base_idx):
                applied += self._apply_entries(entries[i:])
                if self._active is not None:
                    break
            if not base_idx:
                applied = self._apply_entries(entries)
        else:
            applied = self._apply_entries(entries)
        # split flags turned off while a candidate is held: promote it
        if self._candidate is not None and not self._split_on():
            self.promote_candidate()
        self._update_staleness_gauges()
        self.commit_window()                  # due-gated
        return applied

    def _apply_entries(self, entries: list[dict]) -> int:
        newest = self._newest()
        active_v = newest.version if newest else 0
        applied = 0
        for e in entries:
            try:
                version = int(e["version"])
                kind = str(e["kind"])
                path = str(e["path"])
            except (KeyError, TypeError, ValueError) as err:
                # versionless: remember the entry itself, or every poll
                # re-diagnoses the same foreign line
                seen = repr(sorted(e.items())) if isinstance(e, dict) \
                    else repr(e)
                if seen not in self._unusable:
                    self._unusable.add(seen)
                    self._diag(-1, f"unusable donefile entry {e!r}: {err}")
                continue
            if version <= active_v or version in self._skipped:
                continue
            if kind == "delta":
                parent = e.get("parent")
                base = self._newest()      # deltas chain off the newest
                if base is None or parent is None \
                        or int(parent) != base.version:
                    self._diag(version,
                               f"delta v{version} parents "
                               f"v{parent}, active is "
                               f"v{base.version if base else None}"
                               f" — waiting for the next base")
                    continue
            self._building = True
            staged = None
            try:
                loaded, staged = self._fetch(path)
                model = self._build(loaded, e)
            except Exception as err:   # noqa: BLE001 — keep serving
                self._diag(version, f"{kind} v{version} at {path}: "
                                    f"{err!r}")
                continue
            finally:
                self._building = False
                # the build consumed the staged download: a long-running
                # remote tailer must not keep one artifact a publish
                if staged is not None:
                    shutil.rmtree(staged, ignore_errors=True)
            t_swap = time.perf_counter()
            if self._split_on() and self._active is not None:
                prev, self._candidate = self._candidate, model
                role = "candidate"
                pause_ms = (time.perf_counter() - t_swap) * 1e3
                monitor.counter_add("serving.candidate_loads")
                monitor.gauge_set("serving.candidate_version", version)
                with self._lock:
                    if prev is not None:
                        self._obs_get().drop_version(prev.version)
                    self._obs_get().ensure_version(version, "candidate")
            else:
                self._active = model       # THE swap: one rebind
                role = "stable"
                pause_ms = (time.perf_counter() - t_swap) * 1e3
                self._last_swap_pause_ms = pause_ms
                self._swaps += 1
                monitor.counter_add("serving.swaps")
                monitor.gauge_set("serving.active_version", version)
            applied += 1
            active_v = version
            monitor.event("serving_swap", type="lifecycle",
                          version=version, kind=kind, role=role,
                          pass_id=model.pass_id,
                          swap_pause_ms=round(pause_ms, 3),
                          keys=len(model.table))
        return applied

    def _diag(self, version: int, msg: str) -> None:
        self._last_error = msg
        if version >= 0:
            self._skipped[version] = msg
        monitor.counter_add("serving.version_fallbacks")
        monitor.event("serving_version_fallback", version=version,
                      error=msg[:300])
        warnings.warn(f"serving: {msg}; continuing on the last good "
                      f"version")

    def _fetch(self, path: str) -> tuple[dict, str | None]:
        """A CRC-verified view of one artifact, and the staged copy to
        remove once it is built (None when read in place). A remote
        artifact gets ``fetch_attempts`` tries with exponential backoff;
        the partial download is removed before each retry and on
        exhaustion, which raises."""
        if not self._remote:
            if not os.path.isdir(path):
                raise FileNotFoundError(
                    f"artifact directory {path} is missing")
            return art.read_artifact(path, verify=True), None
        if self._staging is None:
            # one per server: two servers staging the same version name
            # into one fixed dir would clobber each other mid-read
            self._staging = tempfile.mkdtemp(prefix="pbt_serving_stage_")
        os.makedirs(self._staging, exist_ok=True)
        local = os.path.join(self._staging,
                             os.path.basename(path.rstrip("/")))
        backoff = self.fetch_backoff_s
        last: Exception | None = None
        for attempt in range(self.fetch_attempts):
            if attempt:
                time.sleep(backoff)
                backoff *= 2.0
                monitor.counter_add("serving.fetch_retries")
            shutil.rmtree(local, ignore_errors=True)
            try:
                self._fs.get(path, local)
                return art.read_artifact(local, verify=True), local
            except (RuntimeError, OSError, ValueError,
                    CheckpointCorruptError) as err:
                last = err
        shutil.rmtree(local, ignore_errors=True)
        raise RuntimeError(
            f"artifact {path} failed to fetch/verify after "
            f"{self.fetch_attempts} attempts: {last}") from last

    def _build(self, loaded: dict, entry: dict) -> ServingModel:
        """The next ServingModel, off the request path. Base → a fresh
        table; delta → a copy-on-write merge into a copy of the newest
        version's table."""
        t0 = time.perf_counter()
        meta = loaded["meta"]
        if int(meta["version"]) != int(entry["version"]):
            # the CRCs prove the artifact matches ITS manifest only; a
            # misdirected path verifies clean as another version
            raise CheckpointCorruptError(
                str(entry.get("path", "?")),
                f"artifact claims v{meta['version']} != announced "
                f"v{entry['version']}")
        kind = meta["kind"]
        if kind == "base":
            g = meta.get("gate")
            gate = (GateSpec(int(g[0]), int(g[1]), float(g[2]),
                             float(g[3])) if g else None)
            table = ServingTable(loaded["keys"], loaded["vals"], gate=gate)
            hot_keys = np.asarray(loaded["keys"])[
                np.asarray(loaded["hot"], bool)].astype(np.uint64)
        else:
            newest = self._newest()
            table = newest.table.copy()
            table._merge(loaded["keys"], loaded["rows"])
            if len(loaded["removed"]):
                table._drop(loaded["removed"])
            hot_keys = newest.hot_keys
        predictor = self._make_predictor(loaded["model_meta"],
                                         loaded["dense_file"], table)
        hot_live = (int(table._probe(hot_keys)[1].sum())
                    if len(hot_keys) else 0)
        self.last_build_seconds = time.perf_counter() - t0
        monitor.counter_add("serving.build_seconds", self.last_build_seconds)
        return ServingModel(int(meta["version"]), int(meta["pass_id"]),
                            kind, predictor, table, hot_keys, hot_live,
                            int(entry.get("ts", meta.get("ts", 0))))

    def _make_predictor(self, model_meta: dict, dense_file: str,
                        table: ServingTable) -> Predictor:
        newest = self._newest()
        if newest is not None and \
                newest.predictor.model.name == model_meta["model"] and \
                export_lib.model_config(newest.predictor.model) \
                == model_meta["config"]:
            # same architecture: a fresh module of it with the new params
            params = export_lib.load_dense(newest.predictor.model,
                                           dense_file)
            return newest.predictor.with_model(params, table)
        model = export_lib.build_model(MODEL_REGISTRY[model_meta["model"]],
                                       model_meta["config"])
        params = export_lib.load_dense(model, dense_file)
        schema = export_lib._schema_from_json(model_meta["schema"])
        return Predictor(model, params, table, schema,
                         label_slot=model_meta.get("label_slot", "label"),
                         device=self.device)

    def promote_candidate(self) -> bool:
        """Promote the held candidate to stable. Returns whether one was
        held."""
        cand = self._candidate
        if cand is None:
            return False
        old = self._active
        t_swap = time.perf_counter()
        self._active = cand                # THE swap: one rebind
        self._candidate = None
        pause_ms = (time.perf_counter() - t_swap) * 1e3
        self._last_swap_pause_ms = pause_ms
        self._swaps += 1
        monitor.counter_add("serving.swaps")
        monitor.gauge_set("serving.active_version", cand.version)
        with self._lock:
            obs = self._obs_get()
            obs.ensure_version(cand.version, "stable")
            if old is not None:
                obs.drop_version(old.version)
        monitor.event("serving_swap", type="lifecycle",
                      version=cand.version, kind=cand.kind,
                      role="stable", promoted=True,
                      pass_id=cand.pass_id,
                      swap_pause_ms=round(pause_ms, 3),
                      keys=len(cand.table))
        return True

    # ---- request path ----------------------------------------------------

    def _handle(self) -> ServingModel:
        m = self._active
        if m is None:
            raise ServingUnavailableError(
                f"no serving model loaded from {self.root} yet "
                f"(last error: {self._last_error})")
        return m

    def _obs_get(self) -> ServingObs:
        if self._obs is None:
            self._obs = ServingObs()
        return self._obs

    def _score(self, model: ServingModel, ids, mask, dense,
               served: bool) -> np.ndarray:
        """Score one batch on ``model``, with per-version latency and
        score attribution when windows or the split are on."""
        role = "candidate" if model is self._candidate else "stable"
        t0 = time.perf_counter()
        out = model.predictor.predict(ids, mask, dense)
        if flags.serving_window_s > 0 or self._split_on():
            with self._lock:
                self._obs_get().record(
                    model.version, role, out,
                    (time.perf_counter() - t0) * 1e3, served)
        return out

    def predict(self, ids: np.ndarray, mask: np.ndarray,
                dense: np.ndarray | None = None) -> np.ndarray:
        m = self._handle()
        cand = self._candidate
        serve_model = m
        if cand is not None and not flags.serving_shadow:
            # deterministic live split: every 1/fraction-th batch goes to
            # the candidate (an accumulator, not a draw)
            frac = float(flags.serving_split_fraction)
            if frac > 0.0:
                with self._lock:
                    self._split_acc += frac
                    if self._split_acc >= 1.0:
                        self._split_acc -= 1.0
                        serve_model = cand
        try:
            out = self._score(serve_model, ids, mask, dense, served=True)
        except Exception:
            with self._lock:
                self._request_failures += 1
            monitor.counter_add("serving.request_failures")
            raise
        if cand is not None and flags.serving_shadow:
            # shadow: the candidate scores too; its failure is counted
            # and never reaches the caller
            try:
                self._score(cand, ids, mask, dense, served=False)
            except Exception:   # noqa: BLE001
                with self._lock:
                    self._shadow_failures += 1
                monitor.counter_add("serving.shadow_failures")
        with self._lock:
            self._served += len(np.asarray(ids))
        return out

    def predict_batch(self, pb) -> np.ndarray:
        m = self._handle()
        try:
            out = m.predictor.predict_batch(pb)
        except Exception:
            with self._lock:
                self._request_failures += 1
            monitor.counter_add("serving.request_failures")
            raise
        with self._lock:
            self._served += int(pb.num)
        return out

    # ---- delayed labels / window records ---------------------------------

    def observe_labels(self, labels, *, preds=None,
                       version: int | None = None) -> dict:
        """Delayed labels arrived: join them to the scores the loaded
        versions produced and feed each version's AUC. Returns
        {version: joined_count}."""
        with self._lock:
            return self._obs_get().observe_labels(labels, version=version,
                                                  preds=preds)

    def commit_window(self, force: bool = False,
                      now: float | None = None) -> dict | None:
        """Close one serving window when its cadence is due (``force``
        for stepping by hand) and return the record's fields; None when
        not due."""
        obs = self._obs_get()
        if not (force or obs.due(now)):
            return None
        newest = self._newest()
        ann_pass = _entry_int(self._latest_announced, "pass")
        lag = (max(0, ann_pass - newest.pass_id)
               if newest is not None and ann_pass is not None else 0)
        with self._lock:
            fields = obs.commit(
                now,
                failures=int(self._request_failures
                             - self._win_failures0),
                swaps=int(self._swaps - self._win_swaps0),
                version_lag=int(lag),
                active_version=(self._active.version
                                if self._active else None),
                candidate_version=(self._candidate.version
                                   if self._candidate else None),
                replica_hot_keys=newest.hot_live if newest else 0)
        self._win_failures0 = self._request_failures
        self._win_swaps0 = self._swaps
        monitor.event("serving_window", type="serving_record", **fields)
        return fields

    # ---- staleness / health ----------------------------------------------

    def _update_staleness_gauges(self) -> None:
        h = self.health()
        if h["pass_lag"] is not None:
            monitor.gauge_set("serving.pass_lag", h["pass_lag"])
        if h["age_seconds"] is not None:
            monitor.gauge_set("serving.staleness_seconds",
                              h["age_seconds"])

    def health(self) -> dict:
        """What is serving, how stale it is, and whether the tail is
        degraded (newer versions announced but unloadable). ``status``:
        ok | stale | degraded | empty."""
        m = self._active
        cand = self._candidate
        newest = cand or m
        ann = self._latest_announced
        # a snapshot: the tailer inserts while the HTTP thread reads
        skipped = list(self._skipped)
        ann_v = _entry_int(ann, "version")
        ann_pass = _entry_int(ann, "pass")
        now = time.time()
        if m is None:
            status = "empty"
            pass_lag = ann_pass
            age = None
        else:
            pass_lag = (max(0, ann_pass - newest.pass_id)
                        if ann_pass is not None else 0)
            age = now - (newest.published_ts or newest.loaded_ts)
            if ann_v is not None and ann_v > newest.version \
                    and any(v > newest.version for v in skipped):
                status = "degraded"
            elif pass_lag > self.stale_pass_lag \
                    or age > self.stale_after_s:
                status = "stale"
            else:
                status = "ok"
        versions = {}
        for vm, role in ((m, "stable"), (cand, "candidate")):
            if vm is None:
                continue
            versions[str(vm.version)] = {
                "role": role, "pass_id": vm.pass_id, "kind": vm.kind,
                "age_seconds": round(
                    now - (vm.published_ts or vm.loaded_ts), 1)}
        return {"status": status,
                "building": self._building,
                "device": str(self.device),
                "active_version": m.version if m else None,
                "active_pass": m.pass_id if m else None,
                "active_kind": m.kind if m else None,
                "table_keys": len(m.table) if m else 0,
                "hot_cached_keys": m.hot_live if m else 0,
                "candidate_version": cand.version if cand else None,
                "candidate_pass": cand.pass_id if cand else None,
                "split_fraction": float(flags.serving_split_fraction),
                "shadow": bool(flags.serving_shadow),
                "versions": versions,
                "announced_version": ann_v,
                "announced_pass": ann_pass,
                "pass_lag": pass_lag,
                "age_seconds": None if age is None else round(age, 1),
                "swaps": self._swaps,
                "last_swap_pause_ms": round(self._last_swap_pause_ms, 3),
                "last_build_seconds": round(self.last_build_seconds, 4),
                "served": self._served,
                "request_failures": self._request_failures,
                "shadow_failures": self._shadow_failures,
                "skipped_versions": sorted(skipped),
                "last_error": self._last_error}

    # ---- background tailer ----------------------------------------------

    def start(self) -> "ServingServer":
        """Background donefile tailer: poll every ``poll_s`` seconds. A
        poll that raises is recorded and the loop goes on: the server
        keeps serving what it has."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception as e:   # noqa: BLE001
                    self._last_error = f"poll failed: {e!r}"
                    monitor.counter_add("serving.poll_failures")
                self._stop.wait(self.poll_s)

        self._thread = mon_ctx.spawn(_run, name="serving-tailer")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None

    # ---- health endpoint -------------------------------------------------

    def _start_health_endpoint(self, port: int) -> None:
        """A stdlib HTTP endpoint on 127.0.0.1: ``/healthz`` the
        health() JSON (200 while a model serves, 503 before the first
        load); ``/metrics`` the telemetry hub's Prometheus text."""
        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.startswith("/healthz"):
                    body = json.dumps(server.health()).encode()
                    code = 503 if server._active is None else 200
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = monitor.hub().prometheus_text().encode()
                    code, ctype = 200, "text/plain; version=0.0.4"
                else:
                    body, code, ctype = b"not found", 404, "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._http = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                     _Handler)
        self.health_port = self._http.server_address[1]
        mon_ctx.spawn(self._http.serve_forever,
                      name="serving-health").start()


def main(argv: list[str] | None = None) -> int:
    """``python -m paddlebox_tpu_torch.serving.server ROOT
    [--health-port N] [--device cuda|cpu]``: tail ROOT's donefile,
    hot-swapping each announced version, and serve /healthz."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Serve the newest verified model published to ROOT "
                    "(tails serving_model.donefile; hot-swaps new "
                    "versions under load; degrades to the last good "
                    "version when publishes stop or verification fails)")
    ap.add_argument("root", help="local serving root")
    ap.add_argument("--poll-s", type=float, default=1.0)
    ap.add_argument("--health-port", type=int, default=8080,
                    help="0 picks a free port; printed on startup")
    ap.add_argument("--stale-pass-lag", type=int, default=2)
    ap.add_argument("--stale-after-s", type=float, default=600.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    srv = ServingServer(args.root, poll_s=args.poll_s,
                        stale_pass_lag=args.stale_pass_lag,
                        stale_after_s=args.stale_after_s,
                        health_port=args.health_port,
                        device=args.device).start()
    print(f"serving {args.root} on {srv.device}; health at "
          f"http://127.0.0.1:{srv.health_port}/healthz", flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
