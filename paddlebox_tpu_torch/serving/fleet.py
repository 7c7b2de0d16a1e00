"""Serving replica fleet — the port of ``paddlebox_tpu/serving/fleet.py``
(``SharedStagingCache`` :72, ``FleetReplicaServer`` :230,
``LocalReplica`` :239, ``SubprocessReplica`` :264, ``ReplicaFleet``
:398, ``PromotionGovernor`` :606, the CLI :698-835).

One serving host runs N replicas of the same donefile, so that a
hot-swap or a crash never takes the whole host out of rotation. This
module is the host-side supervisor around ``serving/server.py``:

- :class:`SharedStagingCache` — one download and CRC verify per version
  per host. Replicas race for a per-version lease (an atomic hard-link
  create); the winner copies into a tmp name, verifies the manifest and
  renames the verified copy into place (tmp → verify → rename → dir
  fsync). Losers wait on the final name. A holder that dies mid-download
  (``serving.fleet.lease.pre_verify``) leaves a lease whose mtime stops
  advancing: it expires, a waiter retakes it and sweeps the orphaned
  tmp, and the host still ends with exactly one verified copy. The
  lease's probe file is named per caller (pid and a uuid), so threads
  of one process never share one — the reference names it by pid
  alone, and two threads of a process can then unlink each other's
  probe mid-race.
- :class:`ReplicaFleet` — spawns N :class:`SubprocessReplica` processes
  off one root, restarts a crashed replica with bounded exponential
  backoff, and quarantines a replica that crash-loops on one announced
  version (the version is the fault; the router routes around it). Each
  window it emits a ``fleet_window`` record (``type="fleet_record"``,
  ``monitor/flight.validate_fleet_record``) that the doctor's
  ``fleet-degraded`` rule reads.
- :class:`PromotionGovernor` — verdict-guarded auto-promotion
  (``flags.serving_auto_promote``): the doctor's version-regression rule
  reads each serving window; a critical "do not promote" verdict holds
  the candidate fleet-wide and quarantines its version
  (``fleet_promote_hold``, ``fleet_version_quarantined``); only
  ``flags.serving_promote_windows`` consecutive clean windows promote,
  ``promote()`` on every replica (``fleet_promoted``).

Each replica is its own process, started as a fresh interpreter
(``python -m paddlebox_tpu_torch.serving.fleet --serve-replica ...
--device DEV``, fork and exec: no CUDA state is ever inherited), so on
the card each one holds its own CUDA context on ``cuda:0``. Replicas
score on the card unless the fleet is given ``device="cpu"``. A replica
whose parent is gone exits on its own.

Runbook::

    python -m paddlebox_tpu_torch.serving.fleet ROOT --replicas 2

spawns the replicas (``--serve-replica`` is the internal per-replica
entry point: a FleetReplicaServer and an HTTP endpoint serving
/healthz, /metrics, /score and /promote) and supervises them until
interrupted.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor import doctor as doctor_lib
from paddlebox_tpu_torch.serving.server import ServingServer
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import fs as fs_lib
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError


# ---------------------------------------------------------------------------
# shared staging: one download + verify per version per host
# ---------------------------------------------------------------------------

class SharedStagingCache:
    """Per-host staging directory shared by every replica.

    Layout::

        <root>/versions/<name>                 the verified copies
        <root>/versions/.tmp.<name>.<pid>.<uuid> an in-flight download
        <root>/leases/<name>.lease             the download lease

    The lease is an atomic hard-link create (``os.link`` of a unique tmp
    onto the lease name: succeeds for exactly one process). The holder
    touches it before the verify so a long download keeps it fresh; a
    holder that died stops touching it, the mtime ages past
    ``lease_ttl_s``, and a waiting replica unlinks + retakes it
    (``fleet_lease_retaken``), sweeping the dead holder's tmp. The final
    name only ever appears via rename-after-verify, so a reader can
    trust any directory it finds under it.
    """

    def __init__(self, root: str, *, lease_ttl_s: float = 30.0,
                 poll_s: float = 0.05, wait_timeout_s: float = 120.0):
        self.root = os.path.abspath(root)
        self.lease_ttl_s = float(lease_ttl_s)
        self.poll_s = float(poll_s)
        self.wait_timeout_s = float(wait_timeout_s)
        self.versions_dir = os.path.join(self.root, "versions")
        self.leases_dir = os.path.join(self.root, "leases")
        os.makedirs(self.versions_dir, exist_ok=True)
        os.makedirs(self.leases_dir, exist_ok=True)
        self.downloads = 0             # this instance fetched + verified
        self.cache_hits = 0            # final name already present
        self.lease_waits = 0           # waited on another holder
        self.lease_retakes = 0         # took over an expired lease
        self._lock = threading.Lock()  # the counters, across threads

    # -- lease primitives --------------------------------------------------

    def _lease_path(self, name: str) -> str:
        return os.path.join(self.leases_dir, f"{name}.lease")

    @staticmethod
    def _unique() -> str:
        """A name part no other caller shares: threads of one process
        have one pid, so the pid alone would let two racing threads
        write, link and unlink the same probe file."""
        return f"{os.getpid()}.{uuid.uuid4().hex}"

    def _try_acquire(self, name: str) -> bool:
        """Atomically create the lease file; True iff WE hold it now."""
        lease = self._lease_path(name)
        probe = f"{lease}.probe.{self._unique()}"
        with open(probe, "w") as f:
            f.write(json.dumps({"pid": os.getpid(), "ts": time.time()}))
        try:
            os.link(probe, lease)      # atomic: exactly one winner
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(probe)

    def _lease_age(self, name: str) -> float | None:
        try:
            return time.time() - os.stat(self._lease_path(name)).st_mtime
        except FileNotFoundError:
            return None

    def _release(self, name: str) -> None:
        try:
            os.unlink(self._lease_path(name))
        # pblint: disable=silent-except -- expired + retaken under us:
        # the lease is gone, which is exactly what release wants
        except FileNotFoundError:
            pass

    def _sweep_tmp(self, name: str) -> None:
        """Remove orphaned in-flight copies of ``name`` (a dead holder's
        partial download) — takeover starts from clean bytes."""
        prefix = f".tmp.{name}."
        for entry in os.listdir(self.versions_dir):
            if entry.startswith(prefix):
                shutil.rmtree(os.path.join(self.versions_dir, entry),
                              ignore_errors=True)

    # -- the one public operation -----------------------------------------

    def materialize(self, path: str) -> str:
        """A verified local copy of artifact ``path`` under the shared
        staging dir; downloads (or copies) + verifies at most once per
        version per host, however many replicas ask concurrently."""
        name = os.path.basename(path.rstrip("/"))
        final = os.path.join(self.versions_dir, name)
        deadline = time.monotonic() + self.wait_timeout_s
        waited = False
        while True:
            if os.path.isdir(final):
                self._count("cache_hits")
                return final
            if self._try_acquire(name):
                break
            # someone else holds the download lease: wait for the final
            # name — unless the holder died and the lease went stale
            waited = True
            age = self._lease_age(name)
            if age is not None and age > self.lease_ttl_s:
                self._release(name)    # expire it; next loop re-races
                self._count("lease_retakes")
                monitor.counter_add("fleet.lease_retakes")
                monitor.event("fleet_lease_retaken", version=name,
                              stale_age_s=round(age, 3))
                continue
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"gave up waiting for staging of {name!r} after "
                    f"{self.wait_timeout_s}s (lease age {age})")
            time.sleep(self.poll_s)
        if waited:
            self._count("lease_waits")
        try:
            # the final name may have landed between our last check and
            # the acquire (the previous holder finished first)
            if os.path.isdir(final):
                self._count("cache_hits")
                return final
            self._sweep_tmp(name)      # a dead holder's partial bytes
            tmp = os.path.join(self.versions_dir,
                               f".tmp.{name}.{self._unique()}")
            if fs_lib.is_remote(path):
                fs_lib.resolve(path)[0].get(path, tmp)
            else:
                shutil.copytree(path, tmp)
            # long fetch done: refresh the lease so the verify below
            # cannot be raced by an expiry-takeover
            os.utime(self._lease_path(name))
            # the registered crash window: bytes staged, verify + rename
            # not yet run — dying here must leave the lease expirable
            # and never a torn copy under the final name
            faultpoint.hit("serving.fleet.lease.pre_verify")
            try:
                ckpt_lib.verify_manifest(tmp)
            except CheckpointCorruptError:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            os.rename(tmp, final)      # atomic: verified bytes only
            dfd = os.open(self.versions_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)          # make the rename itself durable
            finally:
                os.close(dfd)
            self._count("downloads")
            monitor.counter_add("fleet.staging_downloads")
            return final
        finally:
            self._release(name)

    def _count(self, what: str) -> None:
        with self._lock:
            setattr(self, what, getattr(self, what) + 1)

    def stats(self) -> dict:
        return {"downloads": self.downloads,
                "cache_hits": self.cache_hits,
                "lease_waits": self.lease_waits,
                "lease_retakes": self.lease_retakes}


# ---------------------------------------------------------------------------
# replica handles (the router's duck type)
# ---------------------------------------------------------------------------

class FleetReplicaServer(ServingServer):
    """A ServingServer with the fleet's build crash window on its swap
    path (the replica-killed-mid-swap leg of the kill matrix)."""

    def _build(self, loaded, entry):
        faultpoint.hit("serving.fleet.replica.pre_build")
        return super()._build(loaded, entry)


class LocalReplica:
    """In-process replica: a FleetReplicaServer + BatchingFrontend pair
    behind the router's handle protocol (tests; the real fleet runs
    SubprocessReplica)."""

    def __init__(self, name: str, server: ServingServer, frontend):
        self.name = name
        self.server = server
        self.frontend = frontend
        self.quarantined = False

    @property
    def inflight(self) -> int:
        return self.frontend.inflight

    def health(self) -> dict:
        return self.server.health()

    def submit(self, ids, mask, dense=None) -> Future:
        return self.frontend.submit(ids, mask, dense)

    def promote(self) -> bool:
        return self.server.promote_candidate()


class SubprocessReplica:
    """One replica OS process (the ``--serve-replica`` entrypoint) plus
    the HTTP client side of the router's handle protocol. The process
    boundary is the point: a kill drops exactly this replica."""

    def __init__(self, index: int, root: str, *, staging_root: str,
                 workdir: str, poll_s: float = 0.2,
                 extra_env: dict | None = None,
                 spawn_timeout_s: float = 120.0,
                 device: str | None = None):
        # the card unless the caller asks for the CPU; the child process
        # opens its own CUDA context on this device
        self.device = str(resolve_device(device))
        self.index = int(index)
        self.name = f"replica-{index}"
        self.root = root
        self.staging_root = staging_root
        self.workdir = workdir
        self.poll_s = float(poll_s)
        self.extra_env = dict(extra_env or {})
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.quarantined = False
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.exits: list[int] = []
        self._inflight = 0
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix=f"{self.name}-client")
        os.makedirs(workdir, exist_ok=True)

    # -- lifecycle ---------------------------------------------------------

    def spawn(self) -> "SubprocessReplica":
        port_file = os.path.join(self.workdir, f"{self.name}.port.json")
        try:
            os.unlink(port_file)
        # pblint: disable=silent-except -- first spawn has no stale
        # port file to clear; nothing was lost
        except FileNotFoundError:
            pass
        env = dict(os.environ)
        env.update(self.extra_env)
        log = open(os.path.join(self.workdir, f"{self.name}.log"), "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddlebox_tpu_torch.serving.fleet",
             "--serve-replica", self.root,
             "--staging-root", self.staging_root,
             "--port-file", port_file,
             "--poll-s", str(self.poll_s),
             "--device", self.device],
            env=env, stdout=log, stderr=log)
        log.close()                    # the child holds its own handle
        deadline = time.monotonic() + self.spawn_timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"{self.name} exited {self.proc.returncode} before "
                    f"publishing its port (see {self.name}.log)")
            if os.path.exists(port_file):
                with open(port_file) as f:
                    self.port = int(json.load(f)["port"])
                return self
            time.sleep(0.02)
        self._reap()                   # never leave a half-started child
        raise TimeoutError(f"{self.name} never published its port")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _reap(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)

    def stop(self) -> None:
        self._reap()
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- router handle protocol -------------------------------------------

    @property
    def inflight(self) -> int:
        return self._inflight

    def _url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def _get_json(self, path: str, timeout: float = 2.0) -> dict:
        with urllib.request.urlopen(self._url(path),
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    def _post_json(self, path: str, payload: dict,
                   timeout: float = 30.0) -> dict:
        req = urllib.request.Request(
            self._url(path), data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")[:300]
            raise RuntimeError(
                f"{self.name} {path} -> {e.code}: {body}") from e

    def health(self) -> dict:
        # /healthz answers 503 (with the same JSON body) before the
        # first load — "empty" is a health state, not a client error
        try:
            return self._get_json("/healthz")
        except urllib.error.HTTPError as e:
            return json.loads(e.read().decode())

    def submit(self, ids, mask, dense=None) -> Future:
        payload = {"ids": np.asarray(ids).tolist(),
                   "mask": np.asarray(mask).astype(int).tolist()}
        if dense is not None:
            payload["dense"] = np.asarray(dense).tolist()

        def _call():
            try:
                out = self._post_json("/score", payload)
                return np.asarray(out["scores"])
            finally:
                with self._lock:
                    self._inflight -= 1
        with self._lock:
            self._inflight += 1
        return self._pool.submit(_call)

    def promote(self) -> bool:
        return bool(self._post_json("/promote", {}).get("promoted"))


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class ReplicaFleet:
    """Spawns + supervises N SubprocessReplica workers off one root.

    Restart policy: a crashed replica restarts after a bounded
    exponential backoff (``backoff0_s`` doubling to ``backoff_max_s``);
    crash-looping ``max_restarts_per_version`` times while the SAME
    version is announced quarantines the replica — the version (not the
    machine) is the likely fault, and fail-over beats a restart storm.
    """

    def __init__(self, root: str, *, replicas: int | None = None,
                 staging_root: str | None = None,
                 workdir: str | None = None, poll_s: float = 0.2,
                 backoff0_s: float = 0.5, backoff_max_s: float = 10.0,
                 max_restarts_per_version: int = 3,
                 window_s: float | None = None,
                 replica_env=None, supervise_tick_s: float = 0.1,
                 device: str | None = None):
        # flags.serving_fleet_replicas is the deploy-wide default; the
        # kwarg the caller's override
        self.n = int(flags.serving_fleet_replicas
                     if replicas is None else replicas)
        if self.n < 1:
            raise ValueError(f"fleet needs >=1 replica, got {self.n}")
        self.root = root
        self.device = str(resolve_device(device))
        base = workdir or tempfile.mkdtemp(prefix="pbt_fleet_")
        self.workdir = os.path.abspath(base)
        self.staging_root = os.path.abspath(
            staging_root or os.path.join(self.workdir, "staging"))
        self.poll_s = float(poll_s)
        self.backoff0_s = float(backoff0_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_restarts_per_version = int(max_restarts_per_version)
        self.window_s = float(flags.serving_window_s
                              if window_s is None else window_s)
        self.supervise_tick_s = float(supervise_tick_s)
        self._replica_env = replica_env or (lambda i: {})
        self.replicas: list[SubprocessReplica] = [
            SubprocessReplica(
                i, root, staging_root=self.staging_root,
                workdir=self.workdir, poll_s=poll_s,
                extra_env=self._replica_env(i), device=self.device)
            for i in range(self.n)]
        self.router = None             # attach_router()
        self.governor = None           # attach_governor()
        self.restarts = 0
        self._restarts_by_version: dict[int, dict] = {
            i: {} for i in range(self.n)}
        self._next_spawn: dict[int, float] = {}
        self._last_health: dict[int, dict] = {}
        self._window_start = time.time()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def attach_router(self, router) -> None:
        """The router whose dispatch stats ride the fleet_record."""
        self.router = router

    def attach_governor(self, governor) -> None:
        self.governor = governor

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaFleet":
        for r in self.replicas:
            r.spawn()
        self._stop.clear()
        self._thread = mon_ctx.spawn(self._supervise,
                                     name="fleet-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        for r in self.replicas:
            r.stop()

    # -- supervision -------------------------------------------------------

    def _supervise(self) -> None:
        while not self._stop.is_set():
            try:
                self.supervise_once()
            except Exception as e:   # noqa: BLE001 — the supervisor's
                # job under failure is to keep supervising
                monitor.counter_add("fleet.supervise_errors")
                monitor.event("fleet_supervise_error", error=repr(e))
            self.commit_window()       # due-gated; no-op early
            self._stop.wait(self.supervise_tick_s)

    def supervise_once(self) -> None:
        """One supervision tick (public for test-driven stepping):
        refresh health, detect exits, restart-with-backoff or
        quarantine."""
        now = time.monotonic()
        for r in self.replicas:
            if r.quarantined:
                continue
            if r.alive():
                try:
                    self._last_health[r.index] = r.health()
                # pblint: disable=silent-except -- a replica between
                # spawn and its HTTP bind answers nothing; liveness is
                # tracked by the process, health stays last-known
                except Exception:   # noqa: BLE001
                    pass
                continue
            due = self._next_spawn.get(r.index)
            if due is None:
                self._on_exit(r, now)
            elif now >= due:
                del self._next_spawn[r.index]
                try:
                    r.spawn()
                    if self.router is not None:
                        self.router.invalidate_health(r.name)
                except Exception as e:   # noqa: BLE001 — a failed
                    # respawn re-enters the backoff loop, it must not
                    # kill the supervisor
                    monitor.event("fleet_supervise_error",
                                  replica=r.name, error=repr(e))
                    self._on_exit(r, now)

    def _announced_version(self, index: int) -> int:
        h = self._last_health.get(index) or {}
        v = h.get("announced_version")
        return int(v) if isinstance(v, int) else -1

    def _on_exit(self, r: SubprocessReplica, now: float) -> None:
        code = r.proc.returncode if r.proc is not None else -1
        r.exits.append(int(code))
        version = self._announced_version(r.index)
        counts = self._restarts_by_version[r.index]
        counts[version] = counts.get(version, 0) + 1
        if self.router is not None:
            self.router.invalidate_health(r.name)
        if counts[version] > self.max_restarts_per_version:
            # crash-loop on ONE version: fail-stop this replica and let
            # the router fail traffic over to its peers — the version is
            # the repeating variable, restart #N+1 would die the same way
            r.quarantined = True
            monitor.counter_add("fleet.replica_quarantines")
            monitor.event("fleet_replica_quarantined", replica=r.name,
                          exit_code=int(code), version=version,
                          crashes=counts[version])
            return
        self.restarts += 1
        backoff = min(self.backoff_max_s,
                      self.backoff0_s * (2 ** (counts[version] - 1)))
        self._next_spawn[r.index] = now + backoff
        monitor.counter_add("fleet.replica_restarts")
        monitor.event("fleet_replica_restart", replica=r.name,
                      exit_code=int(code), version=version,
                      crashes=counts[version],
                      backoff_s=round(backoff, 3))

    # -- the fleet flight record ------------------------------------------

    def healthy_count(self) -> int:
        n = 0
        for r in self.replicas:
            if r.quarantined or not r.alive():
                continue
            h = self._last_health.get(r.index) or {}
            if h.get("status") == "ok":
                n += 1
        return n

    def commit_window(self, force: bool = False,
                      now: float | None = None) -> dict | None:
        """Emit one ``fleet_record`` when the window cadence is due
        (``force`` for stepping by hand). None when not due or the
        cadence is off."""
        now = time.time() if now is None else now
        if not force and (self.window_s <= 0
                          or now - self._window_start < self.window_s):
            return None
        rs = (self.router.stats() if self.router is not None
              else {})
        fields = {
            "window_s": round(now - self._window_start, 3),
            "replicas": int(self.n),
            "healthy": int(self.healthy_count()),
            "quarantined": sum(1 for r in self.replicas
                               if r.quarantined),
            "requests": int(rs.get("requests", 0)),
            "sheds": int(rs.get("sheds", 0)),
            "retries": int(rs.get("retries", 0)),
            "hedges": int(rs.get("hedges", 0)),
            "hedges_won": int(rs.get("hedges_won", 0)),
            "restarts": int(self.restarts),
            "promote_holds": int(self.governor.promote_holds
                                 if self.governor is not None else 0),
            "p50_ms": float(rs.get("p50_ms", 0.0)),
            "p99_ms": float(rs.get("p99_ms", 0.0)),
        }
        self._window_start = now
        monitor.event("fleet_window", type="fleet_record", **fields)
        monitor.gauge_set("fleet.healthy_replicas", fields["healthy"])
        return fields


# ---------------------------------------------------------------------------
# verdict-guarded auto-promotion
# ---------------------------------------------------------------------------

class PromotionGovernor:
    """Drives ``promote_candidate()`` fleet-wide off the doctor's
    version-regression verdict (flags.serving_auto_promote).

    Feed it serving window records (each replica's ``commit_window``
    fields, or the aggregate's ``serving_records``) via :meth:`observe`.
    A CRITICAL verdict (the rule's "do not promote" suggestion) HOLDS
    the candidate and quarantines that version — it can never promote,
    even if later windows look clean (a regression that comes and goes
    is still a regression). Promotion requires K consecutive clean
    windows WITH signal: no-data windows reset nothing but do not count.
    """

    def __init__(self, replicas, *, windows: int | None = None,
                 history: int = 32):
        self.replicas = list(replicas)
        # flags.serving_promote_windows is the deploy default, the
        # kwarg the test override
        self.windows = int(flags.serving_promote_windows
                           if windows is None else windows)
        self.history = int(history)
        self.rule = doctor_lib.VersionRegressionRule()
        self._seen: list[dict] = []
        self.clean_windows = 0
        self.promote_holds = 0
        self.held_versions: set[int] = set()
        self.promoted_versions: list[int] = []

    def observe(self, serving_fields: dict) -> str:
        """One serving window record → the promotion decision for it:
        ``disabled`` | ``no-candidate`` | ``held`` | ``hold`` |
        ``no-data`` | ``clean`` | ``promoted``."""
        if not bool(flags.serving_auto_promote):
            return "disabled"
        self._seen.append(dict(serving_fields))
        del self._seen[:-self.history]
        cand = serving_fields.get("candidate_version")
        if cand is None:
            self.clean_windows = 0
            return "no-candidate"
        cand = int(cand)
        if cand in self.held_versions:
            return "held"
        status, finding = self.rule.evaluate(
            doctor_lib.DoctorContext(servings=list(self._seen)))
        if status == "fired" and finding["severity"] == "critical":
            # the rule's suggestion starts "do not promote" — enforce
            # it fleet-wide: hold + quarantine THIS version forever
            self.held_versions.add(cand)
            self.promote_holds += 1
            self.clean_windows = 0
            monitor.counter_add("fleet.promote_holds")
            monitor.event("fleet_promote_hold", version=cand,
                          rule=finding["rule"],
                          summary=finding["summary"][:300])
            monitor.event("fleet_version_quarantined", version=cand,
                          rule=finding["rule"])
            return "hold"
        if status == "fired":
            # warn (score-KL drift without an AUC gap): not promotable
            # evidence, not quarantine evidence — hold position
            self.clean_windows = 0
            return "hold"
        if status == "no-data":
            return "no-data"           # no signal: neither count nor reset
        self.clean_windows += 1
        if self.clean_windows < self.windows:
            return "clean"
        promoted = 0
        for r in self.replicas:
            try:
                promoted += bool(r.promote())
            except Exception as e:   # noqa: BLE001 — one unreachable
                # replica must not leave the fleet half-promoted forever;
                # its own tailer promotes on the next poll (split-off
                # path) and the event below names the miss
                monitor.event("fleet_supervise_error",
                              replica=getattr(r, "name", "?"),
                              error=f"promote failed: {e!r}")
        self.clean_windows = 0
        self.promoted_versions.append(cand)
        monitor.counter_add("fleet.promotions")
        monitor.event("fleet_promoted", version=cand,
                      replicas_promoted=int(promoted),
                      clean_windows=self.windows)
        return "promoted"


# ---------------------------------------------------------------------------
# CLI: fleet supervisor + the internal per-replica / stager entrypoints
# ---------------------------------------------------------------------------

def _serve_replica(args) -> int:
    """Internal entrypoint (one replica process): FleetReplicaServer off
    the shared staging cache + an HTTP endpoint with the router's
    surface (/healthz, /metrics, /score, /promote)."""
    import http.server

    parent = os.getppid()
    cache = SharedStagingCache(args.staging_root)
    srv = FleetReplicaServer(args.root, poll_s=args.poll_s,
                             staging_cache=cache,
                             device=args.device).start()

    class _Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):   # noqa: N802 (stdlib API)
            if self.path.startswith("/healthz"):
                h = srv.health()
                h["staging"] = cache.stats()
                self._send(503 if srv.active is None else 200, h)
            elif self.path.startswith("/metrics"):
                body = monitor.hub().prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):   # noqa: N802 (stdlib API)
            n = int(self.headers.get("Content-Length") or 0)
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            if self.path.startswith("/score"):
                try:
                    ids = np.asarray(payload["ids"], np.uint64)
                    mask = np.asarray(payload["mask"], bool)
                    dense = (np.asarray(payload["dense"], np.float32)
                             if payload.get("dense") is not None
                             else None)
                    scores = srv.predict(ids, mask, dense)
                    self._send(200,
                               {"scores": np.asarray(scores).tolist()})
                except Exception as e:   # noqa: BLE001 — a scoring
                    # failure is the CALLER's named error, never a
                    # silent connection drop
                    self._send(500, {"error": repr(e)})
            elif self.path.startswith("/promote"):
                self._send(200, {"promoted": srv.promote_candidate()})
            else:
                self._send(404, {"error": "not found"})

        def log_message(self, *a):     # quiet: telemetry is the log
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    port = httpd.server_address[1]
    # the port file is the spawn handshake: committed atomically so the
    # supervisor can never read a torn write
    with ckpt_lib.atomic_file(args.port_file) as tmp:
        with open(tmp, "w") as f:
            json.dump({"port": port, "pid": os.getpid()}, f)
    mon_ctx.spawn(httpd.serve_forever, name="replica-endpoint").start()
    try:
        # a replica outlives no supervisor: when the parent is gone the
        # process was orphaned (the supervisor was killed) and exits
        while os.getppid() == parent:
            time.sleep(0.5)
    finally:
        httpd.shutdown()
        srv.stop()
    return 0


def _stage_once(args) -> int:
    """Internal entrypoint (lease kill matrix): materialize ONE artifact
    through the shared cache and print the result."""
    cache = SharedStagingCache(args.staging_root,
                               lease_ttl_s=args.lease_ttl_s)
    local = cache.materialize(args.stage)
    print(json.dumps({"local": local, **cache.stats()}), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    """The runbook's entry point:
    ``python -m paddlebox_tpu_torch.serving.fleet ROOT --replicas N
    [--device cuda|cpu]``."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Supervise N serving replicas off one donefile: "
                    "shared verified staging, crash restart with "
                    "backoff, crash-loop quarantine")
    ap.add_argument("root", help="serving root (local dir or hdfs:// URI)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="replica count (default: "
                         "flags.serving_fleet_replicas)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--staging-root", default=None)
    ap.add_argument("--poll-s", type=float, default=1.0)
    ap.add_argument("--lease-ttl-s", type=float, default=30.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: where the replicas "
                         "score")
    ap.add_argument("--serve-replica", action="store_true",
                    help=argparse.SUPPRESS)   # internal entrypoints
    ap.add_argument("--port-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stage", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if (args.stage is not None or args.serve_replica) \
            and args.staging_root is None:
        ap.error("--stage and --serve-replica need --staging-root")
    if args.stage is not None:
        # argparse reuses `root` as the staging positional's sibling:
        # --stage PATH materializes PATH, `root` is ignored
        return _stage_once(args)
    if args.serve_replica:
        if not args.port_file:
            ap.error("--serve-replica requires --port-file")
        return _serve_replica(args)
    fleet = ReplicaFleet(args.root, replicas=args.replicas,
                         workdir=args.workdir,
                         staging_root=args.staging_root,
                         poll_s=args.poll_s, device=args.device).start()
    print(f"fleet of {fleet.n} replicas on {args.root} ({fleet.device}); "
          f"workdir {fleet.workdir}", flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        fleet.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
