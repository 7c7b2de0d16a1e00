"""The port's serving fleet (``serving/fleet.py``) against the reference's
fleet tests (tests/test_fleet.py) and, where a record crosses, against
the JAX package itself:

- the fleet's crash windows are a closed registry, prefixed
  ``serving.fleet.``, disjoint from the other registries, and the same
  three names as the reference's;
- shared staging: 4 and 8 threads (a cache instance each on one root)
  race for one version and get exactly one download, and no thread
  raises; 16 or more threads sharing one instance, switching every
  microsecond, lose no counter update
  (the reference names the lease probe by pid alone, so threads of one
  process can unlink each other's probe: its test
  ``test_staging_one_download_per_host`` fails on that race); a corrupt
  artifact is refused with its lease released; a stale lease is
  retaken; a real stager process killed at
  ``serving.fleet.lease.pre_verify`` leaves an expirable lease, a peer
  retakes it and the host ends with one verified copy;
- ``ServingServer(staging_cache=)`` serves from the shared copy and
  keeps it after the build;
- the ``fleet_window`` record: its schema's negatives; each package's
  ``validate_fleet_record`` accepts the other's record, field for field;
  each package's doctor gives the same ``fleet-degraded`` verdict on
  one stream, and the port's doctor fires on a degraded stream that the
  port's ``ReplicaFleet.commit_window`` emitted;
- the promotion governor: disabled, no candidate, a worse candidate held
  fleet-wide and quarantined, an identical one promoted after K = 2
  clean windows;
- real replica processes on the CPU behind the router: /healthz,
  /metrics, /score and /promote answer, the scores equal a direct
  ``Predictor``'s (rtol 1e-5, atol 1e-6), and stopping the fleet leaves
  no child alive;
- the kill matrix's first leg (marked ``slow``, as the reference's is: it
  trains, publishes twice and waits on process restarts): a replica
  killed at ``serving.fleet.replica.pre_build`` mid-swap under four
  client threads costs 0 failed requests, is restarted, and the fleet
  converges on v2 with one verified staging copy per version.

Every thread join and wait has a timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddlebox_tpu import monitor as jmonitor
from paddlebox_tpu.monitor import doctor as jdoctor
from paddlebox_tpu.monitor import flight as jflight
from paddlebox_tpu.serving.fleet import ReplicaFleet as JaxReplicaFleet
from paddlebox_tpu.utils import faultpoint as jfaultpoint

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.monitor import doctor
from paddlebox_tpu_torch.monitor import flight
from paddlebox_tpu_torch.serving.fleet import (FleetReplicaServer,
                                               LocalReplica,
                                               PromotionGovernor,
                                               ReplicaFleet,
                                               SharedStagingCache)
from paddlebox_tpu_torch.serving.router import Router
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.checkpoint import CheckpointCorruptError

from test_torch_serving import FWD_TOL, Job, _WorsePredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultpoint.disarm()


@pytest.fixture()
def events():
    ms = monitor.MemorySink()
    monitor.hub().enable(ms)
    yield ms
    monitor.hub().disable()


@pytest.fixture()
def fleet_flags():
    keys = ("serving_shadow", "serving_split_fraction", "serving_window_s",
            "serving_auto_promote", "serving_promote_windows",
            "serving_hedge_factor", "serving_fleet_replicas")
    saved = {k: getattr(flags, k) for k in keys}
    yield flags
    for k, v in saved.items():
        flags.set(k, v)


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    env.pop("PBTPU_FAULTPOINT", None)
    env.update(extra or {})
    return env


# ------------------------------------------------------------ registry


def test_fleet_points_closed_registry():
    assert set(faultpoint.FLEET_POINTS) <= set(faultpoint.POINTS)
    assert all(p.startswith("serving.fleet.")
               for p in faultpoint.FLEET_POINTS)
    assert set(faultpoint.FLEET_POINTS) == {
        "serving.fleet.lease.pre_verify",
        "serving.fleet.replica.pre_build",
        "serving.fleet.router.pre_dispatch"}
    assert faultpoint.FLEET_POINTS == jfaultpoint.FLEET_POINTS
    assert not set(faultpoint.FLEET_POINTS) & (
        set(faultpoint.ELASTIC_POINTS) | set(faultpoint.ADMIT_POINTS))
    others = [p for p in faultpoint.POINTS
              if p not in faultpoint.FLEET_POINTS]
    assert not any(p.startswith("serving.fleet.") for p in others)


# ------------------------------------------------------------ staging


def _make_artifact(dirpath: str, payload: bytes = b"model-bytes") -> str:
    """A minimal manifest-committed artifact dir (the cache only cares
    about verify_manifest)."""
    os.makedirs(dirpath, exist_ok=True)
    member = os.path.join(dirpath, "payload.bin")
    with ckpt_lib.atomic_file(member) as tmp:
        with open(tmp, "wb") as f:
            f.write(payload)
    ckpt_lib.write_manifest(
        dirpath, {"payload.bin": ckpt_lib.file_entry(member)})
    return dirpath


def _staged(cache: SharedStagingCache) -> list[str]:
    return sorted(os.listdir(cache.versions_dir))


@pytest.mark.parametrize("n_threads", [4, 8])
def test_staging_one_download_per_host(tmp_path, n_threads):
    """Threads with their own cache instances on one shared root race for
    one version: one copy, one verify, and no thread raises."""
    src = _make_artifact(str(tmp_path / "pub" / "v-000001"))
    root = str(tmp_path / "staging")
    caches = [SharedStagingCache(root) for _ in range(n_threads)]
    outs: list[str] = []
    errors: list[BaseException] = []
    gate = threading.Barrier(n_threads)

    def _go(c):
        try:
            gate.wait(timeout=10)
            outs.append(c.materialize(src))
        except BaseException as e:   # asserted empty below
            errors.append(e)

    threads = [threading.Thread(target=_go, args=(c,)) for c in caches]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(outs) == n_threads
    assert len(set(outs)) == 1 and os.path.isdir(outs[0])
    ckpt_lib.verify_manifest(outs[0])
    assert sum(c.downloads for c in caches) == 1
    assert _staged(caches[0]) == ["v-000001"]   # no tmp orphans
    assert os.listdir(caches[0].leases_dir) == []
    before = caches[1].cache_hits
    assert caches[1].materialize(src) == outs[0]
    assert caches[1].cache_hits == before + 1


def test_staging_one_cache_shared_by_threads(tmp_path):
    """One instance shared by more threads than cores, switching often:
    one download, no thread raises, and the counters lose no update."""
    src = _make_artifact(str(tmp_path / "pub" / "v-000001"))
    cache = SharedStagingCache(str(tmp_path / "staging"))
    errors: list[BaseException] = []
    n = max(16, 2 * (os.cpu_count() or 1))
    gate = threading.Barrier(n)

    def _go():
        try:
            gate.wait(timeout=30)
            for _ in range(4):
                cache.materialize(src)
        except BaseException as e:   # asserted empty below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=_go) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    st = cache.stats()
    assert st["downloads"] == 1
    assert st["downloads"] + st["cache_hits"] == 4 * n


def test_staging_refuses_corrupt_artifact_and_releases_lease(tmp_path):
    src = _make_artifact(str(tmp_path / "pub" / "v-000002"))
    with open(os.path.join(src, "payload.bin"), "ab") as f:
        f.write(b"rot")                    # CRC mismatch vs manifest
    cache = SharedStagingCache(str(tmp_path / "staging"))
    with pytest.raises(CheckpointCorruptError):
        cache.materialize(src)
    assert _staged(cache) == []            # nothing under the final name
    assert os.listdir(cache.leases_dir) == []


def test_staging_stale_lease_expires_and_is_retaken(tmp_path, events):
    src = _make_artifact(str(tmp_path / "pub" / "v-000003"))
    cache = SharedStagingCache(str(tmp_path / "staging"), lease_ttl_s=0.2)
    lease = cache._lease_path("v-000003")
    with open(lease, "w") as f:
        f.write("{}")                      # a dead holder's lease
    old = time.time() - 10
    os.utime(lease, (old, old))
    out = cache.materialize(src)
    ckpt_lib.verify_manifest(out)
    assert cache.lease_retakes == 1 and cache.downloads == 1
    retaken = events.find("fleet_lease_retaken")
    assert retaken and retaken[-1]["fields"]["version"] == "v-000003"


def test_lease_holder_killed_mid_download_is_retaken(tmp_path, events):
    """A real stager process dies at serving.fleet.lease.pre_verify
    (bytes staged, verify and rename not run); its lease goes stale, a
    peer retakes it, and the host ends with one verified copy."""
    src = _make_artifact(str(tmp_path / "pub" / "v-000004"))
    staging = str(tmp_path / "staging")
    proc = subprocess.run(
        [sys.executable, "-m", "paddlebox_tpu_torch.serving.fleet",
         "unused-root", "--stage", src, "--staging-root", staging],
        env=_env({"PBTPU_FAULTPOINT": "serving.fleet.lease.pre_verify",
                  "PBTPU_FAULTPOINT_ACTION": "kill"}),
        capture_output=True, timeout=120)
    assert proc.returncode == 137, proc.stderr.decode()[-400:]
    assert b"FAULTPOINT KILL serving.fleet.lease.pre_verify" in proc.stderr
    cache = SharedStagingCache(staging, lease_ttl_s=0.3)
    assert os.path.exists(cache._lease_path("v-000004"))
    assert any(e.startswith(".tmp.v-000004.")
               for e in os.listdir(cache.versions_dir))
    time.sleep(0.35)                       # age the lease past the TTL
    out = cache.materialize(src)
    ckpt_lib.verify_manifest(out)
    assert cache.lease_retakes >= 1
    assert _staged(cache) == ["v-000004"]  # the orphaned tmp was swept
    assert os.listdir(cache.leases_dir) == []
    assert events.find("fleet_lease_retaken")


def test_server_reads_the_shared_copy_and_keeps_it(tmp_path):
    job = Job(str(tmp_path / "serve"))
    job.end()
    cache = SharedStagingCache(str(tmp_path / "staging"))
    servers = [FleetReplicaServer(job.root, device="cpu",
                                  staging_cache=cache) for _ in range(2)]
    for s in servers:
        assert s.poll_once() == 1
    assert cache.downloads == 1 and cache.cache_hits == 1
    assert _staged(cache) == ["v-000001"]  # kept after both builds
    ids, mask, dense, _ = job.request()
    want = job.live_scores()
    for s in servers:
        np.testing.assert_allclose(s.predict(ids, mask, dense), want,
                                   **FWD_TOL)


# --------------------------------------------------- fleet flight record


def _fleet_fields(**over):
    fields = {"window_s": 10.0, "replicas": 2, "healthy": 2,
              "quarantined": 0, "requests": 100, "sheds": 0,
              "retries": 1, "hedges": 3, "hedges_won": 2, "restarts": 0,
              "promote_holds": 0, "p50_ms": 2.0, "p99_ms": 9.0}
    fields.update(over)
    return fields


def test_fleet_record_schema_negatives(events):
    monitor.event("fleet_window", type="fleet_record", **_fleet_fields())
    rec = events.find("fleet_window")[-1]
    assert flight.validate_fleet_record(rec) == []
    bad = dict(rec)
    bad["fields"] = {k: v for k, v in rec["fields"].items()
                     if k != "healthy"}
    assert any("healthy" in e for e in flight.validate_fleet_record(bad))
    bad = dict(rec, fields=dict(rec["fields"], retries="three"))
    assert any("retries" in e for e in flight.validate_fleet_record(bad))
    bad = dict(rec, fields=dict(rec["fields"], sheds=True))
    assert any("sheds" in e for e in flight.validate_fleet_record(bad))
    bad = dict(rec, fields=dict(rec["fields"], healthy=5))
    assert any("healthy" in e for e in flight.validate_fleet_record(bad))
    bad = dict(rec, type="flight_record")
    assert any("fleet_record" in e for e in flight.validate_fleet_record(bad))


class _FakeHandle:
    """A router handle that answers at once (stats for the record)."""

    def __init__(self, name):
        self.name = name
        self.quarantined = False
        self.inflight = 0

    def health(self):
        return {"status": "ok", "active_version": 1, "age_seconds": 1.0}

    def submit(self, ids, mask, dense=None):
        from concurrent.futures import Future
        f = Future()
        f.set_result(0.5)
        return f


def _degraded_fleet(cls, tmp_path, tag, **kw):
    """A fleet (never started) whose replica 0 looks alive and ok and
    replica 1 dead: healthy 1 of 2, with a router's traffic."""
    fleet = cls(str(tmp_path / "root"), replicas=2,
                workdir=str(tmp_path / f"fw_{tag}"), window_s=0, **kw)
    fleet.replicas[0].alive = lambda: True
    fleet._last_health = {0: {"status": "ok"}, 1: {"status": "ok"}}
    fleet.restarts = 3
    handles = [_FakeHandle("a"), _FakeHandle("b")]
    from paddlebox_tpu.serving.router import Router as JaxRouter
    router = (Router if cls is ReplicaFleet else JaxRouter)(handles)
    for _ in range(5):
        router.score([1], [True])
    fleet.attach_router(router)
    return fleet


def test_fleet_records_cross_validate(tmp_path, events):
    """Each package's validate_fleet_record accepts the other's
    fleet_window record, and the two carry the same fields."""
    jms = jmonitor.MemorySink()
    jmonitor.hub().enable(jms)
    try:
        port = _degraded_fleet(ReplicaFleet, tmp_path, "p", device="cpu")
        jax_ = _degraded_fleet(JaxReplicaFleet, tmp_path, "j")
        got = port.commit_window(force=True)
        want = jax_.commit_window(force=True)
    finally:
        jmonitor.hub().disable()
    rec = events.find("fleet_window")[-1]
    jrec = jms.find("fleet_window")[-1]
    assert set(got) == set(want) == set(rec["fields"])
    assert got["healthy"] == want["healthy"] == 1
    for k in got:
        if k not in ("window_s", "p50_ms", "p99_ms"):
            assert got[k] == want[k], k
    assert flight.validate_fleet_record(rec) == []
    assert jflight.validate_fleet_record(rec) == []
    assert flight.validate_fleet_record(jrec) == []
    assert jflight.validate_fleet_record(jrec) == []


def _doctor_json(main, d, capsys) -> dict:
    code = main([d, "--json"])
    out = capsys.readouterr().out
    assert code == 0, out
    return json.loads(out.strip().splitlines()[-1])


def _finding(report: dict, rule: str):
    hits = [f for f in report["findings"] if f["rule"] == rule]
    return hits[0] if hits else None


@pytest.mark.parametrize("healthy,want_sev", [(1, "warn"), (0, "critical"),
                                              (2, None)])
def test_doctors_agree_on_fleet_degraded(tmp_path, capsys, healthy,
                                         want_sev):
    """One fleet_window stream written by the port's hub: both packages'
    doctor CLIs give the same fleet-degraded verdict."""
    d = str(tmp_path / "tel")
    hub = monitor.hub()
    hub.enable(monitor.JsonlSink(os.path.join(d, "events.jsonl")))
    try:
        for i in range(3):
            monitor.event("fleet_window", type="fleet_record",
                          **_fleet_fields(healthy=2 if i < 2 else healthy,
                                          requests=100 * (i + 1)))
    finally:
        hub.disable()
    mine = _finding(_doctor_json(doctor.main, d, capsys), "fleet-degraded")
    theirs = _finding(_doctor_json(jdoctor.main, d, capsys),
                      "fleet-degraded")
    if want_sev is None:
        assert mine is None and theirs is None
        return
    assert mine is not None and theirs is not None
    assert mine["severity"] == theirs["severity"] == want_sev
    assert mine["summary"] == theirs["summary"]
    assert mine["evidence"] == theirs["evidence"]


def test_doctor_fires_on_the_fleets_own_degraded_records(tmp_path, capsys):
    """The fleet emits the records the fleet-degraded rule reads: a
    window with one replica down fires it (warn), through the events
    file and the doctor CLI."""
    d = str(tmp_path / "tel")
    hub = monitor.hub()
    hub.enable(monitor.JsonlSink(os.path.join(d, "events.jsonl")))
    try:
        fleet = _degraded_fleet(ReplicaFleet, tmp_path, "p", device="cpu")
        fields = fleet.commit_window(force=True)
    finally:
        hub.disable()
    assert fields["healthy"] == 1 and fields["replicas"] == 2
    checked = flight.validate_events_file(os.path.join(d, "events.jsonl"))
    assert checked["errors"] == []
    f = _finding(_doctor_json(doctor.main, d, capsys), "fleet-degraded")
    assert f is not None and f["severity"] == "warn"
    assert "1/2 replica(s) out of rotation" in f["summary"]
    assert f["evidence"]["restarts"] == 3


# ------------------------------------------- verdict-guarded promotion


def _window_with_labels(srv, ids, mask, dense):
    """Serve a batch, join labels that separate the stable scores, and
    commit the window (identical candidate → same AUC; worse candidate
    → anti-correlated scores → an AUC gap)."""
    served = srv.predict(ids, mask, dense)
    labels = (np.asarray(served) >
              np.median(served)).astype(np.float64).reshape(-1)
    srv.observe_labels(labels)
    return srv.commit_window(force=True)


def test_governor_disabled_and_no_candidate(fleet_flags):
    gov = PromotionGovernor([])
    assert gov.observe({"candidate_version": 2}) == "disabled"
    fleet_flags.set("serving_auto_promote", True)
    assert gov.observe({}) == "no-candidate"


def _two_servers(job, fleet_flags):
    job.end()                                          # v1 (stable)
    fleet_flags.set("serving_shadow", True)
    fleet_flags.set("serving_auto_promote", True)
    fleet_flags.set("serving_promote_windows", 2)
    servers = [FleetReplicaServer(job.root, device="cpu") for _ in range(2)]
    for s in servers:
        s.poll_once()
    job.pub.publish(job.store, job.tr.eval_params(), pass_id=1)   # v2
    for s in servers:
        assert s.poll_once() == 1 and s.candidate.version == 2
    gov = PromotionGovernor(
        [LocalReplica(f"r{i}", s, None) for i, s in enumerate(servers)])
    return servers, gov


def test_governor_holds_worse_candidate_fleet_wide(tmp_path, fleet_flags,
                                                   events):
    job = Job(str(tmp_path / "serve"))
    servers, gov = _two_servers(job, fleet_flags)
    lead = servers[0]
    lead._candidate.predictor = _WorsePredictor(lead._candidate.predictor)
    ids, mask, dense, _ = job.request()
    fields = _window_with_labels(lead, ids, mask, dense)
    assert gov.observe(fields) == "hold"
    assert gov.held_versions == {2} and gov.promote_holds == 1
    assert gov.observe(fields) == "held"   # a held version stays held
    for s in servers:
        assert s.active.version == 1 and s.candidate is not None
    hold = events.find("fleet_promote_hold")
    assert hold and hold[-1]["fields"]["version"] == 2
    assert hold[-1]["fields"]["rule"] == "version-regression"
    quar = events.find("fleet_version_quarantined")
    assert quar and quar[-1]["fields"]["version"] == 2
    assert not events.find("fleet_promoted")


def test_governor_promotes_after_k_clean_windows(tmp_path, fleet_flags,
                                                 events):
    job = Job(str(tmp_path / "serve"))
    servers, gov = _two_servers(job, fleet_flags)
    lead = servers[0]
    ids, mask, dense, _ = job.request()
    assert gov.observe(_window_with_labels(lead, ids, mask, dense)) \
        == "clean"
    for s in servers:                  # one clean window moves nothing
        assert s.active.version == 1
    assert gov.observe(_window_with_labels(lead, ids, mask, dense)) \
        == "promoted"
    for s in servers:
        assert s.active.version == 2 and s.candidate is None
    promoted = events.find("fleet_promoted")
    assert promoted and promoted[-1]["fields"]["version"] == 2
    assert promoted[-1]["fields"]["replicas_promoted"] == 2
    assert gov.promote_holds == 0 and not events.find("fleet_promote_hold")


# ------------------------------------------------ real replica processes


def _rh(rep) -> dict:
    try:
        return rep.health()
    except Exception:   # noqa: BLE001 — "unreachable" while waiting
        return {}


def _wait(cond, timeout_s: float, what: str):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


def test_subprocess_replicas_serve_and_are_reaped(tmp_path):
    """Two replica processes on the CPU off one root: both build v1 from
    one staged copy, score like a direct Predictor through the router,
    answer /metrics and /promote, and stopping the fleet reaps both."""
    import urllib.request
    job = Job(str(tmp_path / "serve"), base_every=1)
    job.end()                                          # v1
    fleet = ReplicaFleet(job.root, replicas=2, workdir=str(tmp_path / "fw"),
                         poll_s=0.1, supervise_tick_s=0.05, window_s=0,
                         device="cpu",
                         replica_env=lambda i: {"PYTHONPATH": REPO,
                                                "OMP_NUM_THREADS": "1"})
    router = Router(fleet.replicas, timeout_s=60.0, health_ttl_s=0.2)
    fleet.attach_router(router)
    fleet.start()
    procs = [r.proc for r in fleet.replicas]
    try:
        _wait(lambda: all(_rh(r).get("active_version") == 1
                          for r in fleet.replicas), 120, "v1 on both")
        ids, mask, dense, _ = job.request()
        want = job.live_scores()
        for _ in range(4):
            got = router.score(ids, mask, dense)
            np.testing.assert_allclose(got, want, **FWD_TOL)
        h = fleet.replicas[0].health()
        assert h["staging"]["downloads"] + fleet.replicas[1].health()[
            "staging"]["downloads"] == 1
        with urllib.request.urlopen(fleet.replicas[1]._url("/metrics"),
                                    timeout=10) as resp:
            assert resp.status == 200
        assert fleet.replicas[0].promote() is False    # no candidate
        assert router.stats()["failures"] == 0
        assert sorted(os.listdir(os.path.join(fleet.staging_root,
                                              "versions"))) == ["v-000001"]
    finally:
        fleet.stop()
    assert all(p.poll() is not None for p in procs)


@pytest.mark.slow
def test_replica_killed_mid_swap_routes_around(tmp_path, events):
    """Replica 0 (a real process) dies at serving.fleet.replica.pre_build
    when v2 arrives. The router routes around it with 0 failed requests
    under four client threads, the supervisor restarts it, and the fleet
    converges on v2 with one verified staging copy per version."""
    job = Job(str(tmp_path / "serve"), base_every=1)
    job.end()                                          # v1 (base)
    base_env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    kill_env = dict(base_env,
                    PBTPU_FAULTPOINT="serving.fleet.replica.pre_build",
                    PBTPU_FAULTPOINT_AFTER="1")   # hit 2 = the v2 build
    fleet = ReplicaFleet(
        job.root, replicas=2, workdir=str(tmp_path / "fw"),
        poll_s=0.1, backoff0_s=0.2, supervise_tick_s=0.05, window_s=0,
        device="cpu",
        replica_env=lambda i: kill_env if i == 0 else base_env)
    router = Router(fleet.replicas, timeout_s=120.0, health_ttl_s=0.5)
    fleet.attach_router(router)
    fleet.start()
    procs = []
    errors: list = []
    stop = threading.Event()
    try:
        _wait(lambda: all(_rh(r).get("active_version") == 1
                          for r in fleet.replicas), 120, "v1 on both")
        ids, mask, dense, _ = job.request()
        router.score(ids, mask, dense)

        def hammer():
            while not stop.is_set():
                try:
                    router.score(ids, mask, dense)
                except Exception as e:   # noqa: BLE001 — must stay empty
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            job.next_pass()                            # v2: replica 0 dies
            _wait(lambda: 137 in fleet.replicas[0].exits, 120,
                  "replica-0 fault-point kill")
            _wait(lambda: all(r.alive()
                              and _rh(r).get("active_version") == 2
                              and _rh(r).get("status") == "ok"
                              for r in fleet.replicas),
                  180, "fleet convergence on v2")
            router.score(ids, mask, dense)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert fleet.restarts >= 1
        assert not fleet.replicas[0].quarantined
        assert events.find("fleet_replica_restart")
        staged = sorted(os.listdir(
            os.path.join(fleet.staging_root, "versions")))
        assert staged == ["v-000001", "v-000002"]
        rs = router.stats()
        assert rs["requests"] > 0
        assert rs["failures"] == 0 and rs["sheds"] == 0
        fields = fleet.commit_window(force=True)
        assert fields["healthy"] == 2 and fields["restarts"] >= 1
        rec = events.find("fleet_window")[-1]
        assert flight.validate_fleet_record(rec) == []
        assert jflight.validate_fleet_record(rec) == []
    finally:
        stop.set()
        procs = [r.proc for r in fleet.replicas]
        fleet.stop()
    assert all(p is None or p.poll() is not None for p in procs)
