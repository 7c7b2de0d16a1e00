"""The port's publish → serve → hot-swap loop, and its formats against the
JAX package's:

- a version published by the port is served by the JAX ``ServingServer``
  and one published by the JAX package by the port's, with the same
  scores (the zoo's forward tolerance, rtol 1e-5 / atol 1e-6); every
  ``MANIFEST.json`` verifies in both packages and ``read_artifact``
  gives the same planes bit for bit (int8 cold rows included);
- the publish kill matrix: a publishing subprocess killed in each of the
  three ``serving.publish.*`` windows never announces a torn version, a
  server ends on a verified one, and the resumed publisher catches
  serving up to the final state's scores exactly;
- delta hot-swap (copy-on-write: a held v1 handle keeps its scores),
  staleness, cold-start seek with fallback past a rotted base, a
  CRC-corrupt version skipped (``degraded``) and the recovery on the next
  base, version-mismatch rejection, fetch retry with the staging copy
  removed, ``/healthz`` (port 0) and ``/metrics`` serving Prometheus text;
- hot-swap under concurrent load from 4 threads with 0 failures, every
  result one published version's scores;
- ``BatchingFrontend``: scores equal to a direct ``predict``, the
  mixed-dense split, submit during stop, the latency window aging out;
- ``ServingObs``: the split and shadow records, and its window fields
  equal to the reference's on the same scores and labels;
- ``BoxPS.end_pass(publisher=...)`` degrading to ``{"error": ...}``,
  compaction and pruning, ``publish_if_behind``, remote roots refused.

Small sizes (4 slots, dim 8, hidden 16, batch 64), device="cpu"; every
thread join and future has a timeout.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddlebox_tpu import models as jmodels
from paddlebox_tpu.data import DataFeedSchema as JaxSchema
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import HostEmbeddingStore as JaxStore
from paddlebox_tpu.serving import ServingPublisher as JaxPublisher
from paddlebox_tpu.serving import ServingServer as JaxServer
from paddlebox_tpu.serving import read_artifact as jax_read_artifact
from paddlebox_tpu.serving.obs import LatencyWindow as JaxLatencyWindow
from paddlebox_tpu.serving.obs import ServingObs as JaxServingObs
from paddlebox_tpu.utils import checkpoint as jax_ckpt

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.fleet import BoxPS, FleetUtil
from paddlebox_tpu_torch.inference import Predictor, ServingTable
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.serving import (DONEFILE, BatchingFrontend,
                                         ServingPublisher, ServingServer,
                                         ServingUnavailableError,
                                         read_artifact)
from paddlebox_tpu_torch.serving.obs import LatencyWindow, ServingObs
from paddlebox_tpu_torch.train import Trainer, TrainerConfig
from paddlebox_tpu_torch.utils import checkpoint as ckpt
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils.fs import RemoteFSNotPorted

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, DIM, DENSE, BATCH = 4, 8, 1, 64
HIDDEN = (16,)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)      # tests/test_torch_zoo.py
POINTS = ("serving.publish.pre_donefile", "serving.publish.pre_manifest",
          "serving.publish.pre_upload")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultpoint.disarm()


@pytest.fixture()
def split_flags():
    keys = ("serving_split_fraction", "serving_shadow", "serving_window_s")
    saved = {k: getattr(flags, k) for k in keys}
    yield flags
    for k, v in saved.items():
        flags.set(k, v)


def _records(schema, n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, 400, replace=False).astype(np.int64)
    vals = [rng.choice(keys, n) for _ in range(S)]
    offs = [np.arange(n + 1, dtype=np.int64) for _ in range(S)]
    floats = [(rng.random(n) < 0.3).astype(np.float32),
              rng.normal(size=n).astype(np.float32)]
    z = np.zeros(n, np.int32)
    return SlotRecordBatch(schema, n, vals, offs, floats,
                           np.arange(n, dtype=np.uint64),
                           np.zeros(n, np.uint64), z, z)


class Job:
    """One trained pass (open) + a publisher over an empty root."""

    def __init__(self, root, quant="f32", base_every=2, hot_top_k=16):
        self.schema = DataFeedSchema.ctr(num_sparse=S, num_float=DENSE,
                                         batch_size=BATCH)
        self.store = HostEmbeddingStore(EmbeddingConfig(
            dim=DIM, learning_rate=0.15))
        self.model = DeepFMModel(S, DIM, DENSE, hidden=HIDDEN)
        self.tr = Trainer(self.model, self.store, self.schema,
                          TrainerConfig(global_batch_size=BATCH,
                                        dense_lr=3e-3),
                          device="cpu")
        self.ds = SlotDataset(self.schema)
        self.ds.records = _records(self.schema, 4 * BATCH, 0)
        self.box = BoxPS(self.store)
        self.root = root
        self.pub = ServingPublisher(root, self.model, self.schema,
                                    publish_base_every=base_every,
                                    quant=quant, hot_top_k=hot_top_k)
        self.box.begin_pass()
        self.tr.train_pass(self.ds)

    def end(self, pub=None):
        return self.box.end_pass(trainer=self.tr,
                                 publisher=pub or self.pub)["publish"]

    def next_pass(self, pub=None):
        self.box.begin_pass()
        self.tr.train_pass(self.ds)
        return self.end(pub)

    def request(self):
        pb = next(iter(self.ds.batches(BATCH)))
        labels, dense = self.tr.split_floats(pb.floats)
        return pb.ids.astype(np.uint64), pb.mask, dense, labels

    def live_scores(self):
        ids, mask, dense, _ = self.request()
        return Predictor(self.model, self.tr.eval_params(),
                         ServingTable.from_store(self.store), self.schema,
                         device="cpu").predict(ids, mask, dense)


@pytest.fixture()
def job(tmp_path):
    return Job(str(tmp_path / "serve"))


def _server(root, **kw):
    return ServingServer(root, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the loop, port only
# ---------------------------------------------------------------------------

def test_publish_serve_scores_match_predictor(job):
    info = job.end()
    assert info["kind"] == "base" and info["announced"]
    assert info["version"] == 1 and info["bytes"] > 0
    srv = _server(job.root)
    assert srv.poll_once() == 1
    ids, mask, dense, _ = job.request()
    np.testing.assert_array_equal(srv.predict(ids, mask, dense),
                                  job.live_scores())
    h = srv.health()
    assert h["status"] == "ok" and h["active_version"] == 1
    assert h["device"] == "cpu" and h["served"] == BATCH
    assert srv.active.predictor.device.type == "cpu"


def test_delta_publish_and_hot_swap(job):
    job.end()
    srv = _server(job.root)
    srv.poll_once()
    v1 = srv.active
    ids, mask, dense, _ = job.request()
    p1 = v1.predictor.predict(ids, mask, dense)
    info = job.next_pass()
    assert info["kind"] == "delta"
    assert srv.poll_once() == 1
    assert srv.active.version == 2 and srv.active.kind == "delta"
    want = job.live_scores()
    np.testing.assert_array_equal(srv.predict(ids, mask, dense), want)
    # the held v1 handle still serves its own table and module
    assert v1.predictor.model is not srv.active.predictor.model
    np.testing.assert_array_equal(v1.predictor.predict(ids, mask, dense),
                                  p1)
    assert not np.allclose(p1, want)
    assert srv.health()["last_swap_pause_ms"] < 100.0


def test_quantized_publish_bounded_error(tmp_path, job):
    pub8 = ServingPublisher(str(tmp_path / "serve8"), job.model,
                            job.schema, publish_base_every=4, quant="int8",
                            hot_top_k=8)
    info = job.end(pub8)
    assert info["kind"] == "base"
    srv = _server(str(tmp_path / "serve8"))
    srv.poll_once()
    ids, mask, dense, _ = job.request()
    want = job.live_scores()
    got = srv.predict(ids, mask, dense)
    np.testing.assert_allclose(got, want, atol=0.02)
    assert not np.array_equal(got, want)    # quantization really applied
    m = srv.active
    assert len(m.hot_keys) == 8 and m.hot_live == 8
    assert srv.health()["hot_cached_keys"] == 8
    rows = job.store.get_rows(m.hot_keys)[:, :m.table.pull_width]
    pos, hit = m.table._probe(m.hot_keys)
    np.testing.assert_array_equal(rows[hit], m.table.vals[pos[hit]])


def test_server_empty_root_unavailable(tmp_path):
    srv = _server(str(tmp_path / "nothing"))
    assert srv.poll_once() == 0
    assert srv.health()["status"] == "empty"
    with pytest.raises(ServingUnavailableError):
        srv.predict(np.zeros((1, S), np.uint64), np.ones((1, S), bool))


def test_staleness_reported_when_publishes_stop(job):
    job.end()
    # the donefile's ts has 1-second resolution
    srv = _server(job.root, stale_after_s=1.5, stale_pass_lag=99)
    srv.poll_once()
    assert srv.health()["status"] == "ok"
    time.sleep(2.0)
    h = srv.health()
    assert h["status"] == "stale" and h["age_seconds"] >= 1.5
    job.next_pass()
    srv.poll_once()
    assert srv.health()["status"] == "ok"
    # pass lag: announced passes the server has not loaded
    srv2 = _server(job.root, stale_pass_lag=0)
    srv2.poll_once()
    srv2._active.pass_id -= 1
    assert srv2.health()["pass_lag"] == 1
    assert srv2.health()["status"] == "stale"


def test_cold_start_seeks_newest_base(job):
    job.end()                                          # v1 base
    base3 = None
    for _ in range(3):                                 # v2 delta, v3 base,
        info = job.next_pass()                         # v4 delta
        if info["version"] == 3:
            assert info["kind"] == "base"
            base3 = info["path"]
    srv = _server(job.root)
    assert srv.poll_once() == 2                        # v3 + v4 only
    assert srv.active.version == 4 and srv.health()["swaps"] == 2
    ids, mask, dense, _ = job.request()
    np.testing.assert_array_equal(srv.predict(ids, mask, dense),
                                  job.live_scores())
    # rot the newest base: a fresh server falls back to v1 + v2
    with open(os.path.join(base3, "sparse.npz"), "r+b") as f:
        f.seek(16)
        f.write(b"\xde\xad\xbe\xef")
    srv2 = _server(job.root)
    with pytest.warns(UserWarning, match="crc32"):
        applied = srv2.poll_once()
    assert applied == 2 and srv2.active.version == 2
    assert srv2.health()["status"] == "degraded"


def test_corrupt_version_skipped_then_recovered(tmp_path, job):
    """An announced version rotted after its publish verified: skipped
    with its CRC diagnosis while the last good version serves
    (degraded); its child delta waits; the next base recovers."""
    root = str(tmp_path / "serve3")
    pub = ServingPublisher(root, job.model, job.schema,
                           publish_base_every=3, quant="int8")
    job.end(pub)                                       # v1 base
    srv = _server(root)
    srv.poll_once()
    ids, mask, dense, _ = job.request()
    v1_scores = srv.predict(ids, mask, dense)
    info = job.next_pass(pub)                          # v2 delta
    with open(os.path.join(info["path"], "sparse.npz"), "r+b") as f:
        f.seek(40)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.warns(UserWarning, match="crc32"):
        assert srv.poll_once() == 0
    h = srv.health()
    assert h["status"] == "degraded" and h["active_version"] == 1
    assert h["skipped_versions"] == [2] and "crc32" in h["last_error"]
    np.testing.assert_array_equal(srv.predict(ids, mask, dense),
                                  v1_scores)
    job.next_pass(pub)                                 # v3 delta of v2
    with pytest.warns(UserWarning, match="waiting for the next base"):
        assert srv.poll_once() == 0
    assert srv.active.version == 1
    job.next_pass(pub)                                 # v4 base
    assert srv.poll_once() == 1
    h = srv.health()
    assert h["active_version"] == 4 and h["status"] == "ok"
    assert h["request_failures"] == 0


def test_build_rejects_version_mismatch(job):
    info = job.end()
    with open(os.path.join(job.root, DONEFILE), "a") as f:
        f.write(json.dumps({"version": 2, "pass": 2, "kind": "base",
                            "parent": None, "path": info["path"],
                            "ts": int(time.time())}) + "\n")
    srv = _server(job.root)
    with pytest.warns(UserWarning, match="claims"):
        srv.poll_once()
    assert srv.active.version == 1
    assert 2 in srv.health()["skipped_versions"]


@pytest.mark.parametrize("kind", ["base", "delta"])
def test_missing_artifact_directory_is_skipped(job, kind):
    """An announced version whose directory is not there is skipped with
    its diagnosis; a server that already serves keeps the last good
    version (degraded) and one that does not stays empty."""
    info = job.end()
    srv = _server(job.root)
    if kind == "delta":
        assert srv.poll_once() == 1
    missing = info["path"] + "-gone"
    FleetUtil(job.root).append_donefile(DONEFILE, {
        "version": 2, "pass": 2, "kind": kind,
        "parent": 1 if kind == "delta" else None, "path": missing,
        "ts": int(time.time())})
    if kind == "base":
        shutil.rmtree(info["path"])       # the v1 base is gone as well
    with pytest.warns(UserWarning, match="is missing"):
        assert srv.poll_once() == 0
    h = srv.health()
    assert 2 in h["skipped_versions"]
    if kind == "delta":
        assert h["status"] == "degraded" and h["active_version"] == 1
    else:
        assert h["status"] == "empty" and srv.active is None


def test_health_endpoint_http(job):
    job.end()
    srv = _server(job.root, health_port=0)
    try:
        base = f"http://127.0.0.1:{srv.health_port}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        srv.poll_once()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["active_version"] == 1
        assert h["versions"]["1"]["role"] == "stable"
        # /metrics serves the telemetry hub's Prometheus text, with the
        # swap that just happened counted and the active version gauged
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        lines = text.splitlines()
        assert "# TYPE pbtpu_serving_swaps counter" in lines
        assert "# TYPE pbtpu_serving_active_version gauge" in lines
        assert "pbtpu_serving_active_version 1" in lines
        assert "# TYPE pbtpu_serving_publish_failures counter" in lines
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _jax_side(root, quant):
    """A JAX publisher over a JAX store holding the port job's rows and
    the port model's params (publishing needs no trainer)."""
    jschema = JaxSchema.ctr(num_sparse=S, num_float=DENSE,
                            batch_size=BATCH)
    jstore = JaxStore(JaxCfg(dim=DIM, learning_rate=0.15))
    jm = jmodels.DeepFMModel(S, DIM, DENSE, hidden=HIDDEN)
    jpub = JaxPublisher(root, jm, jschema, publish_base_every=2,
                        quant=quant, hot_top_k=16)
    return jstore, jpub


def _copy_rows(job, jstore):
    job.tr.flush_sparse()
    keys = job.store.keys()
    jstore.lookup_or_init(keys)
    jstore.write_back(keys, job.store.get_rows(keys))


@pytest.mark.parametrize("quant", ["f32", "int8"])
@pytest.mark.parametrize("way", ["port->jax", "jax->port"])
def test_published_versions_served_across_packages(tmp_path, job, way,
                                                   quant):
    root = str(tmp_path / "x")
    jstore, jpub = _jax_side(root, quant)
    pub = ServingPublisher(root, job.model, job.schema, quant=quant,
                           publish_base_every=2, hot_top_k=16)
    for p in range(2):                               # a base, a delta
        if p:
            job.box.begin_pass()
            job.tr.train_pass(job.ds)
        if way == "port->jax":
            info = job.end(pub)
        else:
            job.box.end_pass()
            _copy_rows(job, jstore)
            info = jpub.publish(jstore, job.tr.eval_params(), pass_id=p + 1)
        assert info["kind"] == ("base", "delta")[p]
        # every manifest verifies in both packages; the planes read the
        # same in both, bit for bit
        ckpt.verify_manifest(info["path"])
        jax_ckpt.verify_manifest(info["path"])
        a, b = read_artifact(info["path"]), jax_read_artifact(info["path"])
        assert a["meta"] == b["meta"] and a["model_meta"] == b["model_meta"]
        for k in ("keys", "vals", "hot", "rows", "removed"):
            if k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    srv, jsrv = _server(root), JaxServer(root)
    assert srv.poll_once() == jsrv.poll_once() == 2
    assert srv.active.version == jsrv.active.version == 2
    assert srv.active.kind == "delta"
    np.testing.assert_array_equal(srv.active.table.vals,
                                  jsrv.active.table.vals)
    ids, mask, dense, _ = job.request()
    got = srv.predict(ids, mask, dense)
    np.testing.assert_allclose(got, np.asarray(jsrv.predict(ids, mask,
                                                            dense)),
                               **FWD_TOL)
    if quant == "f32":
        np.testing.assert_allclose(got, job.live_scores(), **FWD_TOL)


# ---------------------------------------------------------------------------
# the publish kill matrix (subprocesses)
# ---------------------------------------------------------------------------

_WORKER = """
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.data import DataFeedSchema
from paddlebox_tpu_torch.embedding import EmbeddingConfig, HostEmbeddingStore
from paddlebox_tpu_torch.inference import Predictor, ServingTable
from paddlebox_tpu_torch.models import DeepFMModel
from paddlebox_tpu_torch.serving import ServingPublisher

root, out, passes = sys.argv[1], sys.argv[2], int(sys.argv[3])
schema = DataFeedSchema.ctr(num_sparse=4, num_float=1, batch_size=16)
store = HostEmbeddingStore(EmbeddingConfig(dim=8))
model = DeepFMModel(4, 8, 1, hidden=(16,))
model.init(torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
keys = rng.choice(1 << 40, 300, replace=False).astype(np.uint64)
pub = ServingPublisher(root, model, schema, publish_base_every=2,
                       quant="f32", hot_top_k=8)
state = None
for p in range(1, passes + 1):
    rows = store.lookup_or_init(keys)
    rows[:, 0] += p
    rows[:, 3:] += 0.01 * p
    store.write_back(keys, rows)
    with torch.no_grad():
        model.bias += 0.1
    state = weights.model_params(model)
    if pub.publish_if_behind(store, state, p) is None:
        pass                      # caught up already (a resumed run)
ids = rng.choice(keys, (16, 4)).astype(np.uint64)
mask = np.ones((16, 4), bool)
dense = rng.normal(size=(16, 1)).astype(np.float32)
probs = Predictor(model, state, ServingTable.from_store(store), schema,
                  device="cpu").predict(ids, mask, dense)
np.savez(out, probs=probs, ids=ids, mask=mask, dense=dense)
"""


def _run_worker(root, out, passes, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PBTPU_FAULTPOINT")}
    env.update(PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", _WORKER, root, out,
                           str(passes)], env=env, capture_output=True,
                          text=True, timeout=120)


def _announced_all_verify(root):
    entries = FleetUtil(root).entries(DONEFILE)
    for e in entries:
        read_artifact(e["path"], verify=True)
    return entries


@pytest.mark.parametrize("point", POINTS)
def test_publish_kill_matrix_never_announces_torn(tmp_path, point):
    """The worker is killed in ``point`` during its second publish (the
    first, a base, landed): only v1 is announced and every announced
    version verifies; a tailing server serves v1. The re-run (the
    training side's resume) re-publishes the lost pass through
    publish_if_behind and the server catches up to the final state's
    scores exactly."""
    root, out = str(tmp_path / "serve"), str(tmp_path / "out.npz")
    killed = _run_worker(root, out, 2, {"PBTPU_FAULTPOINT": point,
                                        "PBTPU_FAULTPOINT_AFTER": "1"})
    assert killed.returncode == 137, (killed.stdout, killed.stderr)
    assert f"FAULTPOINT KILL {point}" in killed.stderr
    entries = _announced_all_verify(root)
    assert [e["version"] for e in entries] == [1]
    srv = _server(root)
    assert srv.poll_once() == 1 and srv.active.version == 1
    done = _run_worker(root, out, 2)
    assert done.returncode == 0, done.stderr
    entries = _announced_all_verify(root)
    assert [(e["version"], e["pass"]) for e in entries] == [(1, 1), (2, 2)]
    # the restarted publisher has no retained plane: its catch-up is a
    # base, which the server swaps in
    assert entries[-1]["kind"] == "base"
    assert srv.poll_once() == 1 and srv.active.pass_id == 2
    with np.load(out) as z:
        np.testing.assert_array_equal(
            srv.predict(z["ids"], z["mask"], z["dense"]), z["probs"])


def test_end_pass_publish_failure_degrades(job):
    """A publish failing in a window (ioerror) warns and returns
    {"error": ...}; the donefile is unchanged, the server stays on its
    version, and the next publish lands cleanly."""
    job.end()
    srv = _server(job.root)
    srv.poll_once()
    faultpoint.arm("serving.publish.pre_donefile", action="ioerror")
    job.box.begin_pass()
    job.tr.train_pass(job.ds)
    with pytest.warns(UserWarning, match="publish failed"):
        info = job.end()
    assert "error" in info and "pre_donefile" in info["error"]
    faultpoint.disarm()
    assert srv.poll_once() == 0 and srv.active.version == 1
    _announced_all_verify(job.root)
    # the failed publish left the version sequence and the retained
    # plane where they were: the next one is v2 again, a delta of v1
    info = job.next_pass()
    assert info["announced"] and info["version"] == 2
    assert info["kind"] == "delta"
    assert srv.poll_once() == 1
    ids, mask, dense, _ = job.request()
    np.testing.assert_array_equal(srv.predict(ids, mask, dense),
                                  job.live_scores())
    with pytest.raises(ValueError, match="needs trainer"):
        job.box.begin_pass()
        job.box.end_pass(publisher=job.pub)


def test_publish_windows_in_closed_registry():
    for p in POINTS:
        assert p in faultpoint.POINTS
    with pytest.raises(RemoteFSNotPorted):
        ServingPublisher("hdfs://nn/serve", None, None)
    with pytest.raises(RemoteFSNotPorted):
        ServingServer("afs://x/serve", device="cpu")


def test_donefile_compaction_keeps_serving_loadable(job):
    job.end()
    for _ in range(5):                 # v1..v6: bases at 1, 3, 5
        job.next_pass()
    dropped = job.pub.compact_donefile(keep_bases=2)
    entries = FleetUtil(job.root).entries(DONEFILE)
    assert dropped == 2 and [e["version"] for e in entries] == [3, 4, 5, 6]
    assert sorted(os.listdir(job.root)) == [
        DONEFILE, "v-000003", "v-000004", "v-000005", "v-000006"]
    srv = _server(job.root)
    assert srv.poll_once() == 2 and srv.active.version == 6
    ids, mask, dense, _ = job.request()
    np.testing.assert_array_equal(srv.predict(ids, mask, dense),
                                  job.live_scores())
    # the auto threshold: a base publish past compact_after compacts
    job.pub.compact_after = 3
    job.next_pass()                    # v7 base → compaction
    assert [e["version"] for e in
            FleetUtil(job.root).entries(DONEFILE)] == [5, 6, 7]


def test_publish_if_behind(job):
    info = job.end()
    assert job.pub.publish_if_behind(job.store, job.tr.eval_params(),
                                     1) is None
    pub2 = ServingPublisher(job.root, job.model, job.schema)
    assert pub2.latest_announced()["version"] == info["version"]
    got = pub2.publish_if_behind(job.store, job.tr.eval_params(), 2)
    assert got["version"] == 2 and got["kind"] == "base"


# ---------------------------------------------------------------------------
# concurrency: hot-swap under load, the frontend
# ---------------------------------------------------------------------------

def test_hot_swap_under_concurrent_load(job):
    """4 threads hammer the server while three new versions publish and
    the background tailer swaps them in: 0 failures, every result one
    published version's scores, the run ends on the last version."""
    job.end()
    srv = _server(job.root, poll_s=0.01).start()
    try:
        deadline = time.time() + 10
        while srv.active is None and time.time() < deadline:
            time.sleep(0.01)
        assert srv.active is not None
        ids, mask, dense, _ = job.request()
        stop = threading.Event()
        errors, results = [], []
        lock = threading.Lock()

        def hammer():
            while not stop.is_set():
                try:
                    p = srv.predict(ids, mask, dense)
                    with lock:
                        results.append(p)
                except Exception as e:   # noqa: BLE001 — the assertion
                    with lock:
                        errors.append(e)
                # yield the core now and then: the test's other workers
                # share the host
                time.sleep(0.001)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        versions = [job.live_scores()]
        try:
            for _ in range(3):
                job.next_pass()
                versions.append(job.live_scores())
                deadline = time.time() + 10
                while (srv.active.version < len(versions)
                       and time.time() < deadline):
                    time.sleep(0.01)
                time.sleep(0.05)         # traffic on the new version
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    assert not errors, errors[:3]
    assert srv.active.version == 4 and srv.health()["swaps"] == 4
    assert srv.health()["request_failures"] == 0
    assert len(results) > 20
    for p in results[::max(1, len(results) // 64)]:
        assert any(np.array_equal(p, v) for v in versions), \
            "served scores match no published version"


def test_frontend_scores_equal_direct_predict(job):
    job.end()
    srv = _server(job.root)
    srv.poll_once()
    ids, mask, dense, _ = job.request()
    fe = BatchingFrontend(srv, max_batch=16, max_wait_s=0.01).start()
    try:
        futs = [fe.submit(ids[i], mask[i], dense[i]) for i in range(48)]
        got = np.asarray([f.result(timeout=60) for f in futs])
    finally:
        fe.stop()
    # a batch of up to 16 rows may round differently than one of 64
    np.testing.assert_allclose(got, srv.predict(ids, mask, dense)[:48],
                               rtol=1e-6, atol=1e-7)
    st = fe.stats()
    assert st["count"] == 48 and st["failures"] == 0
    assert st["batches"] >= 3 and st["p99_ms"] >= st["p50_ms"] > 0
    assert fe.inflight == 0


def test_frontend_splits_mixed_dense_batch(job):
    """Requests with dense features score WITH them even when coalesced
    behind one without."""
    job.end()
    srv = _server(job.root)
    srv.poll_once()
    ids, mask, dense, _ = job.request()
    fe = BatchingFrontend(srv, max_batch=32, max_wait_s=0.05).start()
    try:
        f_nd = fe.submit(ids[0], mask[0])
        futs = [fe.submit(ids[i], mask[i], dense[i]) for i in range(1, 5)]
        got = np.asarray([f.result(timeout=60) for f in futs])
        # the dense-less group fails on its own (the model needs dense)
        with pytest.raises(RuntimeError):
            f_nd.result(timeout=60)
    finally:
        fe.stop()
    np.testing.assert_allclose(got, srv.predict(ids[1:5], mask[1:5],
                                                dense[1:5]),
                               rtol=1e-6, atol=1e-7)
    assert fe.stats()["failures"] == 1


class _ShapeServer:
    """Records the batch sizes the frontend scores."""

    def __init__(self):
        self.rows = []

    def predict(self, ids, mask, dense=None):
        self.rows.append(len(ids))
        return np.full(len(ids), 0.5, np.float32)


def test_frontend_scores_a_batch_at_its_own_size():
    """No pad rows: a lone request is scored as a one-row batch."""
    srv = _ShapeServer()
    fe = BatchingFrontend(srv, max_batch=64, max_wait_s=0.001).start()
    try:
        f = fe.submit(np.zeros(S, np.uint64), np.ones(S, bool))
        assert f.result(timeout=60) == np.float32(0.5)
    finally:
        fe.stop()
    assert srv.rows == [1]


def test_frontend_submit_during_stop_never_leaves_pending_future():
    fe = BatchingFrontend(server=None, max_batch=4)
    # submit passed the liveness check, then stop() set _stopping and
    # drained the queue before the put landed
    fe._thread = threading.Thread(target=lambda: None)
    fe._stopping = True
    f = fe.submit(np.zeros(4, np.uint64), np.zeros(4, bool))
    with pytest.raises(RuntimeError, match="stopped before dispatch"):
        f.result(timeout=1)
    # and a real stop fails whatever is still queued
    fe2 = BatchingFrontend(server=None, max_batch=4)
    fe2._thread = threading.Thread(target=lambda: None)
    f2 = fe2.submit(np.zeros(4, np.uint64), np.zeros(4, bool))
    fe2._thread = threading.Thread(target=lambda: None)
    fe2._thread.start()
    fe2.stop()
    with pytest.raises(RuntimeError, match="stopped before dispatch"):
        f2.result(timeout=1)
    with pytest.raises(RuntimeError, match="not started"):
        fe2.submit(np.zeros(4, np.uint64), np.zeros(4, bool))


def test_frontend_latency_window_ages_out(job):
    job.end()
    srv = _server(job.root)
    srv.poll_once()
    ids, mask, dense, _ = job.request()
    fe = BatchingFrontend(srv, max_batch=8, max_wait_s=0.01,
                          window_s=1.0).start()
    try:
        futs = [fe.submit(ids[i], mask[i], dense[i]) for i in range(8)]
        for f in futs:
            f.result(timeout=60)
        st = fe.stats()
        assert st["count"] == 8 and st["window_count"] == 8
        time.sleep(1.2)                  # the window empties
        assert fe.stats() == {"count": 0, "failures": 0}
    finally:
        fe.stop()


def test_latency_window_matches_reference():
    w, jw = LatencyWindow(10.0, cap=50), JaxLatencyWindow(10.0, cap=50)
    rng = np.random.default_rng(1)
    for i, ms in enumerate(rng.exponential(3.0, 80)):
        w.add(float(ms), now=100.0 + 0.1 * i)
        jw.add(float(ms), now=100.0 + 0.1 * i)
    for now in (108.0, 109.5, 130.0):
        assert w.snapshot(now) == jw.snapshot(now)
    assert w.snapshot(130.0) == {"count": 0}


# ---------------------------------------------------------------------------
# version split and shadow
# ---------------------------------------------------------------------------

class _WorsePredictor:
    """An injected worse candidate: anti-correlated scores."""

    def __init__(self, inner):
        self._inner = inner

    def predict(self, ids, mask, dense=None):
        return 1.0 - self._inner.predict(ids, mask, dense)


def test_shadow_records_two_versions(job, split_flags):
    job.end()
    split_flags.set("serving_shadow", True)
    srv = _server(job.root)
    srv.poll_once()
    # v2 publishes the same params: an identical candidate
    job.pub.publish(job.store, job.tr.eval_params(), pass_id=1)
    assert srv.poll_once() == 1
    assert srv.active.version == 1 and srv.candidate.version == 2
    ids, mask, dense, _ = job.request()
    served = srv.predict(ids, mask, dense)
    labels = (served > np.median(served)).astype(np.float64)
    assert set(srv.observe_labels(labels)) == {1, 2}
    f = srv.commit_window(force=True)
    v = f["versions"]
    assert v["1"]["role"] == "stable" and v["2"]["role"] == "candidate"
    assert v["2"]["auc"] == pytest.approx(v["1"]["auc"])
    assert v["2"]["score_kl"] == pytest.approx(0.0, abs=1e-9)
    assert f["requests"] == BATCH          # the shadow copy is not served
    assert f["active_version"] == 1 and f["candidate_version"] == 2
    srv._candidate.predictor = _WorsePredictor(srv._candidate.predictor)
    served = srv.predict(ids, mask, dense)
    srv.observe_labels((served > np.median(served)).astype(np.float64))
    v = srv.commit_window(force=True)["versions"]
    assert v["1"]["auc"] - v["2"]["auc"] > 0.2
    assert v["2"]["score_kl"] > 0.1


def test_live_split_routes_and_promotes(job, split_flags):
    job.end()
    split_flags.set("serving_split_fraction", 0.5)
    srv = _server(job.root)
    srv.poll_once()
    job.pub.publish(job.store, job.tr.eval_params(), pass_id=1)
    assert srv.poll_once() == 1
    ids, mask, dense, _ = job.request()
    for _ in range(4):
        srv.predict(ids, mask, dense)
    h = srv.health()
    assert h["active_version"] == 1 and h["candidate_version"] == 2
    assert h["versions"]["2"]["role"] == "candidate"
    f = srv.commit_window(force=True)
    # the accumulator routes exactly every other batch
    assert f["versions"]["1"]["requests"] == 2 * BATCH
    assert f["versions"]["2"]["requests"] == 2 * BATCH
    assert f["requests"] == 4 * BATCH
    split_flags.set("serving_split_fraction", 0.0)
    assert srv.poll_once() == 0
    assert srv.active.version == 2 and srv.candidate is None
    assert srv.health()["versions"]["2"]["role"] == "stable"


def test_serving_obs_matches_reference():
    obs, jobs = ServingObs(window_s=5.0, slo_ms=20.0), \
        JaxServingObs(window_s=5.0, slo_ms=20.0)
    rng = np.random.default_rng(3)
    for o in (obs, jobs):
        o.window_start = 1000.0
    for i in range(6):
        s = rng.random(32)
        for o in (obs, jobs):
            o.record(1, "stable", s, 2.0 + i, True, now=1000.0 + i * 0.5)
            o.record(2, "candidate", np.clip(s + 0.1, 0, 1), 3.0 + i,
                     False, now=1000.0 + i * 0.5)
        lab = (rng.random(32) < s).astype(np.float64)
        assert obs.observe_labels(lab) == jobs.observe_labels(lab)
    assert obs.due(1006.0) and not obs.due(1004.0)
    got, want = obs.commit(1004.0), jobs.commit(1004.0)
    assert got.keys() == want.keys()
    for k in got:
        if k != "versions":
            assert got[k] == want[k], k
    for vid, ent in want["versions"].items():
        assert got["versions"][vid].keys() == ent.keys()
        for k, x in ent.items():
            assert got["versions"][vid][k] == pytest.approx(x, rel=1e-6), k
