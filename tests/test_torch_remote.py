"""Remote roots in the port's persistence and serving paths, on the CPU,
against the JAX package's (tests/test_fs.py, test_crash_safety.py and
test_serving.py cover the reference's):

- a ``PassCheckpointer`` on a ``mock://`` root: the local commit, then
  the mirror (the whole chain after a rotation, only the delta member
  after a delta save) and a ``snapshots.donefile`` line after the
  upload; a resume into an empty staging dir bit-equal to the writer's
  live state, across packages both ways; a failed directory upload
  (``MOCKFS_FAIL_PUT_DIR``) never leaves a donefile line; a torn remote
  snapshot is fallen back past; retention prunes the remote root and
  compacts the donefile; an interrupted compaction is repaired; an
  elected rollback masks the abandoned entries; the fault points and
  counters;
- a ``ServingPublisher`` on a remote root (stage, upload, verify, then
  the donefile line) served by a ``ServingServer`` that stages its
  fetches, across packages both ways, with the fetch retry bounded.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from paddlebox_tpu.serving import ServingServer as JaxServer
from paddlebox_tpu.utils import faultpoint as jfaultpoint
from paddlebox_tpu.utils import fs as jax_fs
from paddlebox_tpu.utils.pass_ckpt import PassCheckpointer as JaxCkpt

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.serving import ServingPublisher, ServingServer
from paddlebox_tpu_torch.serving.artifact import version_name
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import fs as fs_lib
from paddlebox_tpu_torch.utils.pass_ckpt import (REMOTE_DONEFILE,
                                                 PassCheckpointer)

from tests.mockfs import register_mockfs
from tests.test_torch_fs import register_port_mockfs
from tests.test_torch_resume import (LOSS_TOL, STEPS, TABLE_TOL, _make,
                                     _state, _train)
from tests.test_torch_serving import FWD_TOL, Job, _copy_rows, _jax_side

torch.set_num_threads(1)

ROOT = "mock://ckpt"


@pytest.fixture()
def mockfs(tmp_path):
    """mock:// in both packages' registries over one sandbox."""
    sandbox = tmp_path / "sandbox"
    fs = register_port_mockfs(str(sandbox))
    register_mockfs(str(sandbox))
    yield fs, sandbox
    fs_lib._REGISTRY.pop("mock", None)
    jax_fs._REGISTRY.pop("mock", None)
    faultpoint.disarm()
    jfaultpoint.disarm()


def _ckpt(pkg, stage, keep=3, root=ROOT):
    cls = PassCheckpointer if pkg == "port" else JaxCkpt
    return cls(root, keep_last_n=keep, base_every=2, staging_dir=str(stage))


def _donefile(sandbox, name="ckpt"):
    p = sandbox / name / REMOTE_DONEFILE
    return ([json.loads(ln) for ln in p.read_text().splitlines() if ln]
            if p.exists() else [])


def _assert_same_state(got, want):
    gk, wk = np.argsort(got["store"][0]), np.argsort(want["store"][0])
    np.testing.assert_array_equal(got["store"][0][gk], want["store"][0][wk])
    np.testing.assert_array_equal(got["store"][1][gk], want["store"][1][wk])
    assert sorted(got["dense"]) == sorted(want["dense"])
    for k, v in want["dense"].items():
        assert got["dense"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["dense"][k], v, err_msg=k)
    for k, v in want["metrics"].items():
        np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)
    assert got["global_step"] == want["global_step"]


def _write(pkg, stage, passes=2, keep=3):
    """A writer job: ``passes`` checkpointed passes to the remote root;
    returns its checkpointer, job and live state after each pass."""
    store, tr, box = _make(pkg)
    ck = _ckpt(pkg, stage, keep)
    states = {}
    for p in range(1, passes + 1):
        _train(pkg, store, tr, box, ck, p)
        states[p] = _state(pkg, store, tr, box)
    return ck, (store, tr, box), states


def test_mirror_layout_donefile_and_counters(mockfs, tmp_path):
    fs, sandbox = mockfs
    before = {k: monitor.STATS.get(k) for k in
              ("ckpt.remote_uploads", "ckpt.remote_upload_seconds")}
    ck, _, _ = _write("port", tmp_path / "stage", passes=3)
    assert sorted(os.listdir(sandbox / "ckpt")) == [
        "chain-0001", "chain-0002", "pass-00001", "pass-00002",
        "pass-00003", REMOTE_DONEFILE]
    # the staging root is the local commit, the same layout
    assert sorted(os.listdir(sandbox / "ckpt" / "chain-0001")) == sorted(
        os.listdir(tmp_path / "stage" / "chain-0001"))
    lines = _donefile(sandbox)
    assert [(e["pass"], e["mid"], e["snapshot"], e["chain"], e["save_seq"])
            for e in lines] == [(1, 0, "pass-00001", "chain-0001", 0),
                                (2, 0, "pass-00002", "chain-0001", 1),
                                (3, 0, "pass-00003", "chain-0002", 0)]
    assert monitor.STATS.get("ckpt.remote_uploads") == \
        before["ckpt.remote_uploads"] + 3
    assert monitor.STATS.get("ckpt.remote_upload_seconds") > \
        before["ckpt.remote_upload_seconds"]
    up = ck.last_save["remote_upload"]
    assert up["seconds"] > 0 and up["bytes"] > 0


def test_delta_save_uploads_only_its_increment(mockfs, tmp_path,
                                               monkeypatch):
    """After a rotation uploads the whole chain, a delta save puts only
    its delta member, the chain's meta and manifest, and the snapshot."""
    fs, sandbox = mockfs
    puts = []
    inner = fs.put
    monkeypatch.setattr(fs, "put", lambda l, r: (puts.append(r),
                                                 inner(l, r))[1])
    store, tr, box = _make("port")
    ck = _ckpt("port", tmp_path / "stage")
    _train("port", store, tr, box, ck, 1)
    assert f"{ROOT}/chain-0001" in puts
    puts.clear()
    _train("port", store, tr, box, ck, 2)
    chain_puts = sorted(p for p in puts if "chain-0001" in p)
    assert chain_puts == [f"{ROOT}/chain-0001/MANIFEST.json",
                          f"{ROOT}/chain-0001/delta-00001.npz",
                          f"{ROOT}/chain-0001/meta.json"]
    assert f"{ROOT}/pass-00002" in puts
    assert ck.last_save["remote_upload"]["bytes"] < sum(
        f.stat().st_size for f in (sandbox / "ckpt").rglob("*")
        if f.is_file())


@pytest.mark.parametrize("writer,resumer", [("port", "port"),
                                            ("jax", "port"),
                                            ("port", "jax")])
def test_resume_from_empty_staging_bit_equal(mockfs, tmp_path, writer,
                                             resumer):
    """A fresh job with an empty staging dir resumes the remote root:
    every plane bit-equal to the writer's live state after pass 2; the
    port's pass 3 from there agrees with the writer's."""
    _, job, states = _write(writer, tmp_path / "w_stage")
    store, tr, box = _make(resumer, seed=11)
    ck = _ckpt(resumer, tmp_path / "r_stage")
    before = monitor.STATS.get("ckpt.remote_downloads")
    cursor = tr.resume(ck, box=box)
    assert cursor["pass_id"] == 2 and cursor["global_step"] == 2 * STEPS
    _assert_same_state(_state(resumer, store, tr, box), states[2])
    if resumer == "port":
        assert monitor.STATS.get("ckpt.remote_downloads") == before + 2
        dl = ck.last_resume["remote_download"]
        assert dl["snapshots"] == ["pass-00002", "pass-00001"]
        assert dl["bytes"] > 0 and dl["seconds"] > 0
        out = _train(resumer, store, tr, box, ck, 3)
        wstore, wtr, wbox = job
        want = _train(writer, wstore, wtr, wbox, _ckpt(
            writer, tmp_path / "w_stage", root="mock://other"), 3)
        np.testing.assert_allclose(out["loss_mean"], want["loss_mean"],
                                   **LOSS_TOL)
        got = _state(resumer, store, tr, box)["store"]
        ref = _state(writer, wstore, wtr, wbox)["store"]
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], **TABLE_TOL)


def test_failed_upload_never_writes_a_donefile_line(mockfs, tmp_path,
                                                    monkeypatch):
    """With directory uploads failing past the retries, the save raises
    after its local commit and the donefile names no un-uploaded
    snapshot; the next save re-uploads the whole chain."""
    fs, sandbox = mockfs
    store, tr, box = _make("port")
    ck = _ckpt("port", tmp_path / "stage")
    _train("port", store, tr, box, ck, 1)
    monkeypatch.setitem(fs._env, "MOCKFS_FAIL_PUT_DIR", "1")
    monkeypatch.setattr(fs, "_retries", 2)
    monkeypatch.setattr(fs, "_retry_backoff", 0.01)
    with pytest.raises(RuntimeError, match="put failed after 2 attempts"):
        _train("port", store, tr, box, ck, 2)
    assert [e["pass"] for e in _donefile(sandbox)] == [1]
    assert (tmp_path / "stage" / "pass-00002").is_dir()    # committed
    assert "chain-0001" not in ck._uploaded_chains
    monkeypatch.delitem(fs._env, "MOCKFS_FAIL_PUT_DIR")
    box.pass_id = 2
    _train("port", store, tr, box, ck, 3)
    assert [e["pass"] for e in _donefile(sandbox)] == [1, 3]
    store2, tr2, box2 = _make("port", seed=2)
    assert tr2.resume(_ckpt("port", tmp_path / "fresh"),
                      box=box2)["pass_id"] == 3


def test_torn_remote_snapshot_falls_back(mockfs, tmp_path):
    fs, sandbox = mockfs
    _, _, states = _write("port", tmp_path / "w_stage")
    dense = sandbox / "ckpt" / "pass-00002" / "dense.npz"
    dense.write_bytes(dense.read_bytes()[:100])
    store, tr, box = _make("port", seed=3)
    before = monitor.STATS.get("ckpt.remote_fallbacks")
    with pytest.warns(UserWarning, match="pass-00002 failed to restore"):
        cursor = tr.resume(_ckpt("port", tmp_path / "r_stage"), box=box)
    assert cursor["pass_id"] == 1
    assert monitor.STATS.get("ckpt.remote_fallbacks") == before + 1
    _assert_same_state(_state("port", store, tr, box), states[1])


def test_remote_retention_and_compaction(mockfs, tmp_path):
    fs, sandbox = mockfs
    before = monitor.STATS.get("ckpt.donefile_compactions")
    _write("port", tmp_path / "stage", passes=5, keep=2)
    names = sorted(os.listdir(sandbox / "ckpt"))
    assert names == ["chain-0002", "chain-0003", "pass-00004", "pass-00005",
                     REMOTE_DONEFILE], names
    assert [e["pass"] for e in _donefile(sandbox)] == [4, 5]
    assert monitor.STATS.get("ckpt.donefile_compactions") > before


def test_interrupted_compaction_is_repaired(mockfs, tmp_path):
    """Only the .compact copy left (a kill between the rewrite's rm and
    put): readers use it, and the next save restores the main file with
    the whole history before appending."""
    fs, sandbox = mockfs
    store, tr, box = _make("port")
    ck = _ckpt("port", tmp_path / "stage")
    for p in (1, 2):
        _train("port", store, tr, box, ck, p)
    main = sandbox / "ckpt" / REMOTE_DONEFILE
    os.replace(main, str(main) + ".compact")
    assert [e["pass"] for e in ck._remote_entries()] == [1, 2]
    before = monitor.STATS.get("ckpt.donefile_repairs")
    _train("port", store, tr, box, ck, 3)
    assert [e["pass"] for e in _donefile(sandbox)] == [1, 2, 3]
    assert not os.path.exists(str(main) + ".compact")
    assert monitor.STATS.get("ckpt.donefile_repairs") == before + 1


def test_elected_rollback_masks_newer_entries(mockfs, tmp_path):
    """resume(at=...) discards the abandoned timeline locally and masks
    it in the donefile: a later fresh resume lands on the elected
    cursor, in either package."""
    fs, sandbox = mockfs
    _, _, states = _write("port", tmp_path / "stage", passes=3)
    store, tr, box = _make("port", seed=4)
    ck = _ckpt("port", tmp_path / "stage")
    assert ck.resume(tr, box=box, at=(1, 0))["pass_id"] == 1
    assert "reset_after" in _donefile(sandbox)[-1]
    for pkg in ("port", "jax"):
        s2, t2, b2 = _make(pkg, seed=5)
        cursor = t2.resume(_ckpt(pkg, tmp_path / f"fresh-{pkg}"), box=b2)
        assert cursor["pass_id"] == 1, pkg
        _assert_same_state(_state(pkg, s2, t2, b2), states[1])


def test_remote_fault_points(mockfs, tmp_path):
    """remote_ckpt.upload.pre fails a save after its local commit, with
    no donefile line; remote_ckpt.download.pre fails every download, and
    the resume falls back to a fresh start."""
    fs, sandbox = mockfs
    store, tr, box = _make("port")
    ck = _ckpt("port", tmp_path / "stage")
    _train("port", store, tr, box, ck, 1)
    faultpoint.arm("remote_ckpt.upload.pre", action="ioerror")
    with pytest.raises(faultpoint.FaultInjected):
        _train("port", store, tr, box, ck, 2)
    faultpoint.disarm()
    assert [e["pass"] for e in _donefile(sandbox)] == [1]
    faultpoint.arm("remote_ckpt.download.pre", action="ioerror")
    store2, tr2, box2 = _make("port", seed=6)
    with pytest.warns(UserWarning, match="failed to restore"):
        assert tr2.resume(_ckpt("port", tmp_path / "r"), box=box2) is None
    assert faultpoint.hit_count("remote_ckpt.download.pre") == 1


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_publish_to_a_remote_root_and_serve(mockfs, tmp_path):
    """Stage → upload → verify → donefile; a staged server serves what a
    local root's server serves, and removes each staged copy."""
    fs, sandbox = mockfs
    job = Job(str(tmp_path / "local"))
    pub = ServingPublisher("mock://serve", job.model, job.schema,
                           publish_base_every=2, quant="f32", hot_top_k=16,
                           staging_dir=str(tmp_path / "pub_stage"))
    srv = ServingServer("mock://serve", device="cpu",
                        staging_dir=str(tmp_path / "srv_stage"))
    local = ServingServer(job.root, device="cpu")
    before = monitor.STATS.get("serving.upload_verify_seconds")
    ids, mask, dense, _ = job.request()
    for p in range(2):                       # a base, then a delta
        if p:
            job.box.begin_pass()
            job.tr.train_pass(job.ds)
        info = job.box.end_pass(trainer=job.tr, publisher=pub)["publish"]
        job.pub.publish(job.store, job.tr.eval_params(), pass_id=p + 1)
        assert info["kind"] == ("base", "delta")[p]
        assert info["path"] == f"mock://serve/{version_name(p + 1)}"
        assert info["upload_seconds"] > 0 and info["verify_seconds"] > 0
        assert os.listdir(tmp_path / "pub_stage") == []
        assert srv.poll_once() == local.poll_once() == 1
        np.testing.assert_array_equal(srv.predict(ids, mask, dense),
                                      local.predict(ids, mask, dense))
        assert os.listdir(tmp_path / "srv_stage") == []
    assert monitor.STATS.get("serving.upload_verify_seconds") > before
    assert srv.active.version == 2 and srv.active.kind == "delta"


def test_publish_killed_before_upload_is_never_announced(mockfs, tmp_path):
    fs, sandbox = mockfs
    job = Job(str(tmp_path / "local"))
    pub = ServingPublisher("mock://serve", job.model, job.schema,
                           quant="f32")
    faultpoint.arm("serving.publish.pre_upload", action="ioerror")
    with pytest.raises(faultpoint.FaultInjected):
        pub.publish(job.store, job.tr.eval_params(), pass_id=1)
    faultpoint.disarm()
    assert pub.latest_announced() is None
    assert not (sandbox / "serve" / version_name(1)).exists()
    srv = ServingServer("mock://serve", device="cpu")
    assert srv.poll_once() == 0


@pytest.mark.parametrize("way", ["port->jax", "jax->port"])
def test_remote_serving_across_packages(mockfs, tmp_path, way):
    fs, sandbox = mockfs
    job = Job(str(tmp_path / "local"))
    root = "mock://x"
    jstore, jpub = _jax_side(root, "f32")
    pub = ServingPublisher(root, job.model, job.schema, quant="f32",
                           publish_base_every=2, hot_top_k=16)
    job.box.end_pass()
    if way == "port->jax":
        pub.publish(job.store, job.tr.eval_params(), pass_id=1)
    else:
        _copy_rows(job, jstore)
        jpub.publish(jstore, job.tr.eval_params(), pass_id=1)
    srv = ServingServer(root, device="cpu",
                        staging_dir=str(tmp_path / "s1"))
    jsrv = JaxServer(root, staging_dir=str(tmp_path / "s2"))
    assert srv.poll_once() == jsrv.poll_once() == 1
    ids, mask, dense, _ = job.request()
    np.testing.assert_allclose(srv.predict(ids, mask, dense),
                               np.asarray(jsrv.predict(ids, mask, dense)),
                               **FWD_TOL)
    np.testing.assert_allclose(srv.predict(ids, mask, dense),
                               job.live_scores(), **FWD_TOL)


def test_fetch_retries_are_bounded(mockfs, tmp_path):
    """An announced version whose download keeps failing: fetch_attempts
    tries with backoff, then the poll diagnoses it and the last good
    version keeps serving."""
    fs, sandbox = mockfs
    job = Job(str(tmp_path / "local"))
    pub = ServingPublisher("mock://serve", job.model, job.schema,
                           publish_base_every=1, quant="f32")
    job.end(pub)
    srv = ServingServer("mock://serve", device="cpu", fetch_attempts=3,
                        fetch_backoff_s=0.01,
                        staging_dir=str(tmp_path / "stage"))
    assert srv.poll_once() == 1
    ids, mask, dense, _ = job.request()
    want = srv.predict(ids, mask, dense)
    job.next_pass(pub)
    shutil.rmtree(sandbox / "serve" / version_name(2))
    before = monitor.STATS.get("serving.fetch_retries")
    with pytest.warns(UserWarning, match="after 3 attempts"):
        assert srv.poll_once() == 0
    assert monitor.STATS.get("serving.fetch_retries") == before + 2
    assert srv.active.version == 1
    assert srv.health()["status"] == "degraded"
    np.testing.assert_array_equal(srv.predict(ids, mask, dense), want)
    assert os.listdir(tmp_path / "stage") == []
