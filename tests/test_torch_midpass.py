"""Mid-pass snapshots in the port (``Trainer.enable_midpass_snapshots``,
``drain_and_snapshot``, ``PassCheckpointer.save(mid_steps > 0)``):

- a subprocess killed in the ``trainer.midpass.post_save`` window of pass
  2 and resumed in a fresh job (``train_pass(skip_steps=mid_steps)``)
  ends bit-equal to an uninterrupted run, and snapshots on or off leave
  the uninterrupted run's planes bit-equal (the reference's proof,
  tests/test_crash_safety.py);
- a port mid-pass snapshot restores in the JAX package and a JAX one in
  the port, bit-equal to the writer's live state at the snapshot's step
  (store rows, dense params and optimizer state, metric state, cursor);
- ``drain_and_snapshot`` after a pass raised commits a snapshot at the
  step reached that resumes the same way;
- ``every_steps=0`` (and the flag's default) keeps snapshots off.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddlebox_tpu.utils import faultpoint as jfaultpoint

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.monitor.registry import STATS
from paddlebox_tpu_torch.utils import faultpoint

from tests.test_torch_resume import (STEPS, _ckpt, _dataset, _make, _state,
                                     _train)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVERY = 2          # mid-pass cadence: steps 2, 4, 6 of each 6-step pass
PASSES = 2


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faultpoint.disarm()
    jfaultpoint.disarm()


def _run(root, every=EVERY, pkg="port"):
    """The job: PASSES checkpointed passes, mid-pass snapshots every
    ``every`` steps (0 = none). Returns (store, trainer, box)."""
    store, tr, box = _make(pkg)
    ckpt = _ckpt(pkg, root)
    tr.enable_midpass_snapshots(ckpt, every, box, metrics=box.metrics)
    for p in range(1, PASSES + 1):
        _train(pkg, store, tr, box, ckpt, p)
    return store, tr, box


def _by_key(store_state):
    keys, rows = store_state
    order = np.argsort(keys, kind="stable")
    return keys[order], rows[order]


def _assert_state_equal(got, want):
    # the store as a key -> row map: a chain replayed from a base and
    # deltas inserts keys in another order than the live run did
    gk, gr = _by_key(got["store"])
    wk, wr = _by_key(want["store"])
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gr, wr)
    assert sorted(got["dense"]) == sorted(want["dense"])
    for k, v in want["dense"].items():
        assert got["dense"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["dense"][k], v, err_msg=k)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_array_equal(got["metrics"][k], v, err_msg=k)
    assert got["global_step"] == want["global_step"]


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The uninterrupted run's final state, with mid-pass snapshots on
    and off."""
    out = {}
    for every in (EVERY, 0):
        root = str(tmp_path_factory.mktemp(f"golden_{every}"))
        store, tr, box = _run(root, every)
        out[every] = (_state("port", store, tr, box), root)
    return out


def test_snapshots_leave_the_run_bit_equal(golden):
    """Mid-pass snapshots are read-only side effects: the run with them
    ends bit-equal to the run without, and wrote every cadence point."""
    _assert_state_equal(golden[EVERY][0], golden[0][0])
    names = sorted(n for n in os.listdir(golden[EVERY][1])
                   if n.startswith("pass-"))
    # retention keeps the newest 3 of each pool (keep_last_n=3)
    assert names == ["pass-00001", "pass-00001.mid00002",
                     "pass-00001.mid00004", "pass-00001.mid00006",
                     "pass-00002"], names
    assert not any(".mid" in n for n in os.listdir(golden[0][1]))


_KILLED = """
import sys
sys.path.insert(0, {repo!r})
from tests.test_torch_midpass import _run
_run({root!r})
print("not reached")
"""


def test_killed_at_post_save_resumes_bit_equal(tmp_path, golden):
    """A process killed right after pass 2's step-4 snapshot committed:
    a fresh job resumes from its cursor, packs but does not train the 4
    trained steps, finishes the pass, and lands bit-equal to the
    uninterrupted run."""
    root = str(tmp_path / "root")
    # hits: pass 1 at steps 2, 4, 6; pass 2 at step 2, then step 4 fires
    env = dict(os.environ, PBTPU_FAULTPOINT="trainer.midpass.post_save",
               PBTPU_FAULTPOINT_AFTER="4", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _KILLED.format(repo=REPO, root=root)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 137, r.stderr[-2000:]
    assert "FAULTPOINT KILL trainer.midpass.post_save" in r.stderr
    assert "not reached" not in r.stdout
    assert not os.path.exists(os.path.join(root, "pass-00002"))
    store, tr, box = _make("port", seed=5)
    ckpt = _ckpt("port", root)
    cursor = tr.resume(ckpt, box=box)
    assert (cursor["pass_id"], cursor["mid_steps"]) == (1, 4)
    assert tr.global_step == STEPS + 4
    before = STATS.get("trainer.tokens")
    out = _train("port", store, tr, box, ckpt, 2,
                 skip_steps=cursor["mid_steps"])
    assert out["steps"] == STEPS - 4
    # the skipped batches were packed (their tokens counted), not trained
    assert STATS.get("trainer.tokens") - before == \
        STEPS * tr.cfg.global_batch_size * tr.layout.total_len
    _assert_state_equal(_state("port", store, tr, box), golden[0][0])
    assert ckpt.intact_cursors()[-1] == (2, 0)


def _live_at(pkg, root, fp_mod, after, every=3):
    """Run pass 1, then pass 2 with mid-pass snapshots every ``every``
    steps and the post-save window armed to raise on hit ``after + 1``:
    the pass stops right after that snapshot committed, so the job's
    state IS the snapshot's step. Returns that live state."""
    store, tr, box = _make(pkg)
    ckpt = _ckpt(pkg, root)
    _train(pkg, store, tr, box, ckpt, 1)
    tr.enable_midpass_snapshots(ckpt, every, box, metrics=box.metrics)
    fp_mod.arm("trainer.midpass.post_save", action="ioerror", after=after)
    with pytest.raises(fp_mod.FaultInjected):
        _train(pkg, store, tr, box, ckpt, 2)
    fp_mod.disarm()
    return _state(pkg, store, tr, box)


@pytest.mark.parametrize("writer,resumer", [("port", "jax"),
                                            ("jax", "port"),
                                            ("port", "port")])
def test_midpass_snapshot_restores_across_packages(tmp_path, writer,
                                                   resumer):
    """The writer's mid-pass snapshot at pass 2, step 3 restores in the
    resumer bit-equal to the writer's live state at that step."""
    root = str(tmp_path / "root")
    fp_mod = faultpoint if writer == "port" else jfaultpoint
    live = _live_at(writer, root, fp_mod, after=0)
    assert os.path.isdir(os.path.join(root, "pass-00001.mid00003"))
    store, tr, box = _make(resumer, seed=11)
    cursor = tr.resume(_ckpt(resumer, root), box=box)
    assert (cursor["pass_id"], cursor["mid_steps"]) == (1, 3)
    assert cursor["date"] == 20261016
    assert cursor["shuffle_state"] is None
    _assert_state_equal(_state(resumer, store, tr, box), live)


class _RaisingDataset:
    """A dataset whose batch stream raises after ``n`` batches: the
    error reaches the step loop from the pack thread, at the top of step
    ``n + 1``."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def unique_keys(self):
        return self.ds.unique_keys()

    def batches(self, batch_size=None, drop_last=True):
        for i, pb in enumerate(self.ds.batches(batch_size,
                                               drop_last=drop_last)):
            if i == self.n:
                raise RuntimeError("input stream broke")
            yield pb


def test_drain_and_snapshot_resumes_bit_equal(tmp_path, golden):
    root = str(tmp_path / "root")
    store, tr, box = _make("port")
    ckpt = _ckpt("port", root)
    _train("port", store, tr, box, ckpt, 1)
    # nothing to drain after a pass that did not raise
    box.begin_pass()
    assert tr.drain_and_snapshot(ckpt, box) is None
    box.abort_pass("test")
    box.pass_id -= 1
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    try:
        box.set_date(20261016)
        box.begin_pass()
        with pytest.raises(RuntimeError, match="input stream broke"):
            tr.train_pass(_RaisingDataset(_dataset("port", tr, 2), 4),
                          metrics=box.metrics)
        assert tr.last_pass_steps == 4
        snap = tr.drain_and_snapshot(ckpt, box)
        box.abort_pass("input stream broke")
    finally:
        h.disable()
    assert os.path.basename(snap) == "pass-00001.mid00004"
    assert ms.find("drain_snapshot")[0]["fields"]["mid_steps"] == 4
    assert ms.find("pass_aborted")
    assert not box.in_pass
    store2, tr2, box2 = _make("port", seed=3)
    ckpt2 = _ckpt("port", root)
    cursor = tr2.resume(ckpt2, box=box2)
    assert (cursor["pass_id"], cursor["mid_steps"]) == (1, 4)
    out = _train("port", store2, tr2, box2, ckpt2, 2, skip_steps=4)
    assert out["steps"] == STEPS - 4
    _assert_state_equal(_state("port", store2, tr2, box2), golden[0][0])


def test_midpass_off_and_cadence_from_flag(tmp_path, monkeypatch):
    store, tr, box = _make("port", carry=False)
    ckpt = _ckpt("port", str(tmp_path / "a"))
    tr.enable_midpass_snapshots(ckpt, 0, box)
    assert tr._midpass is None
    # the flag's default (0) keeps them off too
    tr.enable_midpass_snapshots(ckpt, None, box)
    assert tr._midpass is None
    _train("port", store, tr, box, ckpt, 1)
    assert sorted(n for n in os.listdir(tmp_path / "a")
                  if n.startswith("pass-")) == ["pass-00001"]
    assert tr.midpass_saves == []
    with pytest.raises(ValueError, match="needs a BoxPS"):
        tr.enable_midpass_snapshots(ckpt, 2)
    # the flag (PBTPU_CKPT_MIDPASS_EVERY_STEPS) sets the cadence
    monkeypatch.setattr(flags, "ckpt_midpass_every_steps", 3)
    ckpt_b = _ckpt("port", str(tmp_path / "b"))
    tr.enable_midpass_snapshots(ckpt_b, None, box)
    before = STATS.get("ckpt.midpass_saves")
    _train("port", store, tr, box, ckpt_b, 2)
    assert [s["mid_steps"] for s in tr.midpass_saves] == [3, 6]
    assert STATS.get("ckpt.midpass_saves") == before + 2
    last = tr.midpass_saves[-1]
    assert last["snapshot"].endswith("pass-00001.mid00006")
    assert last["bytes"] > 0 and last["seconds"] > 0
    assert last["stream_wait_s"] == 0.0         # no card, no stream
