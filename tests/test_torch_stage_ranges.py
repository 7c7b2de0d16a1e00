"""The port's stage scopes in the device trace: while a torch.profiler
session runs, every ``Trainer.timers`` stage and every ``monitor.span``
opens the range ``pbt/<name>`` on the main thread, nested as the code
nests them; with no session a scope constructs no range, and the flight
record's stage split, the hub's span counts and the feed manager's
boundary account stay as they were. The operator's per-pass capture
(``utils.profiler.start_device_trace``) traces every thread."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.embedding.feed_pass import FEED_STAGES
from paddlebox_tpu_torch.train.trainer import FLIGHT_STAGES, STEP_PHASES
from paddlebox_tpu_torch.utils import profiler as prof

from tests.test_torch_resume import BATCH, STEPS, _dataset, _make

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the trainer's stages outside the flight record's split and the feed
# manager's
TRAINER_STAGES = ("pass_keys", "preload", "pass_close", "auc_compute")
STAGES = (*FLIGHT_STAGES, *FEED_STAGES, *TRAINER_STAGES, *STEP_PHASES)


@pytest.fixture(autouse=True)
def _clean_hub():
    h = monitor.hub()
    h.disable()
    h.abort_pass(reason="test boundary")
    yield
    h.disable()
    h.abort_pass(reason="test boundary")


def _two_passes(profiled: bool, tmp_path=None):
    """Pass 1, then pass 2 (new keys, so rows retire at its boundary),
    each preloading the next; pass 2 under the profiler when
    ``profiled``. Returns (trainer, box, pass 2's counts by stage, its
    chrome trace's X events or None)."""
    store, tr, box = _make("port", carry=False)
    d1, d2, d3 = (_dataset("port", tr, s) for s in (1, 2, 3))
    box.begin_pass()
    tr.train_pass(d1, preload_keys=d2.unique_keys())
    box.end_pass()
    count0 = dict(tr.timers.count)

    def pass2():
        box.begin_pass()
        tr.train_pass(d2, preload_keys=d3.unique_keys())
        box.end_pass()

    events = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            pass2()
        path = str(tmp_path / "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
    else:
        pass2()
    tr.wait_feed_pass_done()
    counts = {k: tr.timers.count[k] - count0[k] for k in tr.timers.count}
    return tr, box, counts, events


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    _, _, counts, events = _two_passes(True, tmp_path_factory.mktemp("t"))
    ranges = [e for e in events if e["name"].startswith("pbt/")]
    return counts, ranges


def test_every_stage_range_on_the_main_thread(traced):
    counts, ranges = traced
    assert set(counts) == set(STAGES)
    names = {e["name"] for e in ranges}
    want = {"pbt/" + s for s in STAGES if s != "translate"}
    want |= {"pbt/pack_batch", "pbt/h2d_stage"}
    assert want <= names, sorted(want - names)
    # the pack and feed threads' ranges do not reach a profiler started
    # on the main thread: every range here is the main thread's
    assert {e["tid"] for e in ranges} == {threading.get_native_id()}
    # one range a scope entry on this thread
    for s in STAGES:
        if s != "translate":
            assert sum(e["name"] == "pbt/" + s for e in ranges) == \
                counts[s], s


def _inside(child, parent) -> bool:
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


@pytest.mark.parametrize("child,parent", [
    ("feed_wait", "feed_begin"), ("writeback", "feed_begin"),
    ("feed_wait", "preload"), ("lookup", "train"),
    ("dense_fwd_bwd", "train"), ("sparse_push", "train"),
    ("dense_update", "train")])
def test_ranges_nest_as_the_code_does(traced, child, parent):
    _, ranges = traced
    kids = [e for e in ranges if e["name"] == "pbt/" + child]
    outer = [e for e in ranges if e["name"] == "pbt/" + parent]
    assert kids and outer
    if child == "feed_wait":
        # one join inside begin_pass, one inside the preload
        assert sum(any(_inside(k, o) for o in outer) for k in kids) == 1
    else:
        assert all(any(_inside(k, o) for o in outer) for k in kids)


def test_no_scope_wraps_another_scope_of_the_loop(traced):
    """The step loop's scopes sit side by side: the wait on the pack
    thread is inside no step, and a step is inside no boundary scope."""
    _, ranges = traced
    by = {n: [e for e in ranges if e["name"] == "pbt/" + n]
          for n in ("read", "train", "auc", "feed_begin", "pass_close")}
    for a, b in (("read", "train"), ("train", "feed_begin"),
                 ("train", "pass_close"), ("auc", "train")):
        assert not any(_inside(x, y) for x in by[a] for y in by[b]), (a, b)


def test_no_range_without_a_profiler(monkeypatch, tmp_path):
    made = []

    def record_function(*a, **kw):
        made.append(a)
        raise AssertionError("a range was constructed with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        record_function)
    _, _, counts, _ = _two_passes(False)
    assert made == []
    # the scopes' totals count as they do under the profiler
    monkeypatch.undo()
    assert counts == _two_passes(True, tmp_path)[2]
    assert counts["train"] == counts["auc"] == STEPS
    assert counts["feed_begin"] == counts["writeback"] == 1
    assert counts["lookup"] == counts["dense_update"] == STEPS


def test_flight_record_and_span_counts_unchanged():
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    tr, box, _, _ = _two_passes(False)
    h.disable()
    rec = h.flight_records()[-1]
    assert set(rec["stage_seconds"]) == set(FLIGHT_STAGES)
    names = [r["name"] for r in ms.records if r["pass_id"] == 2]
    for n in ("train_step", "stage/translate", "auc_update",
              "pack_batch", "h2d_stage"):
        assert names.count(n) == STEPS, n
    # the new stages emit no hub event
    assert not any(n.endswith(FEED_STAGES + TRAINER_STAGES + STEP_PHASES)
                   for n in names)
    assert rec["steps"] == STEPS and rec["examples"] == STEPS * BATCH


def test_boundary_seconds_read_from_the_feed_begin_scope():
    store, tr, box = _make("port", carry=False)
    fm = tr.feed_mgr
    assert fm.timers is tr.timers
    for seed in (1, 2):
        t0 = tr.timers.total["feed_begin"]
        box.begin_pass()
        tr.train_pass(_dataset("port", tr, seed))
        box.end_pass()
        assert fm.last_boundary_seconds == pytest.approx(
            tr.timers.total["feed_begin"] - t0, rel=1e-9)
        assert fm.last_boundary_seconds > 0


def test_wait_feed_pass_done_adds_nothing_to_feed_wait():
    store, tr, box = _make("port", carry=False)
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 1),
                  preload_keys=_dataset("port", tr, 2).unique_keys())
    box.end_pass()
    total, count = tr.timers.total["feed_wait"], tr.timers.count["feed_wait"]
    tr.wait_feed_pass_done()
    tr.wait_feed_pass_done()
    assert (tr.timers.total["feed_wait"],
            tr.timers.count["feed_wait"]) == (total, count)


def test_standalone_manager_times_its_boundary():
    from paddlebox_tpu_torch.embedding import (EmbeddingConfig,
                                               HostEmbeddingStore)
    from paddlebox_tpu_torch.embedding.feed_pass import FeedPassManager
    mgr = FeedPassManager(HostEmbeddingStore(EmbeddingConfig(dim=4)),
                          device="cpu")
    assert set(mgr.timers.total) == set(FEED_STAGES)
    keys = np.arange(1, 50, dtype=np.uint64)
    ws = mgr.begin_pass(keys)
    ws.touched[1:] = True                 # every row trained
    mgr.end_pass(ws)
    mgr.begin_feed_pass(keys + 30)
    t0 = mgr.timers.total["feed_begin"]
    mgr.begin_pass(keys + 30)
    # two boundaries; joins in both and in the preload; rows 1-30 retire
    assert mgr.timers.count == {"feed_begin": 2, "feed_wait": 3,
                                "writeback": 1}
    assert mgr.last_boundary_seconds == pytest.approx(
        mgr.timers.total["feed_begin"] - t0, rel=1e-9)
    assert mgr.last_d2h_bytes > 0
    mgr.close()


def test_device_trace_records_every_thread(tmp_path):
    logdir = str(tmp_path / "dev")
    prof.start_device_trace(logdir, device="cpu")
    try:
        def work():
            with monitor.span("worker_span"):
                torch.ones(4).add_(1)

        t = threading.Thread(target=work)
        t.start()
        t.join()
        with monitor.span("main_span"):
            torch.ones(2).mul_(2)
    finally:
        path = prof.stop_device_trace()
    assert path == os.path.join(logdir, "trace.json")
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    tids = {e["name"]: e["tid"] for e in evs
            if e["name"].startswith("pbt/")}
    assert tids["pbt/main_span"] == threading.get_native_id()
    try:
        torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return      # a torch without the option traces this thread alone
    assert tids["pbt/worker_span"] != tids["pbt/main_span"]


def test_monitor_imports_without_torch_and_ranges_once_it_loads():
    script = """
import sys
from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.monitor import StageTimers
assert "torch" not in sys.modules
t = StageTimers(["a"])
with t("a"):
    pass
assert "torch" not in sys.modules
import torch
from torch.profiler import profile
with profile() as p:
    with t("a"), monitor.span("s"):
        pass
names = {e.name for e in p.events()}
assert {"pbt/a", "pbt/s"} <= names, names
assert t.count["a"] == 2
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("OK")
