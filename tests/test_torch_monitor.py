"""The port's telemetry hub (``paddlebox_tpu_torch.monitor``) against the
JAX package's: the counterparts of tests/test_monitor.py's cases (context
in spawned threads, nested scopes, per-pass deltas, ``record_train``
accumulation, sink isolation, the JSONL stream with rotation, Prometheus
exposition, the disabled-path cost, the profiler ring, the chrome-trace
markers, faultpoint trips through the hub, the nan guard's event), and
the cross-package check: the same two-pass CPU training in both packages
emits the same per-pass event and span names, flight records with the
same keys and equal deterministic counter deltas, and each package's
records validate under the other package's schema.
"""

import collections
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddlebox_tpu import monitor as jmon
from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.monitor import flight as jflight

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.monitor import context as mon_ctx
from paddlebox_tpu_torch.monitor import flight
from paddlebox_tpu_torch.monitor.registry import STATS
from paddlebox_tpu_torch.utils import faultpoint
from paddlebox_tpu_torch.utils import profiler as prof

from tests.test_torch_resume import BATCH, STEPS, _dataset, _make

torch.set_num_threads(1)


def _reset(h):
    h.disable()
    h.abort_pass(reason="test boundary")


@pytest.fixture(autouse=True)
def _clean_hubs():
    """Both hubs are process singletons: every test starts and ends with
    them disabled and no pass open, so nothing leaks between tests."""
    for h in (monitor.hub(), jmon.hub()):
        _reset(h)
    yield
    faultpoint.disarm()
    for h in (monitor.hub(), jmon.hub()):
        _reset(h)


# ---------------------------------------------------------------------------
# context propagation
# ---------------------------------------------------------------------------

def test_context_propagates_into_spawned_threads():
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    h.begin_pass(11, phase=1)
    mon_ctx.set_step(3)

    def worker():
        monitor.event("pack_producer_done", x=1)

    t = mon_ctx.spawn(worker, name="ctx-worker")
    t.start()
    t.join()
    # a plain thread resolves the pass too (the process-global fallback)
    t2 = threading.Thread(target=worker)
    t2.start()
    t2.join()
    # a step advanced after a thread was spawned is visible to it: the
    # context object is shared and mutable
    seen = []
    start, go = threading.Event(), threading.Event()

    def late_reader():
        start.set()
        go.wait(5)
        seen.append(mon_ctx.current().tags())

    t3 = mon_ctx.spawn(late_reader, name="late-reader")
    t3.start()
    start.wait(5)
    mon_ctx.set_step(99)
    go.set()
    t3.join()
    h.end_pass()
    h.disable()
    evs = ms.find("pack_producer_done")
    assert len(evs) == 2
    for e in evs:
        assert (e["pass_id"], e["step"], e["phase"]) == (11, 3, 1)
        assert e["thread"] != "MainThread"
    assert seen == [{"pass_id": 11, "step": 99, "phase": 1}]
    ms2 = monitor.MemorySink()
    h.enable(ms2)
    monitor.event("eval_pass")
    h.disable()
    assert ms2.records[-1]["pass_id"] is None


def test_nested_scope_restores_outer():
    h = monitor.hub()
    h.begin_pass(1)
    handle = mon_ctx.enter_pass(2)
    assert mon_ctx.current().pass_id == 2
    mon_ctx.exit_pass(handle)
    assert mon_ctx.current().pass_id == 1
    h.end_pass()
    assert mon_ctx.current().pass_id is None


# ---------------------------------------------------------------------------
# per-pass deltas, record_train
# ---------------------------------------------------------------------------

def test_flight_record_stats_delta_vs_cumulative():
    h = monitor.hub()
    monitor.counter_add("t.mon.delta", 10)       # before the pass
    h.begin_pass(21)
    monitor.counter_add("t.mon.delta", 3)
    monitor.counter_add("t.mon.fresh", 2)
    rec = h.end_pass()
    assert rec["pass_id"] == 21
    assert rec["stats_delta"]["t.mon.delta"] == 3
    assert rec["stats_delta"]["t.mon.fresh"] == 2
    assert STATS.get("t.mon.delta") == 13        # cumulative untouched
    h.begin_pass(22)
    assert "t.mon.delta" not in h.end_pass()["stats_delta"]


def test_record_train_accumulates():
    h = monitor.hub()
    h.begin_pass(31)
    h.record_train(stage_seconds={"train": 1.0}, steps=4, examples=64,
                   seconds=2.0, boundary_seconds=0.5,
                   boundary_split={"build": 0.25})
    h.record_train(stage_seconds={"train": 0.5, "auc": 0.25}, steps=2,
                   examples=32, seconds=1.0, boundary_seconds=0.25,
                   boundary_split={"build": 0.5, "h2d": 0.125})
    rec = h.end_pass()
    assert rec["steps"] == 6 and rec["examples"] == 96
    assert rec["stage_seconds"] == {"train": 1.5, "auc": 0.25}
    assert rec["train_seconds"] == pytest.approx(3.0)
    assert rec["extra"]["boundary_seconds"] == 0.75
    assert rec["extra"]["boundary_split"] == {"build": 0.75, "h2d": 0.125}
    assert flight.validate_flight_record(rec) == []


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

class _BoomSink(monitor.Sink):
    def __init__(self):
        self.calls = 0

    def emit(self, rec):
        self.calls += 1
        raise RuntimeError("sink boom")


def test_failing_sink_never_kills_training_and_is_detached():
    h = monitor.hub()
    boom, ms = _BoomSink(), monitor.MemorySink()
    h.enable(boom, ms)
    for i in range(10):
        monitor.event("pack_producer_done", i=i)     # never raises
    health = h.summary()["sinks"]
    h.disable()
    assert boom.calls == 3               # detached after 3 failures
    assert len(ms.find("pack_producer_done")) == 10
    assert h.sink_errors >= 3
    detached = [s for s in health if s["state"] == "detached"]
    assert detached and detached[0]["type"] == "_BoomSink"
    assert detached[0]["strikes"] == 3


def test_failing_sink_during_training(tmp_path):
    """A sink that raises on every record, attached through a whole
    BoxPS pass: the pass trains, its flight record commits and reaches
    the healthy sink."""
    store, tr, box = _make("port", carry=False)
    h = monitor.hub()
    boom, ms = _BoomSink(), monitor.MemorySink()
    h.enable(boom, ms)
    box.begin_pass()
    out = tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    info = box.end_pass()
    h.disable()
    assert out["steps"] == STEPS and boom.calls == 3
    assert info["flight_record"]["steps"] == STEPS
    assert ms.find("pass") and ms.find("train_step")


def test_jsonl_sink_bad_path_never_blocks(tmp_path):
    bad = tmp_path / "iam_a_dir"
    bad.mkdir()
    sink = monitor.JsonlSink(str(bad), queue_size=32)  # open() fails
    h = monitor.hub()
    h.enable(sink)
    t0 = time.perf_counter()
    for i in range(5000):
        monitor.event("pack_producer_done", i=i)
    elapsed = time.perf_counter() - t0
    h.disable()                          # joins the writer thread
    assert elapsed < 5.0
    assert sink.error is not None


def test_jsonl_roundtrip_and_rotation(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    sink = monitor.JsonlSink(path, rotate_mb=0.002)    # ~2 KB segments
    h = monitor.hub()
    h.enable(sink)
    h.begin_pass(5)
    for i in range(60):
        monitor.event("pack_producer_done", batches=i)
    h.end_pass()
    h.disable()
    assert sink.error is None and sink.rotations >= 2
    assert len(sink.segments) == sink.rotations + 1
    events, flights = 0, 0
    for seg in sink.segments:
        # every segment is whole lines, schema-clean under both packages'
        # validators, and each full one names its successor
        for res in (flight.validate_events_file(seg),
                    jflight.validate_events_file(seg)):
            assert res["errors"] == [], res["errors"][:5]
        res = flight.validate_events_file(seg)
        events += res["events"]
        flights += len(res["flight_records"])
    assert flights == 1
    assert events >= 62                  # pass_begin, 60 events, record
    with open(sink.segments[0]) as f:
        last = json.loads(f.read().splitlines()[-1])
    assert last["name"] == "sink_rotated"
    assert last["fields"]["next"] == os.path.basename(sink.segments[1])


def test_parity_log_sink_prints_flight_record(capsys):
    h = monitor.hub()
    h.enable(monitor.ParityLogSink())
    h.begin_pass(7)
    h.record_train(stage_seconds={"train": 0.5}, steps=2, examples=8)
    h.end_pass()
    h.disable()
    out = capsys.readouterr().out
    assert "[pbtpu] pass=7" in out and "steps=2 examples=8" in out
    assert "train=0.500s" in out


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------

def test_prometheus_exposition_matches_reference_format():
    monitor.counter_add("t.prom/count:er", 7)
    monitor.gauge_set("t.prom.gauge", 2.5)
    lines = monitor.hub().prometheus_text().splitlines()
    assert "# TYPE pbtpu_t_prom_count:er counter" in lines
    assert "pbtpu_t_prom_count:er 7" in lines
    assert "# TYPE pbtpu_t_prom_gauge gauge" in lines
    assert "pbtpu_t_prom_gauge 2.5" in lines
    # the alert and sink-health series are always there, as in the JAX
    # package's exposition
    for name in ("# TYPE pbtpu_exchange_overflow_retries counter",
                 "# TYPE pbtpu_tiering_hot_rows gauge",
                 "# TYPE pbtpu_tiering_hot_hit_rate gauge",
                 "# TYPE pbtpu_monitor_sinks_attached gauge"):
        assert name in lines
    for line in lines:
        if line and not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            float(val)
            assert " " not in name
    assert (set(monitor.hub().ALERT_COUNTERS)
            == set(jmon.hub().ALERT_COUNTERS))
    assert set(monitor.hub().SINK_GAUGES) == set(jmon.hub().SINK_GAUGES)


def test_training_metrics_endpoint():
    srv = monitor.start_metrics_endpoint(port=0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert "pbtpu_tiering_hot_hit_rate" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
        srv._pbtpu_thread.join(timeout=10)


# ---------------------------------------------------------------------------
# the disabled path, the unported read side
# ---------------------------------------------------------------------------

def test_disabled_path_call_cost():
    h = monitor.hub()
    assert not h.enabled
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        monitor.event("pack_producer_done", x=1)
    event_cost = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(n):
        with monitor.span("train_step"):
            pass
    span_cost = (time.perf_counter() - t0) / n
    # the reference's bounds (tests/test_monitor.py)
    assert event_cost < 5e-6, f"disabled event() costs {event_cost:.2e}s"
    assert span_cost < 10e-6, f"disabled span() costs {span_cost:.2e}s"


@pytest.mark.parametrize("flag", ["trace", "trace_device", "doctor_live"])
def test_read_side_flags_refused_up_front(monkeypatch, flag):
    """The read-side flags were refused while the world trace and the live
    doctor were unported; now the hub enables with each set and a BoxPS
    pass runs through it: the trace stamps the pass's records, the device
    capture is a no-op for a CPU trainer (no error counted), the live
    doctor evaluates at end_pass."""
    from paddlebox_tpu_torch.monitor import trace as trace_lib
    monkeypatch.setattr(flags, flag, True)
    if flag == "trace_device":
        monkeypatch.setattr(flags, "trace", True)
    errs0 = STATS.get("trace.device_capture_errors")
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    assert h.enabled
    store, tr, box = _make("port", carry=False)
    try:
        box.begin_pass()
        assert box.in_pass and box.pass_id == 1
        assert mon_ctx.current().pass_id == 1
        assert trace_lib.active() == flags.trace
        end = box.end_pass()
    finally:
        trace_lib.on_end_pass()
        trace_lib._SAW_PASS = False
    fr = end["flight_record"]
    if flags.trace:
        assert fr["trace_id"] == "run:1" and fr["span_id"]
        assert all(r.get("trace_id") == "run:1" for r in ms.records)
    else:
        assert "trace_id" not in fr
    assert STATS.get("trace.device_capture_errors") == errs0
    assert trace_lib.last_device_trace is None or flag != "trace_device"
    assert (h.last_doctor_findings is not None) == (flag == "doctor_live")
    assert not trace_lib.active()


def test_profiler_ring_buffer_caps_and_counts_drops(monkeypatch):
    monkeypatch.setattr(flags, "profiler_max_events", 16)
    before = STATS.get("profiler.dropped_spans")
    prof.enable_profiler()
    try:
        for i in range(50):
            with prof.RecordEvent(f"s{i}"):
                pass
        evs = prof.profiler_events()
        assert len(evs) == 16 and prof.dropped_spans() == 34
        assert evs[-1]["name"] == "s49" and evs[0]["name"] == "s34"
        assert STATS.get("profiler.dropped_spans") == before + 34
    finally:
        prof.disable_profiler()
    assert prof.stat_get("profiler.dropped_spans") == before + 34


def test_chrome_trace_has_pass_markers_and_tagged_spans(tmp_path):
    h = monitor.hub()
    prof.enable_profiler()
    try:
        h.begin_pass(77)
        mon_ctx.set_step(5)
        with monitor.span("train_step"):
            pass
        h.end_pass()
    finally:
        prof.disable_profiler()
    path = str(tmp_path / "trace.json")
    assert prof.export_chrome_trace(path) == 3
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert {e["name"] for e in evs if e["ph"] == "i"} == {"pass_begin",
                                                          "pass_end"}
    span = next(e for e in evs if e["name"] == "train_step")
    assert span["args"] == {"pass_id": 77, "step": 5}


def test_device_trace_on_the_host_names_pass_markers(tmp_path):
    """torch.profiler as the device trace (CPU activity here; the card's
    run adds the CUDA kernels): the pass markers recorded while it runs
    land in its Chrome trace."""
    with pytest.raises(RuntimeError, match="no device trace"):
        prof.stop_device_trace()
    prof.start_device_trace(str(tmp_path), device="cpu")
    h = monitor.hub()
    h.begin_pass(3)
    torch.ones(4) @ torch.ones(4)
    h.end_pass()
    path = prof.stop_device_trace()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pass_begin", "pass_end"} <= names


# ---------------------------------------------------------------------------
# faultpoints through the hub
# ---------------------------------------------------------------------------

def test_faultpoint_trip_routes_through_hub():
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    before = (STATS.get("faultpoint.trips"), STATS.get("faultpoint.armed"),
              STATS.get("faultpoint.trip.pass_ckpt.pre_manifest"))
    faultpoint.arm("pass_ckpt.pre_manifest", action="ioerror")
    with pytest.raises(faultpoint.FaultInjected):
        faultpoint.hit("pass_ckpt.pre_manifest")
    h.disable()
    assert STATS.get("faultpoint.trips") == before[0] + 1
    assert STATS.get("faultpoint.armed") == before[1] + 1
    assert STATS.get("faultpoint.trip.pass_ckpt.pre_manifest") == \
        before[2] + 1
    ev = ms.find("faultpoint_trip")
    assert ev and ev[0]["fields"] == {"point": "pass_ckpt.pre_manifest",
                                      "action": "ioerror"}
    assert ms.find("faultpoint_armed")[0]["fields"]["after"] == 0


def test_broken_hub_never_fails_arm(monkeypatch):
    from paddlebox_tpu_torch.monitor.hub import _HUB

    def boom(*a, **k):
        raise RuntimeError("hub down")

    monkeypatch.setattr(_HUB, "counter_add", boom)
    before = faultpoint.hub_failures
    faultpoint.arm("pass_ckpt.post_manifest", action="ioerror")
    assert faultpoint.hub_failures == before + 1
    with pytest.raises(faultpoint.FaultInjected):
        faultpoint.hit("pass_ckpt.post_manifest")
    assert faultpoint.hub_failures == before + 2


# ---------------------------------------------------------------------------
# the trainer's write side
# ---------------------------------------------------------------------------

def test_nan_guard_trips_with_telemetry(tmp_path, monkeypatch):
    store, tr, box = _make("port", carry=False)
    tr.cfg.nan_dump_dir = str(tmp_path / "dump")
    ds = _dataset("port", tr, 1)
    ds.records.float_values[1][9] = np.inf        # a dense input of row 9
    monkeypatch.setattr(flags, "check_nan_inf", True)
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    before = STATS.get("trainer.nan_trips")
    with pytest.raises(FloatingPointError, match="non-finite leaves"):
        tr.train_pass(ds)
    h.disable()
    ev = ms.find("nan_guard")
    assert ev and ev[0]["fields"]["n_bad"] >= 1
    assert any("loss" in p for p in ev[0]["fields"]["paths"])
    assert STATS.get("trainer.nan_trips") == before + 1
    # the trainer-owned pass scope was aborted, not left open
    assert mon_ctx.current().pass_id is None
    assert ms.find("pass_aborted")
    assert any(d.startswith("nan_step") for d in os.listdir(tmp_path /
                                                             "dump"))


def test_dump_stream_counts_and_tags_its_lines(tmp_path):
    store, tr, box = _make("port", carry=False)
    tr.cfg.dump_fields_path = str(tmp_path / "dump.txt")
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    before = STATS.get("dump_stream.lines")
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    rec = box.end_pass()["flight_record"]
    h.disable()
    assert STATS.get("dump_stream.lines") == before + STEPS * BATCH
    assert rec["stats_delta"]["dump_stream.lines"] == STEPS * BATCH
    evs = ms.find("dump_fields_written")
    assert len(evs) == STEPS
    assert all(e["pass_id"] == 1 and e["thread"] == "pbt-dump-writer"
               for e in evs)


def test_two_pass_flight_records_and_jsonl_schema(tmp_path):
    store, tr, box = _make("port", carry=False)
    h = monitor.hub()
    ms = monitor.MemorySink()
    path = str(tmp_path / "events.jsonl")
    h.enable(ms, monitor.JsonlSink(path))
    infos = []
    for p in (1, 2):
        box.begin_pass()
        out = tr.train_pass(_dataset("port", tr, p), metrics=box.metrics)
        infos.append(box.end_pass())
    ev = tr.eval_pass(_dataset("port", tr, 3))
    h.disable()
    res = flight.validate_events_file(path)
    assert res["errors"] == [], res["errors"][:10]
    assert [f["pass_id"] for f in res["flight_records"]] == [1, 2]
    for info, fr in zip(infos, res["flight_records"]):
        assert info["flight_record"]["pass_id"] == fr["pass_id"]
        assert fr["steps"] == STEPS and fr["examples"] == STEPS * BATCH
        assert {"read", "translate", "train", "auc",
                "drain"} <= set(fr["stage_seconds"])
        d = fr["stats_delta"]
        assert d["trainer.tokens"] == STEPS * BATCH * tr.layout.total_len
        assert d["trainer.pull_bytes"] == (d["trainer.tokens"] * 4
                                           * store.cfg.pull_width)
        assert fr["metrics"]["auc"]["auc"] > 0
        assert fr["extra"]["pull_engine"] == tr.pull_engine
        assert set(fr["extra"]["boundary_split"]) == {
            "build", "h2d", "spill_fault_in"}
    assert fr["extra"]["loss_mean"] == pytest.approx(out["loss_mean"])
    # everything emitted inside a pass carries its id, the pack and feed
    # threads' records included; eval runs after the passes, outside any
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    last = max(i for i, r in enumerate(recs) if r["type"] == "flight_record")
    in_pass = [r for r in recs[:last] if r["type"] in ("span", "event")]
    assert in_pass and all(r["pass_id"] in (1, 2) for r in in_pass)
    assert all(r["pass_id"] is None for r in recs[last + 1:])
    assert any(r["thread"] == "pbt-pack" for r in in_pass)
    assert ms.find("eval_pass")[0]["fields"]["auc"] == pytest.approx(
        ev["auc"])


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

# counters whose per-pass deltas depend only on the data and the keys:
# equal in both packages (the byte counts of the boundary follow each
# package's row-padding rule and are not compared)
DETERMINISTIC = ("trainer.tokens", "trainer.pull_bytes",
                 "trainer.push_bytes", "feed_pass.fresh_rows",
                 "feed_pass.reused_rows", "feed_pass.stale_rows",
                 "feed_pass.patched_rows", "feed_pass.retired_rows",
                 "feed_pass.flushed_rows", "dataset.records_loaded",
                 "trainer.push_applies")


def _two_passes(pkg, mon):
    store, tr, box = _make(pkg)
    h = mon.hub()
    ms = mon.MemorySink()
    h.enable(ms)
    try:
        records = []
        for p in (1, 2):
            box.begin_pass()
            tr.train_pass(_dataset(pkg, tr, p), metrics=box.metrics)
            records.append(box.end_pass()["flight_record"])
    finally:
        h.disable()
    return ms.records, records


@pytest.fixture(scope="module")
def both(request):
    # like with like: both packages run their deferred sparse push, so
    # each step's push_apply span and trainer.push_applies count are
    # compared too
    old = (jflags.push_overlap, flags.push_overlap)
    jflags.push_overlap = flags.push_overlap = "on"
    try:
        out = {"jax": _two_passes("jax", jmon),
               "port": _two_passes("port", monitor)}
    finally:
        jflags.push_overlap, flags.push_overlap = old
    return out


def test_same_event_and_span_names_per_pass(both):
    for p in (1, 2):
        got = {}
        for pkg, (recs, _) in both.items():
            mine = [r for r in recs if r["pass_id"] == p]
            got[pkg] = (
                # the step thread's order is deterministic...
                [r["name"] for r in mine if r["thread"] == "MainThread"],
                # ...the pack thread's records interleave with it
                collections.Counter(r["name"] for r in mine))
        assert got["port"][0] == got["jax"][0], p
        assert got["port"][1] == got["jax"][1], p
        names = got["port"][1]
        assert names["train_step"] == STEPS == names["stage/translate"]
        assert names["push_apply"] == STEPS
        assert names["pass"] == 1


def test_same_flight_record_keys_and_deterministic_deltas(both):
    (_, jrecs), (_, precs) = both["jax"], both["port"]
    for jr, pr in zip(jrecs, precs):
        assert sorted(pr) == sorted(jr)
        assert sorted(pr["stage_seconds"]) == sorted(jr["stage_seconds"])
        assert sorted(pr["metrics"]) == sorted(jr["metrics"])
        # the port's extras are the reference's minus the routed
        # exchange's identity (table_layout, routed_dropped)
        assert set(pr["extra"]) <= set(jr["extra"])
        assert set(jr["extra"]) - set(pr["extra"]) <= {"table_layout",
                                                       "routed_dropped"}
        assert (pr["steps"], pr["examples"]) == (jr["steps"],
                                                 jr["examples"])
        for k in DETERMINISTIC:
            assert pr["stats_delta"].get(k) == jr["stats_delta"].get(k), k
    assert precs[1]["stats_delta"]["feed_pass.reused_rows"] > 0


def test_records_validate_under_both_schemas(both):
    for pkg, (recs, _) in both.items():
        for r in recs:
            check = (("flight_record", flight.validate_flight_record,
                      jflight.validate_flight_record)
                     if r["type"] == "flight_record"
                     else ("event", flight.validate_event,
                           jflight.validate_event))
            for validate in check[1:]:
                assert validate(r) == [], (pkg, r["name"])
    # and the flight-record validators reject the same broken record
    bad = dict(both["port"][1][0], steps="six")
    assert flight.validate_flight_record(bad) == \
        jflight.validate_flight_record(bad) != []


def test_spill_tier_counters_land_in_the_flight_record(tmp_path,
                                                       monkeypatch):
    """A spill store's pass boundary flushes its tiering.* / spill.*
    counters before BoxPS commits the flight record."""
    from paddlebox_tpu_torch.embedding import tiering
    from paddlebox_tpu_torch.embedding import EmbeddingConfig

    monkeypatch.setattr(flags, "table_tiering", "spill")
    monkeypatch.setattr(flags, "spill_dir", str(tmp_path / "spill"))
    monkeypatch.setattr(flags, "spill_cache_rows", 64)
    store = tiering.store_from_flags(EmbeddingConfig(
        dim=8, optimizer="adagrad", learning_rate=0.05))
    _, tr, box = _make("port", carry=False)
    from paddlebox_tpu_torch.train import Trainer
    tr = Trainer(tr.model, store, tr.schema, tr.cfg, device="cpu")
    from paddlebox_tpu_torch.fleet import BoxPS
    box = BoxPS(store)
    recs = []
    for p in (1, 2):
        box.begin_pass()
        tr.train_pass(_dataset("port", tr, p))
        recs.append(box.end_pass()["flight_record"])
    d = recs[1]["stats_delta"]
    assert d.get("spill.cache_hits", 0) + d.get("spill.cache_misses", 0) > 0
    assert d["tiering.admitted"] > 0
    assert recs[1]["extra"]["table_tiering"] == "spill"
    lines = monitor.hub().prometheus_text().splitlines()
    assert any(line.startswith("pbtpu_tiering_hot_rows ") and
               float(line.split()[1]) > 0 for line in lines)
    assert flight.validate_flight_record(recs[1]) == []
    assert jflight.validate_flight_record(recs[1]) == []
