"""The port's world trace (``paddlebox_tpu_torch.monitor.trace``) against
the JAX package's: the counterparts of tests/test_trace.py's cases — the
two-rank merge recovering an injected clock skew, schema-clean streams,
trace ids and parent links, pass sampling, the disabled cost, the
heartbeat's clock probes, the publish → swap flow edge and the serving
request spans parent-linked to the publish, the trace and doctor CLIs,
flow-edge attribution, the exchange flow fields, the closed name
registry, ``ensure_service`` and ``flow_propagated`` — plus the per-pass
device capture, a no-op for a CPU trainer. The two packages' mergers are
held to one another: ``merge_streams`` over the same recorded streams
(written by either package's hub) gives equal JSON.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu import monitor as jmon
from paddlebox_tpu.config import flags as jflags
from paddlebox_tpu.embedding import EmbeddingConfig as JaxCfg
from paddlebox_tpu.embedding import exchange as jexchange
from paddlebox_tpu.monitor import critical_path as jcp
from paddlebox_tpu.monitor import names as jnames
from paddlebox_tpu.monitor import trace as jtrace

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.embedding import EmbeddingConfig, exchange
from paddlebox_tpu_torch.monitor import critical_path as cp_lib
from paddlebox_tpu_torch.monitor import doctor, flight, names
from paddlebox_tpu_torch.monitor import trace as trace_lib
from paddlebox_tpu_torch.monitor.aggregate import EVIDENCE_EVENTS
from paddlebox_tpu_torch.monitor.registry import STATS

from tests.test_trace import (_append_probe, _pass_slices, _shift_stream,
                              _write_doctor_world)

torch.set_num_threads(1)

TRACE_FLAGS = ("trace", "trace_sample_passes", "trace_run_id",
               "trace_device", "trace_device_dir", "serving_trace_sample")


@pytest.fixture(autouse=True)
def _clean():
    saved = {k: getattr(flags, k) for k in TRACE_FLAGS}
    jsaved = {k: jflags.get(k) for k in TRACE_FLAGS}
    for h in (monitor.hub(), jmon.hub()):
        h.disable()
        h.abort_pass(reason="test setup")
    for t in (trace_lib, jtrace):
        t.on_end_pass()
        t._SAW_PASS = False
    yield
    for t in (trace_lib, jtrace):
        t.on_end_pass()
        t._SAW_PASS = False
    for h in (monitor.hub(), jmon.hub()):
        h.abort_pass(reason="test teardown")
        h.disable()
    for k, v in saved.items():
        flags.set(k, v)
    for k, v in jsaved.items():
        jflags.set(k, v)


def _emit_rank_stream(pkg: str, dirpath: str, pass_id=1, steps=2) -> str:
    """One traced pass through one package's real pipeline: JsonlSink +
    begin_pass + spans + exchange flow points + end_pass."""
    mon, tl, fl = ((monitor, trace_lib, flags) if pkg == "port"
                   else (jmon, jtrace, jflags))
    fl.set("trace", True)
    h = mon.hub()
    h.enable(mon.JsonlSink(os.path.join(dirpath, "events.jsonl")))
    h.begin_pass(pass_id, phase=1)
    assert tl.active()
    for s in range(steps):
        mon.context.set_step(s)
        with mon.span("pack_batch"):
            pass
        tl.flow("exchange", f"p{pass_id}.s{s}", wire="f32", tokens=64,
                bytes_bound=4096)
        with mon.span("train_step"):
            time.sleep(0.001)
    h.record_train(stage_seconds={"read": 0.01}, steps=steps,
                   examples=steps * 64, seconds=0.01)
    h.end_pass()
    h.disable()
    fl.set("trace", False)
    return os.path.join(dirpath, "events.jsonl")


def _merge_both(roots, rank_names=None) -> dict:
    merged = trace_lib.merge_roots(roots, rank_names=rank_names)
    assert json.dumps(merged, sort_keys=True) == json.dumps(
        jtrace.merge_roots(roots, rank_names=rank_names), sort_keys=True)
    return merged


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_two_rank_merge_recovers_injected_skew(tmp_path, writer):
    d0 = str(tmp_path / "rank0")
    os.makedirs(d0)
    f0 = _emit_rank_stream(writer, d0)
    skew = 5.0
    _shift_stream(f0, str(tmp_path / "rank1"), skew)
    _append_probe(f0, observer=0, peer=1, offset_s=skew)
    merged = _merge_both([d0, str(tmp_path / "rank1")])
    summary = trace_lib.summarize(merged)
    assert abs(summary["clock_offsets_s"]["1"] - skew) < 1e-6
    assert summary["clock_corrected_ranks"] == [0, 1]
    p0, p1 = _pass_slices(merged, 0), _pass_slices(merged, 1)
    assert abs(p0[0]["ts"] - p1[0]["ts"]) < 0.05 * 1e6
    ex = [e for e in summary["flow_edges"] if e["kind"] == "exchange"]
    assert len(ex) == 2
    for e in ex:
        assert {e["src_rank"], e["dst_rank"]} == {0, 1}
        assert abs(e["latency_s"]) < 0.05
    s_ids = {e["id"] for e in merged["traceEvents"] if e.get("ph") == "s"}
    f_ids = {e["id"] for e in merged["traceEvents"] if e.get("ph") == "f"}
    assert s_ids and s_ids == f_ids
    raw = trace_lib.read_trace_records(d0)
    assert raw == jtrace.read_trace_records(d0)
    raw["clock_probes"] = []
    other = trace_lib.read_trace_records(str(tmp_path / "rank1"))
    uncorrected = trace_lib.merge_streams([raw, other], [0, 1])
    assert uncorrected == jtrace.merge_streams([raw, other], [0, 1])
    q0, q1 = _pass_slices(uncorrected, 0), _pass_slices(uncorrected, 1)
    assert abs(q0[0]["ts"] - q1[0]["ts"]) > 4.0 * 1e6


def test_every_emitted_record_passes_validate_event(tmp_path):
    from paddlebox_tpu.monitor import flight as jflight
    d0 = str(tmp_path / "rank0")
    os.makedirs(d0)
    f0 = _emit_rank_stream("port", d0)
    for fl in (flight, jflight):
        out = fl.validate_events_file(f0)
        assert out["errors"] == []
        assert out["events"] > 0 and out["flight_records"]


def test_trace_ids_and_parent_links():
    flags.set("trace", True)
    ms = monitor.MemorySink()
    h = monitor.hub()
    h.enable(ms)
    h.begin_pass(3)
    with monitor.span("pack_batch"):
        with monitor.span("train_step"):
            monitor.event("nan_guard", n_bad=0)
    h.end_pass()
    by_name = {r["name"]: r for r in ms.records}
    outer, inner = by_name["pack_batch"], by_name["train_step"]
    ev, fr = by_name["nan_guard"], by_name["pass"]
    tid = outer["trace_id"]
    assert tid == "run:3"
    assert all(r.get("trace_id") == tid for r in (inner, ev, fr))
    assert inner["parent_span_id"] == outer["span_id"]
    assert ev["parent_span_id"] == inner["span_id"]
    assert fr["span_id"] == outer["parent_span_id"]
    assert fr["parent_span_id"] is None
    for r in ms.records:
        assert flight.validate_event(r) == []


def test_sampling_gates_whole_passes():
    flags.set("trace", True)
    flags.set("trace_sample_passes", 2)
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    for p in (1, 2):
        h.begin_pass(p)
        assert trace_lib.active() == (p == 2)
        with monitor.span("pack_batch"):
            pass
        h.end_pass()
    spans = [r for r in ms.records if r["name"] == "pack_batch"]
    assert "trace_id" not in spans[0]
    assert spans[1]["trace_id"] == "run:2"
    flags.set("trace_run_id", "jobB")
    h.begin_pass(4)
    assert trace_lib.trace_id() == "jobB:4"
    h.abort_pass(reason="done")
    assert not trace_lib.active()        # abort closes the window too


def test_disabled_cost_is_one_check():
    assert not trace_lib.active()
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        trace_lib.flow("exchange", "p0.s0", wire="f32")
    cost = (time.perf_counter() - t0) / n
    assert cost < 5e-6, f"disabled flow() costs {cost:.2e}s"


def test_heartbeat_roundtrip_emits_clock_probe_with_skew(tmp_path):
    from paddlebox_tpu_torch.distributed.resilience import HeartbeatMonitor
    from paddlebox_tpu_torch.distributed.store import FileStore
    st = FileStore(str(tmp_path), timeout_s=1.0)
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    hb0 = HeartbeatMonitor(st, 0, 2, run_id="r", watch=False, start=False)
    hb1 = HeartbeatMonitor(st, 1, 2, run_id="r", watch=False, start=False)
    skew = 5.0
    hb1._wall = lambda: time.time() + skew
    try:
        hb0.publish()
        hb1.scan()
        hb1.publish()
        hb0.scan()
    finally:
        hb0.close()
        hb1.close()
    mine = [p for p in ms.find("trace.clock_probe")
            if (p["fields"] or {}).get("observer") == 0]
    assert mine
    f = mine[-1]["fields"]
    assert f["peer"] == 1 and abs(f["offset_s"] - skew) < 0.5
    # the probe feeds the merger's estimate as the reference's does
    est = trace_lib.estimate_clock_offsets([f], [0, 1])
    assert est == jtrace.estimate_clock_offsets([f], [0, 1])
    assert abs(est["offsets_s"][1] - skew) < 0.5


# ---------------------------------------------------------------------------
# publish -> serving swap, and the request spans
# ---------------------------------------------------------------------------

def _traced_publish(tmp_path, serving_trace_sample=0):
    """A traced port pass that publishes (its stream under rank0), then
    a server that swaps the version in and scores one batch through a
    frontend (its stream under rank1). Returns (entry, roots, server)."""
    from paddlebox_tpu_torch.fleet import BoxPS, FleetUtil
    from paddlebox_tpu_torch.serving import (DONEFILE, BatchingFrontend,
                                             ServingServer)
    from tests.test_torch_serving import Job

    flags.set("trace", True)
    d_train, d_serve = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    h = monitor.hub()
    h.enable(monitor.JsonlSink(os.path.join(d_train, "events.jsonl")))
    job = Job.__new__(Job)
    Job.__init__(job, str(tmp_path / "serve"))   # opens and trains pass 1
    assert isinstance(job.box, BoxPS)
    info = job.end()
    assert info["announced"]
    h.disable()
    entry = FleetUtil(job.root).latest(DONEFILE)
    flags.set("serving_trace_sample", serving_trace_sample)
    h.enable(monitor.JsonlSink(os.path.join(d_serve, "events.jsonl")))
    srv = ServingServer(job.root, device="cpu")
    assert srv.poll_once() == 1
    ids, mask, dense, _ = job.request()
    fe = BatchingFrontend(srv, max_batch=16, max_wait_s=0.002).start()
    futs = [fe.submit(ids[i], mask[i], dense[i]) for i in range(32)]
    scores = [f.result(timeout=60) for f in futs]
    fe.stop()
    h.disable()
    assert np.all(np.isfinite(scores))
    return entry, [d_train, d_serve], srv


def test_publish_to_swap_flow_edge(tmp_path):
    entry, roots, srv = _traced_publish(tmp_path)
    assert isinstance(entry.get("trace"), dict)
    assert entry["trace"]["trace_id"] == "run:1"
    assert srv.active.trace == entry["trace"]
    summary = trace_lib.summarize(_merge_both(roots))
    e = next(e for e in summary["flow_edges"] if e["kind"] == "publish")
    assert e["key"] == "v1" and (e["src_rank"], e["dst_rank"]) == (0, 1)
    assert e["latency_s"] >= 0
    assert e["fields"]["parent_span_id"] == entry["trace"]["span_id"]
    assert e["fields"]["parent_trace_id"] == entry["trace"]["trace_id"]
    for d in roots:
        res = flight.validate_events_file(os.path.join(d, "events.jsonl"))
        assert res["errors"] == []


def test_request_spans_parent_linked_to_the_publish(tmp_path):
    entry, roots, _ = _traced_publish(tmp_path, serving_trace_sample=1)
    with open(os.path.join(roots[1], "events.jsonl")) as f:
        records = [json.loads(line) for line in f]
    score = [r for r in records if r.get("name") == "serve/score"]
    wait = [r for r in records if r.get("name") == "serve/wait"]
    assert score and wait
    for r in score:
        assert r["fields"]["parent_span_id"] == entry["trace"]["span_id"]
        assert r["fields"]["parent_trace_id"] == entry["trace"]["trace_id"]
        assert r["fields"]["role"] == "stable"
    summary = trace_lib.summarize(_merge_both(roots))
    assert summary["linked_spans"] >= 1 and summary["linked_edges"] >= 1


def test_request_spans_off_by_default(tmp_path):
    _, roots, _ = _traced_publish(tmp_path, serving_trace_sample=0)
    with open(os.path.join(roots[1], "events.jsonl")) as f:
        names_ = {json.loads(line).get("name") for line in f}
    assert "serve/score" not in names_ and "serve/wait" not in names_
    assert "serving_swap" in names_


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_trace_cli_writes_perfetto_json(tmp_path, capsys):
    d0 = str(tmp_path / "rank0")
    os.makedirs(d0)
    f0 = _emit_rank_stream("port", d0)
    _shift_stream(f0, str(tmp_path / "rank1"), 2.0)
    _append_probe(f0, observer=0, peer=1, offset_s=2.0)
    out = str(tmp_path / "world_trace.json")
    assert trace_lib.main([d0, str(tmp_path / "rank1"), "-o", out,
                           "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["out"] == out and summary["ranks"] == [0, 1]
    assert abs(summary["clock_offsets_s"]["1"] - 2.0) < 1e-6
    with open(out) as f:
        trace = json.load(f)
    assert {"X", "M", "s", "f"} <= {e.get("ph") for e in trace["traceEvents"]}
    jout = str(tmp_path / "jax_trace.json")
    assert jtrace.main([d0, str(tmp_path / "rank1"), "-o", jout,
                        "--json"]) == 0
    capsys.readouterr()
    with open(jout) as f:
        assert json.load(f) == trace
    # original rank names: the probe's observer/peer are names too
    assert trace_lib.main([d0, str(tmp_path / "rank1"), "-o", out,
                           "--rank-names", "4,5"]) == 0
    text = capsys.readouterr().out
    assert "world trace:" in text and "ranks [4, 5]" in text


def test_trace_cli_refuses_empty_inputs(tmp_path, capsys):
    d = tmp_path / "empty"
    d.mkdir()
    (d / "events.jsonl").write_text("")
    assert trace_lib.main([str(d)]) == 2
    assert trace_lib.main([]) == 2
    assert trace_lib.main([str(d), "-o"]) == 2
    capsys.readouterr()


def test_doctor_cli_reports_cross_rank_flow(tmp_path, capsys):
    d0, d1 = _write_doctor_world(tmp_path, latency_s=4.0)
    assert doctor.main([d0, d1, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["world_trace"] == trace_lib.summarize(
        jtrace.merge_roots([d0, d1]))
    f = next(f for f in rep["findings"] if f["rule"] == "cross-rank-flow")
    assert f["evidence"]["longest_edge"]["kind"] == "publish"
    assert f["evidence"]["longest_edge"]["latency_s"] == pytest.approx(
        4.0, abs=0.01)
    assert doctor.main([d0, d1, "--json", "--fail-on", "warn"]) == 1
    capsys.readouterr()
    assert doctor.main([d0, d1, "--json", "--fail-on", "critical"]) == 0
    capsys.readouterr()


def test_doctor_cli_quiet_without_trace_records(tmp_path, capsys):
    d0, _ = _write_doctor_world(tmp_path, latency_s=0.0)
    p = os.path.join(d0, "events.jsonl")
    lines = [ln for ln in open(p) if "trace.flow" not in ln]
    open(p, "w").writelines(lines)
    assert doctor.main([d0, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert "world_trace" not in rep
    assert {r["rule"]: r["status"] for r in rep["rules"]}[
        "cross-rank-flow"] == "no-data"


# ---------------------------------------------------------------------------
# attribution, fields, registry
# ---------------------------------------------------------------------------

def test_attribute_flow_edges_names_longest():
    edges = [
        {"kind": "exchange", "key": "p1.s0", "src_rank": 0, "dst_rank": 1,
         "latency_s": 0.2},
        {"kind": "publish", "key": "v3", "src_rank": 0, "dst_rank": 2,
         "latency_s": 3.0},
        {"kind": "exchange", "key": "p1.s1", "src_rank": 1, "dst_rank": 0,
         "latency_s": -0.01}]
    fa = cp_lib.attribute_flow_edges(edges, wall_seconds_mean=10.0)
    assert fa == jcp.attribute_flow_edges(edges, wall_seconds_mean=10.0)
    assert fa["longest"]["kind"] == "publish"
    assert fa["longest_share_of_wall"] == pytest.approx(0.3)
    assert fa["negative_edges"] == 1
    assert cp_lib.attribute_flow_edges([]) == {
        "edges": 0, "longest": None, "by_kind": {}}


@pytest.mark.parametrize("wire,storage", [("f32", "f32"), ("bf16", "f32"),
                                          ("int8", "int8")])
def test_exchange_flow_fields_shape(wire, storage):
    f = exchange.flow_fields(EmbeddingConfig(dim=8, storage=storage), wire,
                             128)
    assert f == jexchange.flow_fields(JaxCfg(dim=8, storage=storage), wire,
                                      128)
    assert f["wire"] == wire and f["tokens"] == 128
    assert isinstance(f["bytes_bound"], int) and f["bytes_bound"] > 0


def test_event_name_registry_is_closed_and_consistent():
    assert names.EVENT_NAMES == jnames.EVENT_NAMES
    assert names.SPAN_NAMES == jnames.SPAN_NAMES
    assert set(EVIDENCE_EVENTS) <= set(names.EVENT_NAMES)
    for n in ("trace.flow", "trace.clock_probe", "trace.device_capture",
              "doctor.finding", "remediation_applied", "world_grow"):
        assert names.is_registered(n)
    for n in ("serve/wait", "serve/score", "publish", "push_apply"):
        assert n in names.SPAN_NAMES


def test_ensure_service_never_clobbers_a_training_process():
    flags.set("trace", True)
    flags.set("trace_sample_passes", 2)
    h = monitor.hub()
    h.enable(monitor.MemorySink())
    h.begin_pass(1)
    assert not trace_lib.active()
    assert trace_lib.ensure_service("serving") is False
    h.end_pass()
    assert trace_lib.ensure_service("serving") is False
    trace_lib._SAW_PASS = False
    assert trace_lib.ensure_service("serving") is True
    assert trace_lib.trace_id() == "run:serving"


def test_flow_propagated_pairs_under_producer_run():
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    flags.set("trace", True)
    flags.set("trace_run_id", "jobA")
    h.begin_pass(5)
    trace_lib.flow("publish", "v7", role="src")
    h.end_pass()
    flags.set("trace", False)
    trace_lib._SAW_PASS = False
    trace_lib.flow_propagated("publish", "v7", "dst",
                              {"trace_id": "jobA:5", "span_id": "s-9"},
                              swap_pause_ms=0.1)
    trace_lib.flow_propagated("publish", "v8", "dst", None)
    h.disable()
    assert len([r for r in ms.records if r.get("name") == "trace.flow"]) == 2
    stream = trace_lib.records_to_stream(ms.records)
    assert stream == jtrace.records_to_stream(ms.records)
    merged = trace_lib.merge_streams([stream], [0])
    assert merged == jtrace.merge_streams([stream], [0])
    edges = [e for e in trace_lib.summarize(merged)["flow_edges"]
             if e["kind"] == "publish"]
    assert len(edges) == 1 and edges[0]["fields"]["parent_span_id"] == "s-9"


def test_ntp_offset_math():
    t0 = 100.0
    t1 = (t0 + 0.1) + 3.0
    t2 = t1 + 0.05
    t3 = (t2 - 3.0) + 0.1
    off, rtt = trace_lib.ntp_offset(t0, t1, t2, t3)
    assert (off, rtt) == jtrace.ntp_offset(t0, t1, t2, t3)
    assert off == pytest.approx(3.0, abs=1e-9)
    assert rtt == pytest.approx(0.2, abs=1e-9)


# ---------------------------------------------------------------------------
# the per-pass device capture
# ---------------------------------------------------------------------------

def test_device_capture_is_a_no_op_for_a_cpu_trainer(tmp_path):
    """trace_device with a CPU trainer: the pass runs traced, no capture
    starts, nothing is counted as an error."""
    from tests.test_torch_resume import _dataset, _make
    flags.set("trace", True)
    flags.set("trace_device", True)
    flags.set("trace_device_dir", str(tmp_path / "dev"))
    errs0 = STATS.get("trace.device_capture_errors")
    _, tr, box = _make("port", carry=False)
    assert trace_lib._capture_device == "cpu"
    ms = monitor.MemorySink()
    monitor.hub().enable(ms)
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    fr = box.end_pass(trainer=tr)["flight_record"]
    assert fr["trace_id"] == "run:1"
    assert not ms.find("trace.device_capture")
    assert not os.path.exists(tmp_path / "dev")
    assert STATS.get("trace.device_capture_errors") == errs0


def test_device_capture_failure_is_counted_not_raised(tmp_path,
                                                      monkeypatch):
    """A capture that cannot start (here: the card is named but absent)
    is counted in trace.device_capture_errors; the pass goes on."""
    flags.set("trace", True)
    flags.set("trace_device", True)
    flags.set("trace_device_dir", str(tmp_path / "dev"))
    monkeypatch.setattr(trace_lib, "_capture_device", "cuda")
    if torch.cuda.is_available():
        pytest.skip("the card is present: the capture would start")
    errs0 = STATS.get("trace.device_capture_errors")
    h = monitor.hub()
    h.enable(monitor.MemorySink())
    h.begin_pass(7)
    assert trace_lib.active() and trace_lib._device_dir is None
    rec = h.end_pass()
    assert rec["pass_id"] == 7
    assert STATS.get("trace.device_capture_errors") == errs0 + 1


def test_device_capture_window_on_the_host(tmp_path, monkeypatch):
    """The capture's window mechanics with torch.profiler on the host
    (CPU activity): started at begin_pass, written at end_pass under
    trace_device_dir/pass-NNNNN/trace.json, announced by two
    trace.device_capture events."""
    from paddlebox_tpu_torch.utils import profiler
    flags.set("trace", True)
    flags.set("trace_device", True)
    flags.set("trace_device_dir", str(tmp_path / "dev"))
    monkeypatch.setattr(trace_lib, "_capture_on_card", lambda: True)
    start = profiler.start_device_trace
    monkeypatch.setattr(profiler, "start_device_trace",
                        lambda logdir, device=None: start(logdir, "cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    ms = monitor.MemorySink()
    h = monitor.hub()
    h.enable(ms)
    h.begin_pass(12)
    with monitor.span("train_step"):
        torch.ones(64).sum()
    h.end_pass()
    path = trace_lib.last_device_trace
    assert path == str(tmp_path / "dev" / "pass-00012" / "trace.json")
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    states = [e["fields"]["state"] for e in ms.find("trace.device_capture")]
    assert states == ["started", "stopped"]


def test_sharded_steps_stamp_one_exchange_arrow_each(tmp_path):
    """Two gloo ranks train one traced pass on the sharded layout: every
    step's all-to-all is one exchange arrow in the merged trace (both
    packages' mergers agree), labelled with the wire and its byte
    bound."""
    from tests.torch_multirank_spawn import run_world
    infos, _ = run_world(str(tmp_path), 2, ["trace"])
    steps = infos[0]["trace_steps"]
    assert steps > 0 and infos[0]["trace_layout"] == "sharded"
    assert not any(i["jax_loaded"] for i in infos)
    roots = [str(tmp_path / f"rank{r}") for r in range(2)]
    summary = trace_lib.summarize(_merge_both(roots))
    edges = [e for e in summary["flow_edges"] if e["kind"] == "exchange"]
    assert len(edges) == steps
    assert len({e["key"] for e in edges}) == steps
    for e in edges:
        assert {e["src_rank"], e["dst_rank"]} == {0, 1}
        assert e["fields"]["wire"] == "f32"
        assert e["fields"]["bytes_bound"] > 0
    assert all(e["key"].startswith("p1.s") for e in edges)

