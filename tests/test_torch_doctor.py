"""The port's run doctor, critical path and aggregation
(``paddlebox_tpu_torch.monitor.{doctor,critical_path,aggregate}``) against
the JAX package's: the counterparts of tests/test_doctor.py's cases
(every rule's fire and quiet fixture, quarantine, the push-floor
suggestion, severity order, the serving-staleness reconstructions, the
2-rank aggregation golden with straggler naming, remote roots, rotated
segments, live mode, BoxPS's findings and the CLI with --json,
--rank-names and --fail-on), each held to the reference: both packages'
``diagnose`` give the same rule, status, severity and evidence, and both
``aggregate`` / ``attribute_records`` the same world view, over the same
records and over streams written once by the JAX hub and once by the
port's.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from paddlebox_tpu import monitor as jmon
from paddlebox_tpu.monitor import aggregate as jagg
from paddlebox_tpu.monitor import critical_path as jcp
from paddlebox_tpu.monitor import doctor as jdoctor

from paddlebox_tpu_torch import monitor
from paddlebox_tpu_torch.config import flags, set_flags
from paddlebox_tpu_torch.monitor import aggregate as agg_lib
from paddlebox_tpu_torch.monitor import critical_path as cp_lib
from paddlebox_tpu_torch.monitor import doctor, flight
from paddlebox_tpu_torch.monitor.registry import STATS
from paddlebox_tpu_torch.utils import faultpoint

from tests.test_doctor import (RULE_FIXTURES, _golden_world, _write_stream,
                               make_flight, make_serving_window)
from tests.test_torch_resume import _dataset, _make

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_hubs():
    for h in (monitor.hub(), jmon.hub()):
        h.disable()
        h.abort_pass(reason="test setup")
    yield
    faultpoint.disarm()
    for h in (monitor.hub(), jmon.hub()):
        h.abort_pass(reason="test teardown")
        h.disable()


def _verdicts(rep: dict) -> dict:
    """rule -> (status, severity, evidence): what the two packages'
    reports must agree on (suggestion texts name each package's knobs)."""
    findings = {f["rule"]: f for f in rep["findings"]}
    out = {}
    for r in rep["rules"]:
        f = findings.get(r["rule"])
        out[r["rule"]] = (r["status"], f and f["severity"],
                          f and json.loads(json.dumps(f["evidence"],
                                                      default=str)))
    return out


def _both(**kw) -> tuple[dict, dict]:
    return doctor.diagnose(**kw), jdoctor.diagnose(**kw)


# ---------------------------------------------------------------------------
# the rules, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule_cls", doctor.ALL_RULES,
                         ids=[r.id for r in doctor.ALL_RULES])
def test_every_rule_fires_and_stays_quiet(rule_cls):
    assert [r.id for r in doctor.ALL_RULES] == \
        [r.id for r in jdoctor.ALL_RULES]
    assert rule_cls.incident
    fire_kw, quiet_kw = RULE_FIXTURES[rule_cls.id]
    for kw, want in ((fire_kw, "fired"), (quiet_kw, "quiet")):
        rep, jrep = _both(**kw)
        assert doctor.validate_report(rep) == []
        assert jdoctor.validate_report(rep) == []
        assert _verdicts(rep) == _verdicts(jrep)
        assert _verdicts(rep)[rule_cls.id][0] == want
        assert rep["verdict"] == jrep["verdict"]
        assert rep["critical_path"] == jrep["critical_path"]
    f = next(f for f in doctor.diagnose(**fire_kw)["findings"]
             if f["rule"] == rule_cls.id)
    assert f["summary"] and f["suggestion"] and f["evidence"]


def test_quarantined_rule_downgrades_to_info_and_is_surfaced():
    kw = dict(RULE_FIXTURES["boundary-wall"][0],
              quarantined_rules={"boundary-wall"})
    rep, jrep = _both(**kw)
    assert rep["quarantined_rules"] == jrep["quarantined_rules"] == [
        "boundary-wall"]
    f = next(f for f in rep["findings"] if f["rule"] == "boundary-wall")
    assert f["severity"] == "info"
    assert f["suggestion"].startswith("suggestion suppressed")
    assert _verdicts(rep) == _verdicts(jrep)
    assert doctor.validate_report(rep) == []


def test_push_floor_suggestion_names_concrete_engine():
    """The port's suggestion names its own engines and knobs — never the
    TPU's flags.pack_engine, which the port does not have."""
    rep = doctor.diagnose(**RULE_FIXTURES["push-floor"][0])
    f = next(f for f in rep["findings"] if f["rule"] == "push-floor")
    assert "flags.push_engine='scatter_accumulate'" in f["suggestion"]
    assert "premerged" in f["suggestion"]
    assert "flags.binned_push" in f["suggestion"]
    assert "pack_engine" not in f["suggestion"]
    assert f["evidence"]["engine_floors"]["scatter_accumulate"] == 0.0004
    fire = dict(detail={"push_engine": "scatter_accumulate",
                        "push_floor": {
                            "engine": "scatter_accumulate",
                            "floor_seconds": 0.001,
                            "measured_push_seconds": 0.02,
                            "closed": "measured 20.00ms > 3x floor 1.00ms",
                            "engines": {"scatter_accumulate":
                                        {"floor_seconds": 0.001,
                                         "closed": "measured ..."}},
                            "best_engine": "scatter_accumulate"}})
    rep2, jrep2 = _both(**fire)
    f2 = next(f for f in rep2["findings"] if f["rule"] == "push-floor")
    assert "lowest-floor engine" in f2["suggestion"]
    assert "pack_engine" not in f2["suggestion"]
    assert _verdicts(rep2) == _verdicts(jrep2)


def test_doctor_report_verdict_and_severity_order():
    fire = dict(RULE_FIXTURES["boundary-wall"][0])
    fire["evidence"] = RULE_FIXTURES["heartbeat-gap"][0]["evidence"]
    fire["counters"] = RULE_FIXTURES["heartbeat-gap"][0]["counters"]
    rep, jrep = _both(**fire)
    assert [f["rule"] for f in rep["findings"]] == \
        [f["rule"] for f in jrep["findings"]]
    assert rep["findings"][0]["rule"] == "heartbeat-gap"
    assert rep["verdict"] == "findings:2"


@pytest.mark.parametrize("case", ["no_double_count", "gradual_gauge"])
def test_serving_staleness_reconstructions(case):
    if case == "no_double_count":
        kw = dict(flights=[make_flight(
            1, stats={"serving.publishes": 1,
                      "serving.publish_failures": 1})],
            counters={"serving.publishes": 1,
                      "serving.publish_failures": 1})
        key, want = "publish_failures", 1
    else:
        kw = dict(flights=[make_flight(p, stats={"serving.publishes": 1,
                                                 "serving.pass_lag": 1.0})
                           for p in range(1, 5)])
        key, want = "pass_lag", 4.0
    rep, jrep = _both(**kw)
    f = next(f for f in rep["findings"]
             if f["rule"] == "serving-staleness")
    assert f["evidence"][key] == want
    assert _verdicts(rep) == _verdicts(jrep)


def test_record_train_accumulates_boundary_across_phases():
    h = monitor.hub()
    h.begin_pass(41)
    for b, split in ((40.0, (30.0, 10.0)), (0.2, (0.1, 0.1))):
        h.record_train(steps=1, examples=8, seconds=1.0,
                       boundary_seconds=b,
                       boundary_split={"build": split[0], "h2d": split[1],
                                       "spill_fault_in": 0.0})
    rec = h.end_pass()
    assert rec["extra"]["boundary_seconds"] == pytest.approx(40.2)
    assert cp_lib.attribute_pass(rec) == jcp.attribute_pass(rec)
    assert flight.validate_flight_record(rec) == []


def test_rule_verdicts_are_rank_order_independent():
    healthy = [make_flight(1, stats={"spill.cache_hits": 900,
                                     "spill.cache_misses": 100}),
               make_flight(2, stats={"spill.cache_hits": 900,
                                     "spill.cache_misses": 100})]
    collapsed = [make_flight(1, stats={"spill.cache_hits": 900,
                                       "spill.cache_misses": 100}),
                 make_flight(2, stats={"spill.cache_hits": 100,
                                       "spill.cache_misses": 900,
                                       "tiering.admitted": 500,
                                       "tiering.evicted": 490})]
    verdicts = set()
    for order in (healthy + collapsed, collapsed + healthy):
        rep, jrep = _both(flights=order)
        assert _verdicts(rep) == _verdicts(jrep)
        verdicts.add(_verdicts(rep)["spill-thrash"][0])
    assert len(verdicts) == 1


@pytest.mark.parametrize("rule,kw,want", [
    ("heartbeat-gap", dict(flights=[make_flight(1)]), "no-data"),
    ("sink-health", dict(counters={"monitor.sink_errors": 3},
                         sink_health=[{"type": "JsonlSink",
                                       "state": "attached", "strikes": 0,
                                       "dropped": 0, "written": 10}]),
     "quiet"),
])
def test_no_data_and_latch_contracts(rule, kw, want):
    rep, jrep = _both(**kw)
    assert _verdicts(rep)[rule][0] == want
    assert _verdicts(rep) == _verdicts(jrep)


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------

def test_attribution_limiter_trend_and_headroom():
    flights = [make_flight(1, seconds=10.0, train=6.0, boundary=2.0),
               make_flight(2, seconds=10.0, train=4.0, boundary=5.0)]
    out = cp_lib.attribute_records(flights)
    assert out == jcp.attribute_records(flights)
    p1, p2 = out["passes"]
    assert p1["limiter"] == "train" and p2["limiter"] == "boundary"
    assert p2["overlap_headroom_seconds"] == 4.0
    assert out["summary"]["boundary_share_trend"] == "rising"
    assert "translate" in p1["overlapped"]


def test_attribution_over_merged_ranks_is_order_independent():
    fast = make_flight(1, seconds=8.0, train=5.0)
    slow = make_flight(1, seconds=14.0, train=10.0)
    for order in ([fast, slow], [slow, fast]):
        out = cp_lib.attribute_records(order)
        assert out == jcp.attribute_records(order)
        assert out["passes"][0]["wall_seconds"] == 14.0


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def test_two_rank_aggregation_golden(tmp_path):
    roots = _golden_world(tmp_path)
    world = agg_lib.aggregate(roots)
    assert world == jagg.aggregate(roots)
    p1, p2 = world["passes"]
    assert p1["straggler"] == 1 and p2["missing_ranks"] == [1]
    assert world["counters"]["exchange.pull_bytes"] == 4000 + 4100 + 9000


def test_world_view_reads_push_bytes_counter(tmp_path):
    r0 = make_flight(1, stats={"exchange.tokens": 100,
                               "exchange.push_bytes": 1000})
    r1 = make_flight(1, seconds=12.0, stats={"exchange.tokens": 100,
                                             "exchange.push_bytes": 9000})
    _write_stream(str(tmp_path / "rank0"), [r0])
    _write_stream(str(tmp_path / "rank1"), [r1])
    roots = [str(tmp_path / "rank0"), str(tmp_path / "rank1")]
    world = agg_lib.aggregate(roots)
    assert world == jagg.aggregate(roots)
    assert world["passes"][0]["exchange"]["push_bytes"]["max_rank"] == 1


def test_aggregation_rank_names_follow_heartbeat_naming(tmp_path):
    roots = _golden_world(tmp_path, names=("a", "b"))
    world = agg_lib.aggregate(roots, rank_names=[4, 7])
    assert world == jagg.aggregate(roots, rank_names=[4, 7])
    assert world["passes"][0]["straggler"] == 7
    assert agg_lib.rank_label("x/rank3", 0) == 3
    assert agg_lib.rank_label("x/a", 5) == 5


def test_doctor_over_world_names_straggler(tmp_path):
    roots = _golden_world(tmp_path)
    world = agg_lib.aggregate(roots)
    kw = dict(flights=world["flight_records"], counters=world["counters"],
              evidence=world["evidence"], world=world)
    rep, jrep = _both(**kw)
    assert doctor.validate_report(rep) == []
    assert rep["world"] == jrep["world"]
    assert rep["world"]["world_size"] == 2


def test_aggregation_reads_remote_roots(tmp_path):
    """A remote telemetry root read through the port's utils.fs (a
    registered command-line filesystem)."""
    from tests.test_torch_fs import register_port_mockfs
    root = tmp_path / "mock_root"
    (root / "rank0").mkdir(parents=True)
    _write_stream(str(root / "rank0"), [make_flight(1), make_flight(2)])
    register_port_mockfs(str(root), "mockpdoc")
    st = agg_lib.read_stream("mockpdoc://rank0")
    assert len(st["flight_records"]) == 2
    world = agg_lib.aggregate(["mockpdoc://rank0"])
    assert [p["pass_id"] for p in world["passes"]] == [1, 2]
    local = agg_lib.aggregate([str(root / "rank0")])
    assert world["passes"] == local["passes"]


def test_jsonl_rotation_segments_read_in_order(tmp_path):
    """The port's JsonlSink rotates; both packages' aggregators stitch
    the segments back in write order and see every event once."""
    path = str(tmp_path / "events.jsonl")
    sink = monitor.JsonlSink(path, rotate_mb=0.01)
    h = monitor.hub()
    h.enable(sink)
    try:
        h.begin_pass(1)
        for i in range(120):
            monitor.event("tick", i=i, pad="x" * 200)
        h.end_pass()
    finally:
        h.disable()
    assert sink.rotations >= 2
    files = agg_lib.discover_stream_files(str(tmp_path))
    assert files == sink.segments == jagg.discover_stream_files(
        str(tmp_path))
    assert agg_lib.order_segments(list(reversed(files))) == files
    st, jst = agg_lib.read_stream(str(tmp_path)), jagg.read_stream(
        str(tmp_path))
    assert st == jst
    assert st["events"] >= 120 and len(st["flight_records"]) == 1
    assert st["errors"] == []


# ---------------------------------------------------------------------------
# streams written by either package's hub, read by both
# ---------------------------------------------------------------------------

def _write_hub_stream(mon, d: str) -> str:
    """Three passes through one package's hub into a JsonlSink: a pass
    boundary heavy enough to fire boundary-wall, fresh rows with no
    reuse (the reuse-off arm), a nan trip in pass 3."""
    h = mon.hub()
    h.enable(mon.JsonlSink(os.path.join(d, "events.jsonl")))
    try:
        for p, b in ((1, 0.5), (2, 4.0), (3, 6.0)):
            h.begin_pass(p)
            mon.counter_add("feed_pass.fresh_rows", 1000)
            mon.counter_add("trainer.plan_tokens", 2000)
            mon.counter_add("trainer.plan_unique_tokens", 1500 - 300 * p)
            if p == 3:
                mon.counter_add("trainer.nan_trips", 1)
                mon.event("nan_guard", n_bad=1, paths=["loss"])
            h.record_train(stage_seconds={"read": 0.1, "train": 2.0,
                                          "auc": 0.1, "drain": 0.05},
                           steps=8, examples=512, seconds=2.5,
                           boundary_seconds=b,
                           boundary_split={"build": b * 0.7,
                                           "h2d": b * 0.3,
                                           "spill_fault_in": 0.0})
            h.end_pass()
    finally:
        h.disable()
    return d


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_readers_agree_on_either_writers_stream(tmp_path, writer):
    mon = jmon if writer == "jax" else monitor
    d = _write_hub_stream(mon, str(tmp_path / "rank0"))
    world, jworld = agg_lib.aggregate([d]), jagg.aggregate([d])
    # the per-record wall clocks differ run to run but not between readers
    assert world == jworld
    assert world["ranks"][0]["error_count"] == 0
    flights = world["flight_records"]
    assert cp_lib.attribute_records(flights) == \
        jcp.attribute_records(flights)
    kw = dict(flights=flights, counters=world["counters"],
              evidence=world["evidence"])
    rep, jrep = _both(**kw)
    v = _verdicts(rep)
    assert v == _verdicts(jrep)
    for rule in ("boundary-wall", "nan-guard", "dedup-drift"):
        assert v[rule][0] == "fired", (rule, v[rule])
    bw = v["boundary-wall"][2]
    assert bw["reused_rows"] == 0 and bw["fresh_rows"] == 3000


# ---------------------------------------------------------------------------
# live mode
# ---------------------------------------------------------------------------

def test_doctor_live_emits_findings_at_end_pass(monkeypatch):
    h = monitor.hub()
    ms = monitor.MemorySink()
    h.enable(ms)
    before = STATS.get("doctor.findings")
    monkeypatch.setattr(flags, "doctor_live", True)
    h.begin_pass(31)
    h.record_train(steps=1, examples=8, seconds=0.01, boundary_seconds=5.0,
                   boundary_split={"build": 3.0, "h2d": 2.0,
                                   "spill_fault_in": 0.0})
    h.end_pass()
    findings = h.last_doctor_findings
    assert any(f["rule"] == "boundary-wall" for f in findings)
    bw = next(e for e in ms.find("doctor.finding")
              if e["fields"]["rule"] == "boundary-wall")
    assert bw["pass_id"] == 31 and bw["fields"]["suggestion"]
    assert flight.validate_event(bw) == []
    assert STATS.get("doctor.findings") > before


def test_live_doctor_failure_is_counted_not_raised(monkeypatch):
    def broken(hub):
        raise RuntimeError("rule set broke")
    monkeypatch.setattr(flags, "doctor_live", True)
    monkeypatch.setattr(doctor, "run_live", broken)
    before = STATS.get("doctor.errors")
    h = monitor.hub()
    h.begin_pass(5)
    rec = h.end_pass()
    assert rec["pass_id"] == 5
    assert h.last_doctor_findings is None
    assert STATS.get("doctor.errors") == before + 1


def test_boxps_end_pass_returns_doctor_findings(monkeypatch):
    """A trainer pass under BoxPS with the live doctor on: the findings
    come back under end_pass()["doctor"], as the reference's do."""
    monkeypatch.setattr(flags, "doctor_live", True)
    store, tr, box = _make("port", carry=False)
    h = monitor.hub()
    h.begin_pass(90)                 # a boundary-heavy earlier pass
    h.record_train(steps=1, examples=8, seconds=0.01, boundary_seconds=5.0)
    h.end_pass()
    box.begin_pass()
    tr.train_pass(_dataset("port", tr, 1), metrics=box.metrics)
    out = box.end_pass(trainer=tr)
    assert h.last_doctor_findings
    assert out["doctor"] == h.last_doctor_findings
    assert any(f["rule"] == "boundary-wall" for f in out["doctor"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_cli_json_over_synthetic_stream(tmp_path, capsys):
    _write_stream(str(tmp_path / "rank0"),
                  [make_flight(1, seconds=10.0, train=4.0, boundary=4.0),
                   make_flight(2, seconds=10.0, train=4.0, boundary=4.5)])
    rc, out = _cli(doctor, [str(tmp_path / "rank0"), "--json"], capsys)
    jrc, jout = _cli(jdoctor, [str(tmp_path / "rank0"), "--json"], capsys)
    assert rc == jrc == 0
    rep, jrep = json.loads(out), json.loads(jout)
    assert doctor.validate_report(rep) == []
    assert _verdicts(rep) == _verdicts(jrep)
    assert rep["critical_path"] == jrep["critical_path"]
    rc2, text = _cli(doctor, [str(tmp_path / "rank0")], capsys)
    assert rc2 == 0 and "boundary-wall" in text and "suggestion:" in text


def test_cli_two_rank_world(tmp_path, capsys):
    roots = _golden_world(tmp_path)
    argv = roots + ["--json", "--rank-names", "4,7"]
    rc, out = _cli(doctor, argv, capsys)
    _, jout = _cli(jdoctor, argv, capsys)
    assert rc == 0
    rep, jrep = json.loads(out), json.loads(jout)
    assert rep["world"] == jrep["world"]
    assert rep["world"]["ranks"] == [4, 7]
    assert rep["world"]["passes"][0]["straggler"] == 7


def test_cli_fail_on_gates_serving_rules_from_stream(tmp_path, capsys):
    bad = [make_flight(1), make_serving_window(
        100.0, versions={"1": {"role": "stable", "auc": 0.74},
                         "2": {"role": "candidate", "auc": 0.58}})]
    _write_stream(str(tmp_path / "bad"), bad)
    argv = [str(tmp_path / "bad"), "--json", "--fail-on", "warn"]
    rc, out = _cli(doctor, argv, capsys)
    jrc, _ = _cli(jdoctor, argv, capsys)
    assert rc == jrc == 1
    assert _verdicts(json.loads(out))["version-regression"][0] == "fired"
    good = [make_flight(1), make_serving_window(
        100.0, versions={"1": {"role": "stable", "auc": 0.74},
                         "2": {"role": "candidate", "auc": 0.74,
                               "score_kl": 0.02}})]
    _write_stream(str(tmp_path / "good"), good)
    assert _cli(doctor, [str(tmp_path / "good"), "--json", "--fail-on",
                         "warn"], capsys)[0] == 0
    assert _cli(doctor, ["--fail-on", "bogus", str(tmp_path / "good")],
                capsys)[0] == 2


def test_cli_refuses_empty_inputs(tmp_path, capsys):
    assert doctor.main([]) == 2
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert doctor.main([str(empty)]) == 2
    assert doctor.main([str(empty), "--rank-names", "x"]) == 2
    capsys.readouterr()


def test_cli_runs_as_a_module_without_jax(tmp_path):
    """``python -m paddlebox_tpu_torch.monitor.doctor`` in a process with
    jax and the JAX package blocked."""
    import subprocess
    import sys
    _write_stream(str(tmp_path / "rank0"),
                  [make_flight(1, seconds=10.0, train=4.0, boundary=4.0)])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "class B:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
            "                                  'paddlebox_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, B())\n"
            "import runpy\n"
            "sys.argv = ['doctor', sys.argv[1], '--json']\n"
            "runpy.run_module('paddlebox_tpu_torch.monitor.doctor',\n"
            "                 run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code,
                           str(tmp_path / "rank0")], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert any(f["rule"] == "boundary-wall" for f in rep["findings"])


def test_exchange_rules_name_adaptive_exchange_knobs():
    rep = doctor.diagnose(**RULE_FIXTURES["exchange-overflow"][0])
    f = next(f for f in rep["findings"] if f["rule"] == "exchange-overflow")
    assert "flags.exchange_topology='hier'" in f["suggestion"]
    rep = doctor.diagnose(**RULE_FIXTURES["dedup-drift"][0])
    f = next(f for f in rep["findings"] if f["rule"] == "dedup-drift")
    assert "flags.exchange_adaptive" in f["suggestion"]
    for name in ("exchange_topology", "exchange_adaptive", "push_engine",
                 "binned_push", "incremental_feed", "spill_cache_rows"):
        assert hasattr(flags, name), name


def test_set_flags_sets_several(monkeypatch):
    for k in ("doctor_live", "self_healing"):
        monkeypatch.setattr(flags, k, getattr(flags, k))
    set_flags(doctor_live=True, self_healing=True)
    assert flags.doctor_live and flags.self_healing
    with pytest.raises(KeyError):
        set_flags(no_such_flag=1)
