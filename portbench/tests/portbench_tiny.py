"""Tiny cells for the CPU tests: the shipped configurations and mixes
cut to sizes a test holds (batch 64, hidden widths of 32, 5000 keys a
field, passes of 4 batches)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# the serving cell as a later change would enter it in BENCHMARK.json (its
# runs on the card spread too widely for the bounds: PERF.md, Open
# questions); the CPU tests run it from this entry
SERVING = {
    "workload": {"name": "deepfm_criteo.serve", "config": "deepfm_criteo",
                 "traffic": "serve", "chips": 1,
                 "why": "open-loop page views of 128 ads at 4/5 of the knee"},
    "end_to_end": [
        {"name": "serve_p99_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["deepfm_criteo.serve"]},
        {"name": "serve_p50_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["deepfm_criteo.serve"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "serve_p99_ms",
         "workloads": ["deepfm_criteo.serve"]}
        for name, unit, better, source, layer in (
            ("serve_score_ms.serve", "ms", "lower", "program_span",
             "serving"),
            ("serve_batch_size.serve", "examples", "higher",
             "program_counter", "serving"),
            ("device_idle_share.serve", "share", "lower", "device_trace",
             "device"))],
}


def bench_for(workload: str, root: str = ROOT) -> dict:
    """BENCHMARK.json, with the serving cell's entries when it asks for
    that cell."""
    from portbench import harness
    bench = harness.benchmark(root)
    names = {w["name"] for w in bench["workloads"]}
    if workload == SERVING["workload"]["name"] and workload not in names:
        bench["workloads"].append(SERVING["workload"])
        bench["end_to_end"] += SERVING["end_to_end"]
        bench["per_layer"] += SERVING["per_layer"]
    return bench


# a multi-hot layout of the 26 fields, uneven (3, 1, 2, ...): 51 ids an
# example
UNEVEN = [3, 1, 2] * 8 + [1, 2]


def shrink(cfg: dict, mix: dict) -> tuple[dict, dict]:
    """The nets a configuration names cut to widths of 32 and 64 (a
    DLRM-shaped one's rows to 16 wide), whatever its family."""
    cfg = dict(cfg, batch_size=64,
               cardinalities=[min(c, 5000) for c in cfg["cardinalities"]])
    if "hidden" in cfg:
        cfg["hidden"] = [32, 32]
    if "bottom_hidden" in cfg:
        cfg.update(bottom_hidden=[32], top_hidden=[64, 32],
                   embedding_dim=16)
    mix = dict(mix)
    if mix["loop"] == "train":
        mix.update(pass_batches=4, max_examples_per_s=2000)
    else:
        mix.update(candidates=8, rate_per_s=20, table_rank_cap=500,
                   warmup_s=0.5)
    return cfg, mix


def run_cell(workload: str, seed: int = 3000000001, seconds: float = 1.0,
             trace: int = 0, root: str = ROOT, prelude: str = "",
             cfg: dict | None = None) -> dict:
    """One tiny run on the CPU in a fresh process, from ``root``; the
    result line parsed. ``prelude`` runs first (a planted fault);
    ``cfg``'s keys are set in the shrunk configuration (a ``hotness``)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        f"{prelude}\n"
        "from portbench import harness, run\n"
        "from portbench.tests.portbench_tiny import bench_for, shrink\n"
        "def override(c, m):\n"
        "    c, m = shrink(c, m)\n"
        f"    c.update(json.loads({json.dumps(cfg or {})!r}))\n"
        "    return c, m\n"
        f"res = run.execute(['--workload', {workload!r}, '--seed', "
        f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
        f"device='cpu', bench=bench_for({workload!r}, {root!r}), "
        "cfg_override=override)\n"
        "assert not harness.forbidden_modules(), harness.forbidden_modules()\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
