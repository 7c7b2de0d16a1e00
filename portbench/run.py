"""The benchmark of paddlebox_tpu_torch, one cell a run.

    python3 portbench/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

From the root of a checkout holding the port and ``BENCHMARK.json``. The
run builds the cell's program and inputs from the seed, warms it up,
measures for ``--seconds`` (a training window runs to the end of the
pass in flight), checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; ``checks``, each number compared
beside its limit, comes last and is also printed last on standard
error. It exits non-zero, and prints no result, without a CUDA card for
each chip the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches stay inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, ".portbench_cache", _sub)
# one intra-op thread: the loop's own threads (main, pack, feed) are the
# run's load, with no OpenMP team spinning beside each of them on the
# host's shared cores (set before numpy or torch is loaded)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(argv, device: str = "cuda", bench: dict | None = None,
            cfg_override=None) -> dict:
    """One run; returns the result object. ``device="cpu"`` skips the
    look for a card (tests only: no device metric is read then);
    ``cfg_override(cfg, mix)`` shrinks a cell for such a test."""
    import torch
    args = parse(argv)
    bench = bench if bench is not None else harness.benchmark()
    cell = harness.cell(bench, args.workload)
    if device == "cuda":
        need = int(cell["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < need:
            raise harness.BenchError(
                f"{args.workload} needs {need} CUDA card(s); this machine "
                f"has {torch.cuda.device_count()}")
    cfg = harness.config(cell["config"], bench)
    mix = harness.mix(cell["traffic"])
    if cfg_override is not None:
        cfg, mix = cfg_override(cfg, mix)
    scratch = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = harness.Run(args.workload, args.seed, args.seconds,
                          bool(args.trace), cfg, mix, torch.device(device),
                          T0, scratch)
        out = harness.load_module("drivers", mix["loop"]).run(run)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if not harness.applies(m, args.workload):
                continue
            v = harness.load_module("metrics", m["name"]).read(out["layer"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if harness.applies(m, args.workload)}
    checks = out["checks"]
    result = {
        "correct": bool(checks) and all(c.ok for c in checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": int(cell["chips"]),
            "memory_peak_bytes": out["memory_peak_bytes"],
        },
    }
    prof = out["layer"].get("profile")
    if args.trace and prof:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def main(argv=None) -> int:
    try:
        result = execute(sys.argv[1:] if argv is None else argv)
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
