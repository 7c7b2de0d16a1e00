"""What every cell shares: finding a cell's files by name, the device
check, the no-JAX check, the profiler's reduction and the result line.

A cell is ``<config>.<mix>``: ``configs/<config>.json`` holds the model's
sizes, its ``family`` (``families/<family>.py`` builds the program's model
and counts its FLOPs, ``reference/<family>.py`` is its plain forward) and
its optional ``hotness``; ``traffic/<mix>.json`` names the loop that runs
it (``drivers/<loop>.py``) and its parameters, and each per-layer metric
is read by ``metrics/<metric>.py``. Nothing here names a cell, a
configuration, a family or a metric, so a later change adds a cell by
adding files and entries.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "paddlebox_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result: it exits non-zero."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, bench: dict | None = None) -> dict:
    """``configs/<name>.json``, the one place a configuration is found;
    a ``bench`` (BENCHMARK.json) that lists it must name that file."""
    path = os.path.join(HERE, "configs", f"{name}.json")
    for c in (bench or {}).get("configs", []):
        if c["name"] == name and \
                os.path.abspath(os.path.join(ROOT, c["file"])) != path:
            raise BenchError(f"BENCHMARK.json's file for {name!r} is "
                             f"{c['file']!r}, not configs/{name}.json")
    if not os.path.exists(path):
        raise BenchError(f"no configuration {name!r}")
    return load_json(path)


def mix(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def by_name(workload: str) -> tuple[dict, dict]:
    """(configuration, mix) of ``<config>.<mix>``, for the tools that read
    a cell BENCHMARK.json may not list yet."""
    config_name, mix_name = workload.split(".", 1)
    return config(config_name), mix(mix_name)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the harness; a name may hold dots."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise BenchError(f"no {kind} file {name!r}: "
                         f"portbench/{kind}/{name}.py is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hotness(cfg: dict) -> list[int]:
    """Ids an example holds in each field: the configuration's
    ``hotness``, or 1 in every field."""
    hot = [int(h) for h in cfg.get("hotness", [1] * cfg["num_sparse"])]
    if len(hot) != cfg["num_sparse"] or min(hot) < 1:
        raise BenchError(f"hotness {hot} is not one count of 1 or more "
                         f"for each of the {cfg['num_sparse']} fields")
    return hot


def limits(workload: str) -> dict:
    """The cell's limit on each number that decides ``correct``."""
    return load_json(os.path.join(HERE, "limits", f"{workload}.json"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose whole top-level name is forbidden:
    ``paddlebox_tpu_torch`` is not ``paddlebox_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """One run's inputs, handed to the cell's loop."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict
    mix: dict
    device: object          # torch.device
    t0: float               # time.perf_counter() at process start
    scratch: str            # a directory under TMPDIR, removed after


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ok when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, nearest rank; inf
    counts as a miss of every latency."""
    v = sorted(values)
    if not v:
        return float("nan")
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return v[k]


# ---------------------------------------------------------------------------
# the profiler's reduction
# ---------------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation")
LABEL = "portbench/"          # the loops' own record_function ranges


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_at(labels, ops, starts, t):
    """What the host was doing at time t: the loop's label around t and
    the shortest host op around t on any thread (searched among the 400
    ops that start last before t)."""
    here = [e for e in labels if e["ts"] <= t <= e["ts"] + e["dur"]]
    if not here:
        return "outside: python"
    lab = here[-1]
    best = None
    i = bisect.bisect_right(starts, t)
    for e in ops[max(0, i - 400):i]:
        if t <= e["ts"] + e["dur"] and (best is None
                                        or e["dur"] < best["dur"]):
            best = e
    op = best["name"] if best is not None else "python"
    return f"{lab['name'][len(LABEL):]}: {op}"


def reduce_trace(path: str, window_s: float) -> dict:
    """busy_s (the union of device operations' intervals), device_ops
    (seconds by operation name, top 10) and idle_gaps (the device's idle
    seconds by what the host was doing, top 10) of a chrome trace that
    torch.profiler wrote over a window of ``window_s`` seconds."""
    events = load_json(path)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            dev.append(e)
        elif cat in _HOST_CATS:
            host.append(e)
    busy = _merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_op: dict[str, float] = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] / 1e6
    gaps: dict[str, float] = {}
    labels = sorted((h for h in host if h["name"].startswith(LABEL)),
                    key=lambda h: h["ts"])
    ops = sorted((h for h in host if not h["name"].startswith(LABEL)),
                 key=lambda h: h["ts"])
    starts = [h["ts"] for h in ops]
    if busy and labels:
        t_end = max(h["ts"] + h["dur"] for h in labels)
        edges = [[labels[0]["ts"]] * 2] + busy + [[t_end] * 2]
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b - a > 50:          # gaps under 50 us are launch spacing
                name = _host_at(labels, ops, starts, (a + b) / 2)
                gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": window_s,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in idle]}


class DeviceProfile:
    """torch.profiler over a slice of a window, reduced after it.
    ``name``: a loop's label held open over the whole slice."""

    def __init__(self, scratch: str, name: str | None = None):
        self.path = os.path.join(scratch, "trace.json")
        self.name = name
        self.result: dict | None = None
        self.running = False
        self._prof = self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        if self.name is not None:
            self._range = label(self.name)
            self._range.__enter__()
        self.running = True
        self._t = time.perf_counter()

    def stop(self) -> None:
        import torch
        if self._range is not None:
            self._range.__exit__(None, None, None)
        torch.cuda.synchronize()
        self._window_s = time.perf_counter() - self._t
        self._prof.stop()
        self.running = False

    def reduce(self) -> dict | None:
        """Export and reduce the trace (seconds of work: after the
        window); None when the slice never started."""
        if self._prof is None:
            return None
        if self.running:
            self.stop()
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.result = reduce_trace(self.path, self._window_s)
        os.remove(self.path)
        return self.result


def label(name: str):
    """A record_function range the profiler's reduction names gaps by."""
    import torch
    return torch.profiler.record_function(LABEL + name)
