"""Spawning a world of port ranks for a test module (one world per
module fixture: a world takes a few seconds to start)."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


def run_world(workdir: str, world: int, phases: list, num_nodes: int = 1,
              recipes: list | None = None, timeout_s: float = 300.0,
              device: str = "cpu",
              worker: str = "torch_multirank_worker.py",
              extra: dict | None = None) -> tuple[list[dict], list[dict]]:
    """Launch ``world`` ranks of ``worker`` (tests/torch_multirank_worker.py
    by default; tests/torch_parallel_worker.py for the parallel modules,
    whose cases ride in ``extra``) through the port's launcher (on
    ``device``; "cuda": every rank on card 0); returns every rank's
    (json info, npz arrays)."""
    from paddlebox_tpu_torch.distributed.launch import launch

    spec = {"workdir": workdir, "num_nodes": num_nodes, "phases": phases,
            "recipes": recipes or [], "device": device, **(extra or {})}
    path = os.path.join(workdir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {"PBT_TEST_SPEC": path, "PYTHONPATH": REPO,
           "OMP_NUM_THREADS": "1"}
    code = launch(world, [sys.executable,
                          os.path.join(TESTS_DIR, worker)],
                  store_dir=os.path.join(workdir, "store"), base_env=env,
                  timeout_s=timeout_s,
                  local_ranks=[0] * world if device == "cuda" else None)
    if code != 0:
        raise RuntimeError(f"a rank of the world of {world} exited {code}")
    infos, arrays = [], []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            infos.append(json.load(f))
        with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
    return infos, arrays


def run_parallel_cases(workdir: str, world: int, cases: list,
                       timeout_s: float = 300.0,
                       device: str = "cpu") -> dict:
    """One world of tests/torch_parallel_worker.py over ``cases`` (a list
    of (case dict with a unique ``name`` and a ``kind``, inputs dict of
    arrays)) on ``device``; returns {name: [rank 0's arrays, rank 1's,
    ...]}."""
    os.makedirs(workdir, exist_ok=True)
    for case, inputs in cases:
        np.savez(os.path.join(workdir, f"{case['name']}.in.npz"), **inputs)
    infos, _ = run_world(workdir, world, [], timeout_s=timeout_s,
                         device=device, worker="torch_parallel_worker.py",
                         extra={"cases": [c for c, _ in cases]})
    assert not any(i["jax_loaded"] for i in infos)
    got = {}
    for case, _ in cases:
        ranks = []
        for r in range(world):
            path = os.path.join(workdir, f"{case['name']}.rank{r}.npz")
            with np.load(path) as z:
                ranks.append({k: z[k] for k in z.files})
        got[case["name"]] = ranks
    return got
