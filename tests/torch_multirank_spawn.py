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
              device: str = "cpu") -> tuple[list[dict], list[dict]]:
    """Launch ``world`` ranks of tests/torch_multirank_worker.py through
    the port's launcher (on ``device``; "cuda": every rank on card 0);
    returns every rank's (json info, npz arrays)."""
    from paddlebox_tpu_torch.distributed.launch import launch

    spec = {"workdir": workdir, "num_nodes": num_nodes, "phases": phases,
            "recipes": recipes or [], "device": device}
    path = os.path.join(workdir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {"PBT_TEST_SPEC": path, "PYTHONPATH": REPO,
           "OMP_NUM_THREADS": "1"}
    code = launch(world, [sys.executable,
                          os.path.join(TESTS_DIR,
                                       "torch_multirank_worker.py")],
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
