"""The readings that the limits on ``correct`` are set from, one JSON line
a seed: what the program gives against the reference, and what the
control gives, the reference put in the program's place in the nearest
precision below the configuration's (TF32 for float32 with TF32 off).

    python3 portbench/control.py --workload deepfm_criteo.train \\
        --seeds 11,12,13 [--program 1] [--precision tf32] [--fault NAME]

Training cells read the first steps at the cell's sizes (no window):
with ``--program 1`` the program's, always the control's. The serving
cell reads the control over as many requests as a run of
``--seconds`` serves; the program's serving readings are the runs' own
``checks``. ``--fault`` plants one of ``faults.py``'s faults in the
program first, for the faults' readings. Runs on one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from portbench import faults, harness  # noqa: E402
from portbench.drivers import serve, train  # noqa: E402
from portbench.reference import ctr  # noqa: E402
from portbench.traffic import criteo  # noqa: E402


def train_readings(cfg, mix, seed, dev, program: bool,
                   precision: str) -> dict:
    """The first steps' readings as a run of this seed takes them: the
    same parameters, probe batches and preload as its set-up."""
    if program:
        gen, params0, store, schema, tr, box = train.build(cfg, seed, dev)
    else:       # the same draws from the seed, without the program
        gen = torch.Generator(device=dev).manual_seed(seed)
        params0 = ctr.make_params(cfg, gen, dev)
    b = cfg["batch_size"]
    probe = criteo.draw_examples(gen, sum(mix["probe_passes"]) * b, cfg,
                                 dev)
    mine = None
    if program:
        after = criteo.unique_keys(criteo.draw_examples(
            gen, mix["pass_batches"] * b, cfg, dev)[0])
        mine = train.first_steps(tr, box, store, schema, cfg, mix, probe,
                                 params0, after)
        tr.feed_mgr.close()
        del tr, box, store
        torch.cuda.empty_cache()
    ref = train.reference_steps(cfg, mix, probe, params0)
    out = {"control": train.gaps(
        train.reference_steps(cfg, mix, probe, params0, precision), ref)}
    if mine is not None:
        out["program"] = train.gaps(mine, ref)
    return out


def serve_readings(cfg, mix, seed, dev, seconds: float,
                   precision: str) -> dict:
    """The control over the same requests, rows and parameters that a
    run of this seed draws, in the run's order."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params0 = ctr.make_params(cfg, gen, dev)
    tables = serve.make_tables(cfg, mix, gen, dev)
    rate = mix["rate_per_s"]
    n_warm = max(1, round(rate * mix["warmup_s"]))
    n = max(1, round(rate * seconds))
    serve.draw_requests(gen, n_warm, cfg, mix, dev)
    serve.arrivals(gen, n_warm, mix["warmup_s"], dev)
    keys, dense = serve.draw_requests(gen, n, cfg, mix, dev)
    want = serve.reference_scores(cfg, tables, params0, keys, dense, dev)
    low = serve.reference_scores(cfg, tables, params0, keys, dense, dev,
                                 precision)
    return {"control": {"score": float(np.abs(low - want).max())},
            "examples": len(keys)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--precision", default="tf32")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--fault", default=None,
                   help="plant one of faults.py's faults in the program")
    a = p.parse_args(argv)
    if a.fault:
        faults.install(a.fault)
    cfg, mix = harness.by_name(a.workload)
    dev = torch.device("cuda")
    seconds = a.seconds or harness.benchmark()["run_seconds"]
    for seed in (int(s) for s in a.seeds.split(",")):
        if mix["loop"] == "train":
            out = train_readings(cfg, mix, seed, dev, bool(a.program),
                                 a.precision)
        else:
            out = serve_readings(cfg, mix, seed, dev, seconds, a.precision)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "precision": a.precision, "fault": a.fault,
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
