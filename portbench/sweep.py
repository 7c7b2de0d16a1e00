"""The serving cell's rate sweep, run once to find the knee: the highest
offered rate whose completions keep up with its arrivals. One set-up
(the serving loop's), then ``--seconds`` of open-loop page views at each
rate in turn, one JSON line a rate.

    python3 portbench/sweep.py --workload deepfm_criteo.serve \\
        --rates 200,300,400 --seconds 10 --seed 5

``drain_ms`` is how long after the last request was due the last one
finished; ``p99_late_ms`` / ``p99_early_ms`` are the p99 of the last and
the first quarter of the requests: a queue that grows through the window
shows as a drain far above a request's own time and a late quarter far
above the early one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from portbench import harness  # noqa: E402
from portbench.drivers import serve  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    cfg, mix = harness.by_name(a.workload)
    scratch = tempfile.mkdtemp(prefix="portbench-sweep-")
    try:
        r = harness.Run(a.workload, a.seed, a.seconds, False, cfg, mix,
                        torch.device("cuda"), time.perf_counter(), scratch)
        gen, _, _, srv, fe = serve.build(r)
        c = mix["candidates"]
        rates = [float(x) for x in a.rates.split(",")]
        # the run's own warm-up, at the first rate
        n = max(1, round(rates[0] * mix["warmup_s"]))
        warm = serve.OpenLoop(fe, *serve.draw_requests(gen, n, cfg, mix,
                                                       r.device), c)
        warm.run(time.perf_counter()
                 + serve.arrivals(gen, n, mix["warmup_s"], r.device))
        warm.wait(60.0)
        for rate in rates:
            n = max(4, round(rate * a.seconds))
            keys, dense = serve.draw_requests(gen, n, cfg, mix, r.device)
            due = serve.arrivals(gen, n, a.seconds, r.device)
            loop = serve.OpenLoop(fe, keys, dense, c)
            t0 = time.perf_counter()
            loop.run(t0 + due)
            loop.wait(120.0)
            lat = (loop.done - (t0 + due)) * 1e3
            q = n // 4
            print(json.dumps({
                "rate_per_s": rate, "requests": n,
                "unanswered": int(np.isnan(loop.done).sum()),
                "p50_ms": float(np.nanpercentile(lat, 50)),
                "p99_ms": float(np.nanpercentile(lat, 99)),
                "p99_early_ms": float(np.nanpercentile(lat[:q], 99)),
                "p99_late_ms": float(np.nanpercentile(lat[-q:], 99)),
                "drain_ms": float((np.nanmax(loop.done) - t0
                                   - due[-1]) * 1e3),
                "generator_late_ms": float(np.median(loop.late) * 1e3),
                "card": torch.cuda.get_device_name(0)}), flush=True)
            if not math.isfinite(float(np.nanmax(lat))):
                break
        fe.stop()
        srv.stop()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
