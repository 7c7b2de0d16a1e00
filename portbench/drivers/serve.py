"""The serving loop: page views of ``candidates`` ads, arriving open
loop as a Poisson process at ``rate_per_s``, each candidate submitted to
``BatchingFrontend(max_batch, max_wait_s)`` over a ``ServingServer``.

Set-up makes the dense parameters and, for each field, the rows of its
``table_rank_cap`` most frequent ranks from the seed on the device;
writes them into a ``HostEmbeddingStore``; publishes them with
``ServingPublisher`` (float32 rows) into a directory under ``TMPDIR``;
loads the version with ``ServingServer.poll_once``; and serves
``warmup_s`` seconds of its own requests. The window's requests are due
at ``rate_per_s * seconds`` arrival times drawn uniform over the window
(a Poisson process given its count); each request's latency runs from
when it was due to its last candidate's score. Keys are drawn as in
training, so ranks beyond the cap miss the table and score with zero
rows, as new ids do. After the window every answered score is compared
with the plain reference's on the same rows and parameters.
"""

from __future__ import annotations

import functools
import gc
import math
import os
import sys
import threading
import time

import numpy as np
import torch

from portbench import harness, program
from portbench.reference import ctr
from portbench.traffic import criteo


def make_tables(cfg: dict, mix: dict, gen: torch.Generator, device):
    """The served rows, field by field, as [show, clk, w, embedding]:
    show uniform in [1, 10000), clk a quarter of show at most, w and the
    embedding normal with deviation 0.05."""
    d = cfg["embedding_dim"]
    out = []
    for card in cfg["cardinalities"]:
        n = min(card, mix["table_rank_cap"])
        show = torch.randint(1, 10000, (n,), generator=gen,
                             device=device).float()
        clk = torch.floor(show * 0.25 * torch.rand(n, generator=gen,
                                                   device=device))
        wx = torch.randn(n, 1 + d, generator=gen, device=device) * 0.05
        out.append(torch.cat([show[:, None], clk[:, None], wx], dim=1))
    return out


def publish(cfg: dict, tables, params: dict, root: str):
    """The rows and parameters through the program's publish path."""
    from paddlebox_tpu_torch.embedding import HostEmbeddingStore
    from paddlebox_tpu_torch.serving import ServingPublisher
    ecfg = program.embedding_config(cfg)
    keys = torch.cat([criteo.key_of(f, torch.arange(len(t),
                                                    device=t.device))
                      for f, t in enumerate(tables)])
    keys = keys.cpu().numpy().view(np.uint64)
    rows = torch.cat(tables).cpu().numpy()
    full = np.zeros((len(keys), ecfg.row_width), np.float32)
    full[:, :rows.shape[1]] = rows
    store = HostEmbeddingStore(ecfg, initial_capacity=len(keys))
    store.lookup_or_init(keys)
    store.write_back(keys, full)
    pub = ServingPublisher(root, program.model(cfg), program.schema(cfg),
                           quant="f32")
    return pub.publish(store, program.param_tree(params), pass_id=1)


class OpenLoop:
    """Requests submitted on schedule; each one's last score timed."""

    def __init__(self, fe, keys: np.ndarray, dense: np.ndarray,
                 candidates: int):
        self.fe, self.keys, self.dense, self.c = fe, keys, dense, candidates
        self.mask = np.ones(keys.shape[1], bool)
        n = len(keys) // candidates
        self.done = np.full(n, math.nan)
        self.failed = np.zeros(n, bool)
        self.scores = np.full(len(keys), math.nan, np.float32)
        self.late = np.zeros(n)
        self._pending: dict = {}
        self._lock = threading.Lock()

    def _finish(self, i: int, _fut) -> None:
        t = time.perf_counter()
        with self._lock:
            futs = self._pending.pop(i)
        try:
            self.scores[i * self.c:(i + 1) * self.c] = [f.result()
                                                        for f in futs]
        except Exception:   # noqa: BLE001 — the request failed
            self.failed[i] = True
        self.done[i] = t

    def run(self, due: np.ndarray, hooks: dict | None = None) -> None:
        """Submit request i at ``due[i]`` (perf_counter seconds);
        ``hooks[i]()`` runs just before request i."""
        c = self.c
        for i, t in enumerate(due):
            if hooks and i in hooks:
                hooks[i]()
            wait = t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.late[i] = time.perf_counter() - t
            futs = [self.fe.submit(self.keys[k], self.mask, self.dense[k])
                    for k in range(i * c, (i + 1) * c)]
            with self._lock:
                self._pending[i] = futs
            # the frontend scores in arrival order: the last candidate's
            # score comes last
            futs[-1].add_done_callback(functools.partial(self._finish, i))

    def wait(self, timeout_s: float) -> None:
        end = time.perf_counter() + timeout_s
        while np.isnan(self.done).any() and time.perf_counter() < end:
            time.sleep(0.01)


class _GcPauses:
    """The interpreter's garbage-collection pauses in the window, by
    generation: every thread stops for them."""

    def __init__(self):
        self.t0 = None
        self.by_gen: dict[int, list[float]] = {}

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.by_gen.setdefault(info["generation"], []).append(
                time.perf_counter() - self.t0)

    def __str__(self) -> str:
        return "gc pauses: " + ", ".join(
            f"gen {g}: {len(v)}, total {sum(v) * 1e3:.1f} ms, max "
            f"{max(v) * 1e3:.1f} ms" for g, v in sorted(self.by_gen.items()))


def draw_requests(gen, n: int, cfg: dict, mix: dict, device):
    """n page views' candidates: uint64 keys (n * C, S), f32 dense."""
    keys, _, dense = criteo.draw_examples(gen, n * mix["candidates"], cfg,
                                          device)
    return (keys.cpu().numpy().view(np.uint64),
            dense.cpu().numpy())


def arrivals(gen, n: int, seconds: float, device) -> np.ndarray:
    """n arrival offsets of a Poisson process over [0, seconds) given its
    count: sorted uniform draws."""
    u = torch.rand(n, dtype=torch.float64, generator=gen, device=device)
    return np.sort(u.cpu().numpy()) * seconds


def reference_scores(cfg: dict, tables, params: dict, keys: np.ndarray,
                     dense: np.ndarray, device, precision="float32",
                     block: int = 1 << 16) -> np.ndarray:
    """The plain reference's probability of every example: each key's
    row from the seed-made tables by its (field, rank), zero past the
    cap."""
    sizes = torch.tensor([len(t) for t in tables], device=device)
    base = torch.cumsum(sizes, 0) - sizes
    flat = torch.cat(tables + [torch.zeros(1, tables[0].shape[1],
                                           device=device)])
    out = []
    for a in range(0, len(keys), block):
        k = torch.from_numpy(keys[a:a + block].view(np.int64)).to(device)
        field, rank = criteo.rank_of(k)
        hit = rank < sizes[field]
        row = torch.where(hit, base[field] + rank, len(flat) - 1)
        d = torch.from_numpy(dense[a:a + block]).to(device)
        out.append(ctr.scores(cfg, params, flat[row], d,
                              precision).cpu().numpy())
    return np.concatenate(out)


def build(r: harness.Run):
    """Everything up to a loaded, started frontend."""
    from paddlebox_tpu_torch.serving import BatchingFrontend, ServingServer
    cfg, mix, dev = r.cfg, r.mix, r.device
    gen = torch.Generator(device=dev).manual_seed(r.seed)
    params0 = ctr.make_params(cfg, gen, dev)
    tables = make_tables(cfg, mix, gen, dev)
    root = os.path.join(r.scratch, "serving")
    publish(cfg, tables, params0, root)
    srv = ServingServer(root, device=dev,
                        staging_dir=os.path.join(r.scratch, "staging"))
    if srv.poll_once() < 1 or srv.active is None:
        raise harness.BenchError("the server loaded no version")
    fe = BatchingFrontend(srv, max_batch=mix["max_batch"],
                          max_wait_s=mix["max_wait_s"],
                          window_s=3600.0).start()
    return gen, params0, tables, srv, fe


def run(r: harness.Run) -> dict:
    from paddlebox_tpu_torch import monitor
    from paddlebox_tpu_torch.config import flags
    cfg, mix, dev = r.cfg, r.mix, r.device
    cuda = dev.type == "cuda"
    c, rate = mix["candidates"], mix["rate_per_s"]
    gen, params0, tables, srv, fe = build(r)
    n_warm = max(1, round(rate * mix["warmup_s"]))
    n = max(1, round(rate * r.seconds))
    warm = draw_requests(gen, n_warm, cfg, mix, dev)
    warm_due = arrivals(gen, n_warm, mix["warmup_s"], dev)
    keys, dense = draw_requests(gen, n, cfg, mix, dev)
    due = arrivals(gen, n, r.seconds, dev)

    w = OpenLoop(fe, *warm, c)
    w.run(time.perf_counter() + warm_due)
    w.wait(60.0)
    if cuda:
        torch.cuda.synchronize()
    sink, prof, hooks = None, None, {}
    if r.trace:
        sink = monitor.MemorySink(cap=1 << 20)
        monitor.hub().enable(sink)
        flags.serving_trace_sample = 1
        if cuda:
            prof = harness.DeviceProfile(r.scratch, "serve")
            a, b = np.searchsorted(due, [mix["profile_from_s"],
                                         mix["profile_from_s"]
                                         + mix["profile_s"]])
            hooks = {int(a): prof.start, int(b): prof.stop}
    stats0 = fe.stats()
    loop = OpenLoop(fe, keys, dense, c)
    pauses = _GcPauses()
    gc.callbacks.append(pauses)
    t_start = time.perf_counter()
    wall0 = time.time()
    loop.run(t_start + due, hooks)
    loop.wait(60.0)
    wall1 = time.time()
    gc.callbacks.remove(pauses)
    stats1 = fe.stats()
    if r.trace:
        monitor.hub().disable()
        flags.serving_trace_sample = 0
    lat = np.where(loop.failed | np.isnan(loop.done), math.inf,
                   (loop.done - (t_start + due)) * 1e3)
    layer = {"batches": stats1["batches"] - stats0["batches"],
             "batched": stats1["count"] - stats0["count"]}
    if sink is not None:
        layer["score_s"] = [rec["dur_s"] for rec in sink.find("serve/score")
                            if wall0 <= rec["ts"] <= wall1]
    if prof is not None:
        layer["profile"] = prof.reduce()
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    fe.stop()
    srv.stop()
    del fe, srv
    if cuda:
        torch.cuda.empty_cache()
    want = reference_scores(cfg, tables, params0, keys, dense, dev)
    answered = ~np.isnan(loop.scores)
    gap = (float(np.abs(loop.scores[answered] - want[answered]).max())
           if answered.any() else math.inf)
    limits = harness.limits(r.workload)
    print(f"serve: {n} requests, generator late by median "
          f"{np.median(loop.late) * 1e3:.3f} ms, max "
          f"{loop.late.max() * 1e3:.3f} ms; {pauses}", file=sys.stderr)
    return {
        "e2e": {"serve_p99_ms": harness.percentile(lat, 99),
                "serve_p50_ms": harness.percentile(lat, 50),
                "setup_s": t_start - r.t0},
        "layer": layer,
        "checks": [harness.Check("score", gap, limits["score"]),
                   harness.Check("unanswered", float((~answered).sum()),
                                 limits["unanswered"])],
        "attempted": n,
        "failed": int(np.isinf(lat).sum()),
        "memory_peak_bytes": memory,
    }
