"""The training loop: passes of in-memory Criteo-shaped records
through ``BoxPS.begin_pass`` -> ``Trainer.train_pass(ds,
preload_keys=<the next pass's keys>)`` -> ``BoxPS.end_pass()``, back to
back.

Set-up builds one store, trainer and BoxPS from the seed. The store
starts at deployment state: sized for the configuration's whole key
universe (every rank of every field) and holding each of those keys with
its init row, inserted in one fixed shuffled order, so no pass grows it
or meets a key it has never held. Set-up then drives the trainer through
its first steps, passes of ``probe_passes`` batches run as the window
runs its passes (each preloads the next pass's keys; the last preloads
the first warm-up pass's), whose losses, first gradient and parameters
and rows after are the readings that decide ``correct``. It trains
``warmup_passes`` whole passes of the pool (new power-law draws each)
and measures: the window runs whole passes until ``--seconds`` have
passed, so pass boundaries (the feed build, the staging of the next
pass, the lazy write-back) are inside it. After the window the same
readings come from the plain reference (``reference/ctr.py``) on the
same inputs.

Mix parameters: ``pass_batches`` (batches a pass), ``probe_passes``
(batches in each of the first passes), ``warmup_passes``,
``max_examples_per_s`` (sizes the pool of passes made in set-up; the
window cycles through the pool if it runs faster), ``profile_pass``
(which window pass a traced run profiles).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from portbench import harness, program
from portbench.counts import flops, sectors
from portbench.reference import ctr
from portbench.traffic import criteo


def _dataset(schema, keys, label, dense):
    from paddlebox_tpu_torch.data import SlotDataset
    ds = SlotDataset(schema)
    ds.records = criteo.records(schema, keys, label, dense)
    return ds


def _norms(a: dict) -> dict:
    return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in a.items()}


def grad1(cfg: dict, p0: dict, dense1: dict, rows0, rows1) -> dict:
    """The norm of each leaf's step-1 gradient as the optimizer got it,
    worked out from the state after the step (the same arithmetic for
    the program and the reference): ``dense1`` is adam's first moment
    (the gradient is it over 1 - b1) or, for sgd, the parameters (their
    move over the rate); ``rows0`` / ``rows1`` are the step's rows
    before and after (adagrad's accumulators, or sgd's move)."""
    d = cfg["embedding_dim"]
    if cfg["dense_optimizer"] == "adam":
        g = {k: v / (1 - 0.9) for k, v in dense1.items()}
    else:
        g = {k: (p0[k] - dense1[k]) / cfg["dense_lr"] for k in p0}
    if cfg["table_optimizer"] == "adagrad":
        o = 3 + d
        g["table.w"] = np.sqrt(rows1[:, o].astype(np.float64))
        g["table.embedding"] = np.sqrt(rows1[:, o + 1].astype(np.float64)
                                       * d)
    else:
        lr = cfg["table_lr"]
        g["table.w"] = (rows0[:, 2] - rows1[:, 2]) / lr
        g["table.embedding"] = (rows0[:, 3:3 + d] - rows1[:, 3:3 + d]) / lr
    return _norms(g)


def _pass_losses(out: dict, n: int) -> list[float]:
    """Each step's loss of a pass of 1 to 3 steps, from its first, last
    and mean loss."""
    first, last = out["loss_first"], out["loss_last"]
    mid = n * out["loss_mean"] - first - last
    return {1: [first], 2: [first, last], 3: [first, mid, last]}[n]


def _device_rows(ws, keys: np.ndarray, ecfg) -> np.ndarray:
    """The rows of ``keys`` as the pass's device table holds them (row
    1 + the key's place among the pass's sorted keys), read without the
    store's flush, so the next pass still meets rows the lazy write-back
    has not shipped."""
    from paddlebox_tpu_torch.embedding.working_set import fetch_rows
    pos = np.searchsorted(ws.sorted_keys, keys)
    if not np.array_equal(ws.sorted_keys[pos], keys):
        raise harness.BenchError("a key of the pass is not in its table")
    return fetch_rows(ws.table, pos + 1, ecfg)[0]


def first_steps(tr, box, store, schema, cfg: dict, mix: dict, probe,
                params0: dict, after_keys: np.ndarray) -> dict:
    """Drive the trainer through its first passes of ``probe_passes``
    batches, each called as the window calls its passes (preloading the
    next pass's keys, the last ``after_keys``), and read them: each
    step's loss, the first gradient, and the parameters and rows
    after."""
    keys, label, dense = probe
    b = cfg["batch_size"]
    all_keys = criteo.unique_keys(keys)
    rows0 = store.peek_rows(all_keys)           # the program's init rows
    p0 = {k: v.detach().cpu().numpy() for k, v in params0.items()}
    bounds = np.cumsum([0] + list(mix["probe_passes"])) * b
    slices = [slice(a, z) for a, z in zip(bounds[:-1], bounds[1:])]
    nexts = [criteo.unique_keys(keys[sl]) for sl in slices[1:]]
    losses, g1 = [], None
    for sl, nxt in zip(slices, nexts + [after_keys]):
        n = (sl.stop - sl.start) // b
        ds = _dataset(schema, keys[sl], label[sl], dense[sl])
        box.begin_pass()
        out = tr.train_pass(ds, preload_keys=nxt)
        box.end_pass()
        if out["steps"] != n:
            raise harness.BenchError(f"a pass of {n} batches ran "
                                     f"{out['steps']} steps")
        losses += _pass_losses(out, n)
        if g1 is None:
            k1 = criteo.unique_keys(keys[sl])
            if cfg["dense_optimizer"] == "adam":
                adam = tr.dense_state()["opt_state"][0]
                if int(adam["count"]) != 1:
                    raise harness.BenchError(
                        f"adam count {adam['count']} after the first step")
                dense1 = program.flat_tree(adam["mu"])
            else:
                dense1 = program.flat_tree(tr.eval_params())
            g1 = grad1(cfg, p0, dense1, rows0[np.searchsorted(all_keys, k1)],
                       _device_rows(tr.last_ws, k1, store.cfg))
    p3 = program.flat_tree(tr.eval_params())
    rows3 = store.get_rows(all_keys)
    d = cfg["embedding_dim"]
    change = {k: p3[k] - p0[k] for k in p0}
    change["table.w"] = rows3[:, 2] - rows0[:, 2]
    change["table.embedding"] = rows3[:, 3:3 + d] - rows0[:, 3:3 + d]
    return {"loss": losses, "grad1": g1, "change": _norms(change),
            "counters": rows3[:, :2].copy(), "keys": all_keys}


def reference_steps(cfg: dict, mix: dict, probe, params0: dict,
                    precision: str = "float32") -> dict:
    """The same readings from the plain reference."""
    keys, label, dense = probe
    b = cfg["batch_size"]
    steps = sum(mix["probe_passes"])
    batches = [(keys[i * b:(i + 1) * b], label[i * b:(i + 1) * b],
                dense[i * b:(i + 1) * b]) for i in range(steps)]
    ref = ctr.train(cfg, params0, batches, precision)
    d = cfg["embedding_dim"]
    rows = ref["rows"].cpu().numpy()
    rows0 = ctr.init_rows(cfg, ref["keys"])
    first = np.isin(ref["keys"], criteo.unique_keys(keys[:b]))
    st = ref["state1"]
    g1 = grad1(cfg, {k: v.cpu().numpy() for k, v in params0.items()},
               {k: v.cpu().numpy() for k, v in st["dense"].items()},
               rows0[first], st["rows"].cpu().numpy()[first])
    change = {k: (ref["params"][k] - params0[k]).cpu().numpy()
              for k in params0}
    change["table.w"] = rows[:, 2] - rows0[:, 2]
    change["table.embedding"] = rows[:, 3:3 + d] - rows0[:, 3:3 + d]
    return {"loss": ref["loss"], "grad1": g1,
            "change": _norms(change), "counters": rows[:, :2],
            "keys": ref["keys"]}


def _leaf_gap(got: dict, want: dict) -> float:
    """The worst leaf's |got norm - want norm| over the larger of the
    leaf's and the median leaf's want norm; leaves whose want norm is
    under a thousandth of the median leaf's are left out."""
    med = float(np.median(list(want.values())))
    return max(abs(got[k] - w) / max(w, med)
               for k, w in want.items() if w >= 1e-3 * med)


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared: each a gap between two sets of readings."""
    if not np.array_equal(got["keys"], want["keys"]):
        return {"loss": math.inf, "grad1": math.inf, "change": math.inf,
                "counters": math.inf}
    return {
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(got["loss"], want["loss"], strict=True)),
        "grad1": _leaf_gap(got["grad1"], want["grad1"]),
        "change": _leaf_gap(got["change"], want["change"]),
        "counters": float(np.abs(got["counters"]
                                 - want["counters"]).max()),
    }


def universe(cfg: dict) -> int:
    """Keys the configuration can draw: every rank of every field."""
    return sum(cfg["cardinalities"])


def prefill(store, cfg: dict, device, chunk: int = 1 << 20) -> None:
    """Insert every key of the universe with its init row, through the
    pass builder's own ``lookup_or_init``, in an order that is the same
    in every run (a shuffle from a fixed seed): a store that a long run
    has filled, its rows scattered as keys first arrived."""
    gen = torch.Generator(device=device).manual_seed(0x5EED)
    keys = torch.cat([criteo.key_of(f, torch.arange(c, device=device))
                      for f, c in enumerate(cfg["cardinalities"])])
    keys = keys[torch.randperm(len(keys), generator=gen, device=device)]
    for a in range(0, len(keys), chunk):
        store.lookup_or_init(keys[a:a + chunk].cpu().numpy().view(np.uint64))
    if len(store) != len(keys):
        raise harness.BenchError(f"the store holds {len(store)} keys after "
                                 f"a prefill of {len(keys)}")


def build(cfg: dict, seed: int, device):
    """The program: store (at deployment state), trainer (with the
    seed-made dense parameters) and BoxPS; and the parameters, on
    ``device``."""
    from paddlebox_tpu_torch import weights
    from paddlebox_tpu_torch.embedding import HostEmbeddingStore
    from paddlebox_tpu_torch.fleet import BoxPS
    from paddlebox_tpu_torch.train import Trainer, TrainerConfig
    gen = torch.Generator(device=device).manual_seed(seed)
    params0 = ctr.make_params(cfg, gen, device)
    store = HostEmbeddingStore(program.embedding_config(cfg),
                               initial_capacity=universe(cfg))
    prefill(store, cfg, device)
    schema = program.schema(cfg)
    tr = Trainer(program.model(cfg), store, schema,
                 TrainerConfig(dense_lr=cfg["dense_lr"],
                               dense_optimizer=cfg["dense_optimizer"],
                               global_batch_size=cfg["batch_size"]),
                 seed=seed, device=device)
    weights.load_model_params(tr.model, program.param_tree(params0))
    box = BoxPS(store)
    box.set_date(20240101)
    return gen, params0, store, schema, tr, box


def pull_bytes(idx: np.ndarray, slots: int, stride: int,
               pull_width: int) -> int:
    """The least bytes of the pull of a batch's row ids ``idx`` (B,
    tokens): its output is counted pooled, B x ``slots`` x
    ``pull_width``, the least any pull must write (at one id a slot, the
    tokens' rows)."""
    rows = torch.from_numpy(np.asarray(idx, np.int64))
    return sectors.pull_bytes(rows, stride, pull_width,
                              idx.shape[0] * slots * pull_width)


def _attribute(tr, ds, cfg: dict, step_s: float) -> dict:
    """step_probe's device-time account of one batch of the last pass,
    with the pull's and the push's least bytes from ``counts``."""
    from paddlebox_tpu_torch.utils import step_probe
    ws = tr.last_ws
    pb = next(iter(ds.batches(cfg["batch_size"])))
    idx = ws.translate(pb.ids, pb.mask)
    labels, dense = tr.split_floats(pb.floats)
    staged = tr.stage(tr.pack_arrays(ws, idx, pb.mask, dense, labels))
    att = step_probe.attribute_step(tr, ws, staged, step_s)
    ecfg = tr.store.cfg
    rows = torch.from_numpy(np.asarray(idx, np.int64))
    stride = int(ws.table.shape[1])
    return {"isolated": att["isolated"],
            "pull_bytes": pull_bytes(idx, cfg["num_sparse"], stride,
                                     ecfg.pull_width),
            "push_bytes": sectors.push_bytes(rows, stride, ecfg.row_width,
                                             ecfg.grad_width)}


def run(r: harness.Run) -> dict:
    cfg, mix, dev = r.cfg, r.mix, r.device
    b = cfg["batch_size"]
    cuda = dev.type == "cuda"
    marks = [("start", r.t0), ("import", time.perf_counter())]
    gen, params0, store, schema, tr, box = build(cfg, r.seed, dev)
    marks.append(("build and prefill", time.perf_counter()))
    probe = criteo.draw_examples(gen, sum(mix["probe_passes"]) * b, cfg,
                                 dev)
    pass_n = mix["pass_batches"] * b
    n_pool = mix["warmup_passes"] + 2 + math.ceil(
        r.seconds * mix["max_examples_per_s"] / pass_n)
    pool, pool_keys = [], []
    for _ in range(n_pool):
        keys, label, dense = criteo.draw_examples(gen, pass_n, cfg, dev)
        pool.append(_dataset(schema, keys, label, dense))
        pool_keys.append(criteo.unique_keys(keys))
    del keys, label, dense
    marks.append(("passes made", time.perf_counter()))
    mine = first_steps(tr, box, store, schema, cfg, mix, probe, params0,
                       pool_keys[0])
    marks.append(("first steps", time.perf_counter()))

    def one_pass(i: int) -> tuple[float, dict]:
        t = time.perf_counter()
        with harness.label("begin_pass"):
            box.begin_pass()
        with harness.label("train_pass"):
            out = tr.train_pass(pool[i % n_pool],
                                preload_keys=pool_keys[(i + 1) % n_pool])
        with harness.label("end_pass"):
            box.end_pass()
        return time.perf_counter() - t, out

    for i in range(mix["warmup_passes"]):
        one_pass(i)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    print("set-up: " + " | ".join(
        f"{name} {t1 - t0:.3f} s" for (_, t0), (name, t1)
        in zip(marks[:-1], marks[1:])), file=sys.stderr)
    timers0 = (dict(tr.timers.total), dict(tr.timers.count))
    profile = None
    passes = []
    t_start = time.perf_counter()
    i = mix["warmup_passes"]
    while True:
        prof = None
        if r.trace and cuda and len(passes) == mix["profile_pass"]:
            prof = harness.DeviceProfile(r.scratch)
            prof.start()
        wall, out = one_pass(i)
        if prof is not None:
            prof.stop()
            profile = prof
        passes.append((wall, out["step_seconds"], out["steps"]))
        i += 1
        if time.perf_counter() - t_start >= r.seconds:
            break
    window = time.perf_counter() - t_start
    tr.wait_feed_pass_done()
    print("window passes (wall s, step loop s): " + ", ".join(
        f"{w:.3f}/{st:.3f}" for w, st, _ in passes), file=sys.stderr)
    steps = sum(p[2] for p in passes)
    layer = {
        "timers": {k: (tr.timers.total[k] - timers0[0].get(k, 0.0),
                       tr.timers.count[k] - timers0[1].get(k, 0))
                   for k in tr.timers.total},
        "steps": steps,
        "passes": passes,
        "examples_per_s": steps * b / sum(p[0] for p in passes),
        "flops_per_example": flops.train_flops_per_example(cfg),
    }
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if r.trace and cuda:
        name = torch.cuda.get_device_name(dev)
        layer["peak_flops"] = flops.PEAKS.get(name, {}).get("float32")
        layer["hbm_bytes_per_s"] = flops.HBM_BYTES_PER_S.get(name)
        step_s = sum(p[1] for p in passes) / steps
        layer.update(_attribute(tr, pool[(i - 1) % n_pool], cfg, step_s))
        if profile is not None:
            layer["profile"] = profile.reduce()
    # the program's state goes before the reference runs
    tr.feed_mgr.close()
    del tr, box, store, pool
    if cuda:
        torch.cuda.empty_cache()
    got = gaps(mine, reference_steps(cfg, mix, probe, params0))
    limits = harness.limits(r.workload)
    return {
        "e2e": {"train_examples_per_s": steps * b / window,
                "setup_s": t_start - r.t0},
        "layer": layer,
        "checks": [harness.Check(k, got[k], limits[k]) for k in got],
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": memory,
    }
