"""One rank of the port's multi-rank CPU tests (imports no JAX).

Started by ``paddlebox_tpu_torch.distributed.launch`` from
tests/test_torch_multirank_train.py and tests/test_torch_exchange.py.
Joins the world over gloo on the CPU, builds the mesh the spec names
(``PBT_TEST_SPEC``, a JSON file: ``workdir``, ``num_nodes``, ``phases``,
``device``: "cpu", or "cuda" for the card's tests, where every rank
shares the one card) and runs each phase:

- ``ops``: the routed pulls and pushes of both table layouts on this
  rank's shard of a seeded table (tests/torch_multirank_common.ops_case),
  every wire, flat and (on a 2-D mesh) hier;
- ``train``: ``Trainer(mesh=...)`` passes and an eval pass per recipe,
  from the dense parameters the pytest side wrote (``params.npz``);
- ``overflow``: a skewed pass at a small capacity factor, the grow-retry
  policy, and the eval pass's in-place retry.

Each rank writes ``rank<r>.npz`` (arrays) and ``rank<r>.json`` (numbers)
into the work dir; the pytest side compares them with the JAX package.
"""

import json
import os
import sys
import warnings

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_multirank_common as common  # noqa: E402
from paddlebox_tpu_torch import monitor, weights  # noqa: E402
from paddlebox_tpu_torch.config import flags  # noqa: E402
from paddlebox_tpu_torch.data import DataFeedSchema, SlotDataset  # noqa: E402
from paddlebox_tpu_torch.data import slot_record  # noqa: E402
from paddlebox_tpu_torch.distributed import (RoleMaker,  # noqa: E402
                                             ShardOwnership)
from paddlebox_tpu_torch.embedding import (exchange, sharded,  # noqa: E402
                                           tiering)
from paddlebox_tpu_torch.embedding.config import EmbeddingConfig  # noqa: E402
from paddlebox_tpu_torch.embedding.store import HostEmbeddingStore  # noqa: E402
from paddlebox_tpu_torch.models import DeepFMModel  # noqa: E402
from paddlebox_tpu_torch.native.key_index import dedup_plan  # noqa: E402
from paddlebox_tpu_torch.ops import kernels  # noqa: E402
from paddlebox_tpu_torch.parallel import make_mesh  # noqa: E402
from paddlebox_tpu_torch.train import Trainer, TrainerConfig  # noqa: E402
from paddlebox_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402

torch.set_num_threads(1)


def _plan(flat: np.ndarray, n_rows: int, dev) -> sharded.DedupPlan:
    o, u, s, _r, _e = dedup_plan(flat, n_rows, n_rows, 1)
    return sharded.DedupPlan(*(torch.from_numpy(a).to(dev)
                               for a in (o, u, s)))


def ops_phase(mesh, out: dict, info: dict) -> None:
    r, W = mesh.rank, mesh.world
    axes = mesh.axis_names
    cfg = EmbeddingConfig(dim=common.DIM, optimizer="sgd",
                          learning_rate=0.0625)
    case = common.ops_case(W, cfg.row_width, cfg.grad_width)
    rps, T, B = common.OPS_RPS, common.OPS_TOKENS, common.OPS_B
    n_rows = W * rps
    dev = mesh.device
    shard = torch.from_numpy(case["table"][r * rps:(r + 1) * rps].copy()
                             ).to(dev)
    sl = slice(r * T, (r + 1) * T)
    idx = torch.from_numpy(case["idx"][sl].copy()).to(dev)
    g, sh, ck = (torch.from_numpy(case[k][sl].copy()).to(dev)
                 for k in ("grads", "shows", "clks"))
    plan = _plan(case["idx"][sl], n_rows, dev)
    dropped = 0

    def keep(name, res):
        nonlocal dropped
        t, d = res
        dropped += int(d)
        out[name] = t.cpu().numpy()

    keep("pull_single", sharded.routed_lookup(shard, idx, cfg, mesh, axes,
                                              2.0, return_dropped=True))
    keep("pull_single_dedup", sharded.routed_lookup(
        shard, idx, cfg, mesh, axes, 2.0, dedup=True, return_dropped=True))
    keep("pull_sharded", exchange.routed_pull(shard, idx, cfg, mesh, axes,
                                              2.0, plan=plan,
                                              return_dropped=True))
    pidx_np = case["pidx"][r * B:(r + 1) * B].copy()
    pidx = torch.from_numpy(pidx_np).to(dev)
    keep("pull_pooled", exchange.routed_pull_pooled(
        shard, pidx, cfg, mesh, axes, common.OPS_S, common.OPS_L, 2.0,
        plan=_plan(pidx_np.reshape(-1), n_rows, dev), return_dropped=True))
    keep("pull_pooled_noplan", exchange.routed_pull_pooled(
        shard, pidx, cfg, mesh, axes, common.OPS_S, common.OPS_L, 2.0,
        return_dropped=True))

    def pushed(fn):
        t = shard.clone()
        fn(t)
        return t.cpu().numpy()

    out["push_single"] = pushed(lambda t: sharded.routed_push(
        t, idx, g, sh, ck, cfg, mesh, axes, 2.0))
    out["push_single_dedup"] = pushed(lambda t: sharded.routed_push(
        t, idx, g, sh, ck, cfg, mesh, axes, 2.0, dedup=True))
    topologies = ["flat"] + (["hier"] if len(axes) == 2 else [])
    for topo in topologies:
        for wire in exchange.WIRES:
            out[f"push_{wire}_{topo}"] = pushed(
                lambda t: exchange.routed_push(
                    t, idx, g, sh, ck, cfg, mesh, axes, 2.0, wire=wire,
                    plan=plan, topology=topo))
        out[f"push_noplan_{topo}"] = pushed(lambda t: exchange.routed_push(
            t, idx, g, sh, ck, cfg, mesh, axes, 2.0, wire="f32",
            topology=topo))

    def deferred(t):
        mg, ms, mc = sharded.deferred_push_operands(idx, g, sh, ck, plan)
        exchange.routed_push(t, plan.uniq, mg, ms, mc, cfg, mesh, axes,
                             2.0, wire="f32", premerged=True)

    out["push_deferred"] = pushed(deferred)
    info["ops_dropped"] = dropped


def _trainer(mesh, max_len: int, recipe: dict, arr: dict, workdir: str):
    schema = DataFeedSchema.ctr(num_sparse=common.NUM_SLOTS,
                                num_float=common.DENSE_DIM,
                                batch_size=common.BATCH, max_len=max_len)
    ds = SlotDataset(schema)
    ds.records = common.make_records(slot_record, schema, arr)
    ecfg = EmbeddingConfig(dim=common.DIM, learning_rate=common.SPARSE_LR)
    n_shards = recipe.get("n_shards")
    # a ShardedEmbeddingStore whose shards the ranks own round-robin, or
    # a plain store (the hash partition)
    store = (tiering.store_from_flags(ecfg, n_shards) if n_shards
             else HostEmbeddingStore(ecfg))
    cfg = TrainerConfig(
        global_batch_size=common.BATCH, dense_lr=common.DENSE_LR,
        auc_buckets=common.AUC_BUCKETS,
        dense_sync_mode=recipe.get("dense_sync_mode", "allreduce"),
        param_sync_step=recipe.get("param_sync_step", 1),
        capacity_factor=recipe.get("capacity_factor", 2.0))
    model = DeepFMModel(common.NUM_SLOTS, common.DIM, common.DENSE_DIM,
                        hidden=common.HIDDEN)
    tr = Trainer(model, store, schema, cfg, mesh=mesh)
    if n_shards:
        tr.set_shard_ownership(ShardOwnership(n_shards, mesh.world,
                                              mesh.rank))
    path = os.path.join(workdir, f"params_{recipe['name']}.npz")
    if os.path.exists(path):
        weights.load_model_params(tr.model, ckpt_lib.load_tree(
            weights.model_params(tr.model), path))
    return tr, ds, store


def train_phase(mesh, workdir: str, recipes: list, out: dict,
                info: dict) -> None:
    for rc in recipes:
        flags.table_layout = rc["layout"]
        flags.exchange_wire = rc.get("wire", "f32")
        name = rc["name"]
        arr = common.dataset_arrays(rc["max_len"])
        tr, ds, store = _trainer(mesh, rc["max_len"], rc, arr, workdir)
        res = {"table_layout": tr.table_layout,
               "pull_engine": tr.pull_engine,
               "push_overlap": tr.push_overlap}
        for p in range(common.PASSES):
            # "preload": the next pass's rows staged on the feed thread
            pre = (ds.unique_keys() if rc.get("preload")
                   and p + 1 < common.PASSES else None)
            r = tr.train_pass(ds, preload_keys=pre)
            for k in ("loss_first", "loss_mean", "auc", "steps",
                      "routed_dropped"):
                res[f"pass{p}_{k}"] = r[k]
        ev = tr.eval_pass(ds)
        res["eval_auc"] = ev["auc"]
        res["eval_examples"] = ev["examples"]
        res["eval_dropped"] = ev["routed_dropped"]
        tr.flush_sparse()
        keys = np.sort(store.keys())
        out[f"{name}_keys"] = keys
        out[f"{name}_rows"] = store.get_rows(keys)
        out[f"{name}_dense"] = np.concatenate(
            [t.detach().cpu().numpy().reshape(-1) for t in tr.params])
        info[name] = res
        tr.feed_mgr.close()
        if tr.dense_table is not None:
            tr.dense_table.stop()
    flags.table_layout = "auto"
    flags.exchange_wire = "auto"


def overflow_phase(mesh, workdir: str, info: dict) -> None:
    flags.table_layout = "sharded"
    flags.exchange_wire = "f32"
    flags.routed_capacity_preplan = False
    arr = common.dataset_arrays(1, n_ex=4 * common.BATCH, skew=True)
    rc = {"name": "overflow", "capacity_factor": 1.0}
    res = {}
    tr, ds, _ = _trainer(mesh, 1, rc, arr, workdir)
    snap0 = monitor.STATS.snapshot()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r1 = tr.train_pass(ds)
    res["pass0_dropped"] = r1["routed_dropped"]
    res["pass0_warned"] = any("exceeded all_to_all" in str(x.message)
                              for x in w)
    snap = monitor.STATS.snapshot()
    res["counter_dropped"] = (snap.get("exchange.overflow_dropped", 0)
                              - snap0.get("exchange.overflow_dropped", 0))
    res["factor_after"] = tr.cfg.capacity_factor
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r2 = tr.train_pass(ds)
    res["pass1_dropped"] = r2["routed_dropped"]
    tr.feed_mgr.close()
    tr_e, ds_e, _ = _trainer(mesh, 1, rc, arr, workdir)
    r0 = monitor.STATS.snapshot().get("exchange.overflow_retries", 0)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        ev = tr_e.eval_pass(ds_e)
    res["eval_dropped"] = ev["routed_dropped"]
    res["eval_retries"] = (monitor.STATS.snapshot().get(
        "exchange.overflow_retries", 0) - r0)
    res["eval_examples"] = ev["examples"]
    tr_e.feed_mgr.close()
    info["overflow"] = res
    flags.routed_capacity_preplan = True
    flags.table_layout = "auto"
    flags.exchange_wire = "auto"


def trace_phase(mesh, workdir: str, info: dict) -> None:
    """One traced pass on the sharded layout through BoxPS, the hub
    writing <workdir>/rank<r>/events.jsonl: one exchange flow point a
    step, the same key on every rank."""
    from paddlebox_tpu_torch.fleet import BoxPS
    flags.table_layout = "sharded"
    flags.exchange_wire = "f32"
    flags.trace = True
    tr, ds, store = _trainer(mesh, 1, {"name": "trace"},
                             common.dataset_arrays(1), workdir)
    box = BoxPS(store)
    hub = monitor.hub()
    hub.enable(monitor.JsonlSink(os.path.join(workdir, f"rank{mesh.rank}",
                                              "events.jsonl")))
    try:
        box.begin_pass()
        r = tr.train_pass(ds)
        box.end_pass(trainer=tr)
    finally:
        hub.disable()
        flags.trace = False
    info["trace_steps"] = r["steps"]
    info["trace_layout"] = tr.table_layout
    tr.feed_mgr.close()
    flags.table_layout = "auto"
    flags.exchange_wire = "auto"


def main() -> None:
    with open(os.environ["PBT_TEST_SPEC"]) as f:
        spec = json.load(f)
    device = spec.get("device", "cpu")
    rm = RoleMaker.from_env()
    rm.init_distributed(backend="gloo", device=device)
    mesh = make_mesh(num_nodes=spec.get("num_nodes", 1), device=device,
                     backend="gloo")
    workdir = spec["workdir"]
    out: dict = {}
    info: dict = {"world": mesh.world, "shape": list(mesh.shape)}
    kernels.reset_launches()
    for phase in spec["phases"]:
        if phase == "ops":
            ops_phase(mesh, out, info)
        elif phase == "train":
            train_phase(mesh, workdir, spec["recipes"], out, info)
        elif phase == "overflow":
            overflow_phase(mesh, workdir, info)
        elif phase == "trace":
            trace_phase(mesh, workdir, info)
        else:
            raise ValueError(f"unknown phase {phase!r}")
    info["jax_loaded"] = "jax" in sys.modules
    info["launches"] = kernels.launch_counts()
    np.savez(os.path.join(workdir, f"rank{mesh.rank}.npz"), **out)
    with open(os.path.join(workdir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
