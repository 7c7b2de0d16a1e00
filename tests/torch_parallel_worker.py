"""One rank of the port's parallel-module tests (imports no JAX).

Started by ``paddlebox_tpu_torch.distributed.launch`` (through
tests/torch_multirank_spawn.run_world) from
tests/test_torch_{tensor_parallel,expert_parallel,sequence_parallel,
pipeline}.py. Joins the world over gloo, and for each case of the spec
(``PBT_TEST_SPEC``: ``workdir``, ``device``, ``cases``) loads the
case's inputs (``<name>.in.npz``, written by the pytest side from the
JAX package's parameters), builds the case's mesh, runs the module on
this rank's shards forward and, where the case asks, backward, and
writes ``<name>.rank<r>.npz`` (its output and the gradients of its
shards) for the pytest side to hold against the JAX references. A case
that must raise records the error's text instead.
"""

import json
import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddlebox_tpu_torch import weights  # noqa: E402
from paddlebox_tpu_torch.distributed import RoleMaker  # noqa: E402
from paddlebox_tpu_torch.parallel import expert as ep  # noqa: E402
from paddlebox_tpu_torch.parallel import pipeline as pp  # noqa: E402
from paddlebox_tpu_torch.parallel import sequence as sp  # noqa: E402
from paddlebox_tpu_torch.parallel import tensor as tp  # noqa: E402
from paddlebox_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

torch.set_num_threads(1)


def _grad_of(t):
    return np.zeros(t.shape, np.float32) if t.grad is None \
        else t.grad.detach().float().cpu().numpy()


def _dp_slice(mesh, x, dp_axis="dp"):
    n, i = mesh.axis_size(dp_axis), mesh.axis_index(dp_axis)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def tp_case(case, z, dev, out):
    n_dp = int(case.get("n_dp", 1))
    world = torch.distributed.get_world_size()
    mesh = tp.make_tp_mesh(world // n_dp, n_dp, backend="gloo", device=dev)
    dims = case["dims"]
    params = weights.tp_mlp_params(
        [{"w": z[f"w{i}"], "b": z[f"b{i}"]} for i in range(len(dims) - 1)],
        dev)
    shards = tp.shard_tp_params(mesh, params)
    for p in shards:
        for t in p.values():
            t.requires_grad_(True)
    x = torch.from_numpy(z["x"]).to(dev)
    if n_dp > 1:
        x = _dp_slice(mesh, x)
    fn = tp.make_tp_mlp(mesh, dims, dp_axis="dp" if n_dp > 1 else None)
    y = fn(shards, x)
    out["out"] = y.detach().cpu().numpy()
    if case.get("grads"):
        (y ** 2).sum().backward()
        for i, p in enumerate(shards):
            for k, t in p.items():
                g = t.grad
                if n_dp > 1:   # a dp replica's grads sum over dp
                    g = mesh.psum(g, "dp")
                out[f"g{k}{i}"] = g.detach().cpu().numpy()
    out["modes"] = np.array(tp.plan_modes(dims, mesh.axis_size("tp")))


def ep_case(case, z, dev, out):
    world = torch.distributed.get_world_size()
    mesh = ep.make_ep_mesh(world, backend="gloo", device=dev)
    E = int(case["num_experts"])
    if case.get("expect_raise"):
        try:
            ep.make_moe(mesh, E)
        except ValueError as e:
            out["raised"] = np.array(str(e))
        return
    params = weights.moe_params({k: z[k] for k in
                                 ("gate", "w1", "b1", "w2", "b2")}, dev)
    shards = ep.shard_moe_params(mesh, params)
    for t in shards.values():
        t.requires_grad_(True)
    x = torch.from_numpy(z["x"]).to(dev)
    out["dropped"] = np.array(ep.dropped_tokens(
        params, x, world, case["top_k"], case["capacity_factor"]))
    fn = ep.make_moe(mesh, E, top_k=case["top_k"],
                     capacity_factor=case["capacity_factor"])
    y = fn(shards, _dp_slice(mesh, x, "ep"))
    out["out"] = y.detach().cpu().numpy()
    if case.get("grads"):
        (y ** 2).sum().backward()
        for k, t in shards.items():
            g = t.grad
            if k == "gate":   # replicated: this rank's tokens' share
                g = mesh.psum(g, "ep")
            out[f"g{k}"] = g.detach().cpu().numpy()


def sp_case(case, z, dev, out):
    mesh = make_mesh(device=dev, backend="gloo")
    qkv = [torch.from_numpy(z[k]).to(dev) for k in ("q", "k", "v")]
    if case.get("bf16"):
        qkv = [t.to(torch.bfloat16) for t in qkv]
    shards = [sp.seq_shard(t, mesh, "dp").detach().clone()
              .requires_grad_(bool(case.get("grads"))) for t in qkv]
    fn = sp.make_sequence_parallel_attention(
        mesh, "dp", mode=case["mode"], causal=case["causal"])
    if case.get("expect_raise"):
        try:
            fn(*shards)
        except ValueError as e:
            out["raised"] = np.array(str(e))
        return
    y = fn(*shards)
    out["dtype"] = np.array(str(y.dtype))
    out["out"] = y.detach().float().cpu().numpy()
    if case.get("grads"):
        (y.float() ** 2).sum().backward()
        for k, t in zip("qkv", shards):
            out[f"g{k}"] = _grad_of(t)


def pp_case(case, z, dev, out):
    n_dp = int(case.get("n_dp", 1))
    world = torch.distributed.get_world_size()
    mesh = pp.make_pp_mesh(world // n_dp, n_dp, backend="gloo", device=dev)
    stacked = weights.stage_params({"w": z["w"], "b": z["b"]}, dev)
    mine = pp.shard_stage_params(mesh, stacked)
    for t in mine.values():
        t.requires_grad_(True)
    act = {"relu": torch.relu, "tanh": torch.tanh}[case["activation"]]
    fn = pp.make_pipeline(mesh, pp.mlp_stage_fn(act), case["n_micro"],
                          dp_axis="dp" if n_dp > 1 else None)
    x = torch.from_numpy(z["x"]).to(dev)
    if n_dp > 1:
        x = _dp_slice(mesh, x)
    y = fn(mine, x)
    out["out"] = y.detach().cpu().numpy()
    out["stage"] = np.array(mesh.axis_index("pp"))
    if case.get("grads"):
        tgt = torch.from_numpy(z["tgt"]).to(dev)
        if n_dp > 1:
            tgt = _dp_slice(mesh, tgt)
        # the global batch's mean, summed over the dp slices below
        loss = ((y - tgt) ** 2).sum() / (z["x"].shape[0] * y.shape[1])
        loss.backward()
        for k, t in mine.items():
            g = t.grad
            if n_dp > 1:
                g = mesh.psum(g, "dp")
            out[f"g{k}"] = g.detach().cpu().numpy()


CASES = {"tp": tp_case, "ep": ep_case, "sp": sp_case, "pp": pp_case}


def main() -> None:
    with open(os.environ["PBT_TEST_SPEC"]) as f:
        spec = json.load(f)
    dev = spec.get("device", "cpu")
    RoleMaker.from_env().init_distributed(backend="gloo", device=dev)
    rank = torch.distributed.get_rank()
    workdir = spec["workdir"]
    for case in spec["cases"]:
        with np.load(os.path.join(workdir, f"{case['name']}.in.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        out: dict = {}
        CASES[case["kind"]](case, inputs, dev, out)
        np.savez(os.path.join(workdir, f"{case['name']}.rank{rank}.npz"),
                 **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"jax_loaded": "jax" in sys.modules,
                   "cases": len(spec["cases"])}, f)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
