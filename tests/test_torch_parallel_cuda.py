"""Tensor, expert, sequence and pipeline parallelism on the card. Every
test carries the ``cuda`` marker and skips without a CUDA card; the file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

- world 1 over NCCL (a process group of one formed by the mesh makers):
  each module's forward and gradients on the card equal the port's
  single-device reference at the JAX tests' tolerances (TP 2e-5,
  gradients 2e-4 / 2e-5; EP 2e-4 / 2e-5; SP 2e-4 / 2e-5, gradients 5e-4,
  bf16 0.06; PP 2e-5, gradients 1e-4 / 1e-5), the meshes' device is the
  card and their backend NCCL;
- world 2 on the one card over gloo (tests/torch_parallel_worker.py,
  device "cuda"; NCCL refuses two ranks on one device): the sharded
  results and gradients equal the references computed here on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_multirank_spawn import run_parallel_cases
from paddlebox_tpu_torch import weights
from paddlebox_tpu_torch.parallel import expert as ep
from paddlebox_tpu_torch.parallel import pipeline as pp
from paddlebox_tpu_torch.parallel import sequence as sp
from paddlebox_tpu_torch.parallel import tensor as tp
from paddlebox_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.cuda

TP_TOL = dict(rtol=2e-5, atol=2e-5)
TP_GTOL = dict(rtol=2e-4, atol=2e-5)
EP_TOL = dict(rtol=2e-4, atol=2e-5)
SP_TOL = dict(rtol=2e-4, atol=2e-5)
SP_GTOL = dict(rtol=5e-4, atol=5e-4)
BF16_TOL = dict(rtol=0.06, atol=0.06)
PP_TOL = dict(rtol=2e-5, atol=2e-5)
PP_GTOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch.device("cuda")
    if dist.is_initialized():
        dist.destroy_process_group()


def _close(got, want, tol):
    torch.testing.assert_close(got.detach().float().cpu(),
                               want.detach().float().cpu(), **tol)


def _rng_params(seed, dims):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
             "b": (rng.normal(size=b) * 0.1).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def test_tp_world1_nccl(card):
    dims = (16, 64, 32, 1)
    params = weights.tp_mlp_params(_rng_params(0, dims), card)
    mesh = tp.make_tp_mesh(1)
    assert mesh.backend == "nccl" and mesh.device.type == "cuda"
    x = torch.randn(32, dims[0], device=card)
    ref = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
           for p in params]
    want = tp.mlp_reference(ref, x)
    (want ** 2).sum().backward()
    shards = tp.shard_tp_params(mesh, params)
    for p in shards:
        for v in p.values():
            v.requires_grad_(True)
    y = tp.make_tp_mlp(mesh, dims)(shards, x)
    (y ** 2).sum().backward()
    _close(y, want, TP_TOL)
    for p, r in zip(shards, ref):
        _close(p["w"].grad, r["w"].grad, TP_GTOL)
        _close(p["b"].grad, r["b"].grad, TP_GTOL)


def test_moe_world1_nccl(card):
    params = ep.init_moe(1, 8, 16, 32, device=card)
    mesh = ep.make_ep_mesh(1)
    x = torch.randn(64, 16, device=card)
    ref = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = ep.moe_reference(ref, x, top_k=2)
    (want ** 2).sum().backward()
    shards = ep.shard_moe_params(mesh, params)
    for v in shards.values():
        v.requires_grad_(True)
    assert ep.dropped_tokens(params, x, 1, 2, 64.0) == 0
    y = ep.make_moe(mesh, 8, top_k=2, capacity_factor=64.0)(shards, x)
    (y ** 2).sum().backward()
    _close(y, want, EP_TOL)
    for k in shards:
        _close(shards[k].grad, ref[k].grad, EP_TOL)
    # capacity 0.25, top-1: the zeroed rows are the dropped tokens
    with torch.no_grad():
        y1 = ep.make_moe(mesh, 8, top_k=1, capacity_factor=0.25)(params, x)
        want1 = ep.moe_reference(params, x, top_k=1)
    zero = (y1 == 0).all(dim=1)
    assert bool((zero | torch.isclose(y1, want1, **EP_TOL).all(dim=1)).all())
    assert int(zero.sum()) == ep.dropped_tokens(params, x, 1, 1, 0.25) > 0


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_attention_world1_nccl(card, mode):
    mesh = make_mesh()
    q, k, v = (torch.randn(2, 64, 8, 16, device=card) * 0.5
               for _ in range(3))
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = sp.attention_reference(*ref, causal=True)
    (want ** 2).sum().backward()
    mine = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn = sp.make_sequence_parallel_attention(mesh, "dp", mode=mode,
                                             causal=True)
    y = fn(*mine)
    (y ** 2).sum().backward()
    _close(y, want, SP_TOL)
    for a, b in zip(mine, ref):
        _close(a.grad, b.grad, SP_GTOL)
    if mode == "ring":
        with torch.no_grad():
            yb = fn(*(t.to(torch.bfloat16) for t in (q, k, v)))
        assert yb.dtype == torch.bfloat16
        _close(yb, want, BF16_TOL)


def test_pipeline_world1_nccl(card):
    mesh = pp.make_pp_mesh(1)
    w = torch.randn(1, 4, 16, 16, device=card) / 4.0
    b = torch.randn(1, 4, 16, device=card) * 0.01
    x, tgt = torch.randn(32, 16, device=card), torch.randn(32, 16,
                                                           device=card)
    stage_fn = pp.mlp_stage_fn(torch.tanh)
    rw, rb = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    h = stage_fn({"w": rw[0], "b": rb[0]}, x)
    ((h - tgt) ** 2).mean().backward()
    mine = pp.shard_stage_params(mesh, {"w": w, "b": b})
    for t in mine.values():
        t.requires_grad_(True)
    y = pp.make_pipeline(mesh, stage_fn, 4)(mine, x)
    ((y - tgt) ** 2).mean().backward()
    _close(y, h, PP_TOL)
    _close(mine["w"].grad, rw.grad, PP_GTOL)
    _close(mine["b"].grad, rb.grad, PP_GTOL)


def test_world2_gloo_on_the_card(card, tmp_path):
    """Two ranks on cuda:0 over gloo: each module's shards and gradients
    equal the references computed here on the CPU."""
    rng = np.random.default_rng(7)
    dims = (8, 16, 8)
    tp_in = {"x": rng.normal(size=(8, 8)).astype(np.float32)}
    for i, p in enumerate(_rng_params(3, dims)):
        tp_in[f"w{i}"], tp_in[f"b{i}"] = p["w"], p["b"]
    moe = {k: v.numpy() for k, v in ep.init_moe(2, 8, 16, 32,
                                                 device="cpu").items()}
    moe["x"] = rng.normal(size=(32, 16)).astype(np.float32)
    qkv = {k: (rng.normal(size=(1, 32, 8, 8)) * 0.5).astype(np.float32)
           for k in "qkv"}
    stages = {"w": (rng.normal(size=(2, 1, 8, 8)) / 3).astype(np.float32),
              "b": (rng.normal(size=(2, 1, 8)) * 0.01).astype(np.float32),
              "x": rng.normal(size=(16, 8)).astype(np.float32),
              "tgt": rng.normal(size=(16, 8)).astype(np.float32)}
    cases = [({"name": "tp", "kind": "tp", "dims": list(dims),
               "grads": True}, tp_in),
             ({"name": "ep", "kind": "ep", "num_experts": 8, "top_k": 2,
               "capacity_factor": 64.0, "grads": True}, moe),
             ({"name": "ring", "kind": "sp", "mode": "ring", "causal": True,
               "grads": True}, qkv),
             ({"name": "ulysses", "kind": "sp", "mode": "ulysses",
               "causal": True, "grads": True}, qkv),
             ({"name": "pp", "kind": "pp", "n_micro": 4,
               "activation": "tanh", "grads": True}, stages)]
    got = run_parallel_cases(str(tmp_path), 2, cases, device="cuda")
    t = torch.from_numpy
    # TP: every rank's output is the whole reference's
    params = weights.tp_mlp_params(
        [{"w": tp_in[f"w{i}"], "b": tp_in[f"b{i}"]} for i in range(2)])
    want = tp.mlp_reference(params, t(tp_in["x"]))
    for z in got["tp"]:
        _close(t(z["out"]), want, TP_TOL)
    # EP: the ranks' rows concatenated
    mp = weights.moe_params({k: moe[k] for k in
                             ("gate", "w1", "b1", "w2", "b2")})
    _close(t(np.concatenate([z["out"] for z in got["ep"]])),
           ep.moe_reference(mp, t(moe["x"])), EP_TOL)
    # SP: the sequence shards concatenated, and the q/k/v gradients
    ref = [t(qkv[k]).clone().requires_grad_(True) for k in "qkv"]
    want = sp.attention_reference(*ref, causal=True)
    (want ** 2).sum().backward()
    for mode in ("ring", "ulysses"):
        ranks = got[mode]
        _close(t(np.concatenate([z["out"] for z in ranks], axis=1)), want,
               SP_TOL)
        for k, r in zip("qkv", ref):
            _close(t(np.concatenate([z[f"g{k}"] for z in ranks], axis=1)),
                   r.grad, SP_GTOL)
    # PP: replicated output; stage s's gradient on rank s
    sw = t(stages["w"]).clone().requires_grad_(True)
    sb = t(stages["b"]).clone().requires_grad_(True)
    h = t(stages["x"])
    fn = pp.mlp_stage_fn(torch.tanh)
    for s in range(2):
        h = fn({"w": sw[s], "b": sb[s]}, h)
    ((h - t(stages["tgt"])) ** 2).mean().backward()
    for z in got["pp"]:
        s = int(z["stage"])
        _close(t(z["out"]), h, PP_TOL)
        _close(t(z["gw"][0]), sw.grad[s], PP_GTOL)
        _close(t(z["gb"][0]), sb.grad[s], PP_GTOL)
