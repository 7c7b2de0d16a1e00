"""Expert parallelism — the port of ``paddlebox_tpu/parallel/expert.py``
(``init_moe`` :36, ``moe_reference`` :60, ``dropped_tokens`` :90,
``_capacity`` :111, ``make_moe`` :116, ``shard_moe_params`` :76).

Experts shard across an ``ep`` mesh axis and tokens travel to their
experts through fixed-capacity all-to-alls:

    gate (top-k softmax) → route token features into per-(rank, expert)
    capacity lanes → all_to_all over ep → batched expert MLPs (one
    einsum over the stacked local experts) → all_to_all back → weighted
    combine.

Tokens beyond a lane's capacity are dropped (capacity-factor semantics;
``dropped_tokens`` counts them). A token's lane is its stable rank among
the tokens bound for the same expert: ``torch.argsort(stable=True)``,
as ``jnp.argsort`` is stable, so the port drops exactly the tokens the
reference drops. The combine adds into ``n + 1`` rows with
``index_add``, so empty (-1) lanes land in a discard row, as
``.at[safe].add(mode="drop")`` does. Numerics match ``moe_reference``
for every surviving token.

Each rank holds ``num_experts / n_ep`` experts (``shard_moe_params``) and
its slice of the token batch; the gate is replicated, so its gradient is
this rank's tokens' share (the caller sums it over ep, as data
parallelism does).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.parallel import collective_ops as cops
from paddlebox_tpu_torch.parallel.mesh import Mesh, make_named_mesh

EP_AXIS = "ep"


def make_ep_mesh(n_ep: int, backend: str | None = None,
                 device: str | torch.device | None = None) -> Mesh:
    return make_named_mesh([(EP_AXIS, n_ep)], backend=backend,
                           device=device)


def init_moe(seed: int, num_experts: int, d_model: int, d_hidden: int,
             device: str | torch.device | None = None) -> dict:
    """Gate + stacked expert FFNs (unsharded)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    s1, s2 = 1.0 / d_model ** 0.5, 1.0 / d_hidden ** 0.5

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return {"gate": rnd(d_model, num_experts) * s1,
            "w1": rnd(num_experts, d_model, d_hidden) * s1,
            "b1": torch.zeros((num_experts, d_hidden), device=dev),
            "w2": rnd(num_experts, d_hidden, d_model) * s2,
            "b2": torch.zeros((num_experts, d_model), device=dev)}


def _expert_ffn(w1, b1, w2, b2, x):
    """x (E, n, D) through per-expert FFNs — one batched einsum pair."""
    h = torch.relu(torch.einsum("end,edh->enh", x, w1) + b1[:, None, :])
    return torch.einsum("enh,ehd->end", h, w2) + b2[:, None, :]


def _gate(params: dict, x: torch.Tensor, top_k: int):
    return torch.topk(torch.softmax(x @ params["gate"], dim=-1), top_k,
                      dim=-1)


def moe_reference(params: dict, x: torch.Tensor,
                  top_k: int = 2) -> torch.Tensor:
    """Dense ground truth: every expert computes every token."""
    weights, experts = _gate(params, x, top_k)
    E = params["w1"].shape[0]
    all_out = _expert_ffn(params["w1"], params["b1"], params["w2"],
                          params["b2"], x.expand(E, *x.shape))
    rows = torch.arange(x.shape[0], device=x.device)
    out = torch.zeros_like(x)
    for k in range(top_k):
        out = out + weights[:, k:k + 1] * all_out[experts[:, k], rows]
    return out


def shard_moe_params(mesh: Mesh, params: dict) -> dict:
    """This rank's experts (the leading axis split over ep) and the
    whole gate, as new tensors on the mesh's device."""
    n_ep = mesh.axis_size(EP_AXIS)
    i = mesh.axis_index(EP_AXIS)
    E = params["w1"].shape[0]
    if E % n_ep:
        raise ValueError(f"{E} experts not divisible by ep={n_ep}")
    e = E // n_ep

    def put(t):
        return t.detach().to(mesh.device).contiguous().clone()
    return {"gate": put(params["gate"]),
            **{k: put(params[k][i * e:(i + 1) * e])
               for k in ("w1", "b1", "w2", "b2")}}


def _capacity(n_local: int, n_experts: int, factor: float) -> int:
    avg = n_local * 1.0 / n_experts  # per (local batch, expert) average
    return max(1, int(np.ceil(avg * factor)))


def dropped_tokens(params: dict, x: torch.Tensor, n_ep: int,
                   top_k: int = 2, capacity_factor: float = 2.0) -> int:
    """How many (token, choice) assignments the dispatch drops: each
    top-k round has its own capacity lanes, so counts are per (source
    rank, expert, k)."""
    with torch.no_grad():
        _, experts = _gate(params, x, top_k)
    experts = experts.cpu().numpy()
    E = params["w1"].shape[0]
    n_local = x.shape[0] // n_ep
    cap = _capacity(n_local, E, capacity_factor)
    dropped = 0
    for k in range(top_k):
        for dev in range(n_ep):
            loc = experts[dev * n_local:(dev + 1) * n_local, k]
            counts = np.bincount(loc, minlength=E)
            dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped


def make_moe(mesh: Mesh, num_experts: int, top_k: int = 2,
             capacity_factor: float = 2.0) -> Callable:
    """→ ``fn(sharded_params, x)``: this rank's slice of the token batch
    through the experts of every rank. Requires ``num_experts % n_ep ==
    0``."""
    n_ep = mesh.axis_size(EP_AXIS)
    if num_experts % n_ep:
        raise ValueError(f"{num_experts} experts not divisible by "
                         f"ep={n_ep}")
    e_local = num_experts // n_ep

    def fn(params: dict, x: torch.Tensor) -> torch.Tensor:
        n, d = x.shape
        dev = x.device
        cap = _capacity(n, num_experts, capacity_factor)
        weights, experts = _gate(params, x, top_k)
        out = torch.zeros_like(x)
        lanes = n_ep * e_local * cap
        for k in range(top_k):
            # destination = global expert id; rank id // e_local owns its
            # local expert id % e_local
            dest = experts[:, k]
            # lane position within each destination: the stable rank
            order = torch.argsort(dest, stable=True)
            sdest = dest[order]
            counts = torch.bincount(dest, minlength=num_experts)
            starts = torch.cumsum(counts, 0) - counts
            pos = torch.arange(n, device=dev) - starts[sdest]
            valid = pos < cap
            # lanes laid out (rank, local expert, cap): flat sdest * cap
            lane_v = (sdest * cap + pos)[valid]
            send_x = torch.zeros((lanes, d), dtype=x.dtype,
                                 device=dev).index_copy(
                0, lane_v, x[order[valid]])
            send_row = torch.full((lanes,), -1, dtype=torch.long,
                                  device=dev)
            send_row[lane_v] = order[valid]
            # dispatch / compute / return: after the tiled all_to_all dim
            # 0 indexes the SOURCE rank, so (src, cap) folds into the
            # expert's token axis, and back the same way
            recv_x = cops.all_to_all(
                send_x.view(n_ep, e_local, cap, d), mesh, EP_AXIS)
            recv_x = recv_x.transpose(0, 1).reshape(e_local, n_ep * cap, d)
            y = _expert_ffn(params["w1"], params["b1"], params["w2"],
                            params["b2"], recv_x)
            y = y.reshape(e_local, n_ep, cap, d).transpose(0, 1)
            back = cops.all_to_all(y.contiguous(), mesh, EP_AXIS)
            # outputs to their originating rows; empty lanes to row n
            safe = torch.where(send_row >= 0, send_row,
                               torch.full_like(send_row, n))
            gathered = torch.zeros((n + 1, d), dtype=x.dtype,
                                   device=dev).index_add(
                0, safe, back.reshape(-1, d))[:n]
            out = out + weights[:, k:k + 1] * gathered
        return out

    return fn
