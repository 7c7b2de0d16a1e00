"""Tensor (model) parallelism — the port of
``paddlebox_tpu/parallel/tensor.py`` (``make_tp_mesh`` :30,
``init_tp_mlp`` :39, ``mlp_reference`` :56, ``plan_modes`` :63,
``shard_tp_params`` :91, ``make_tp_mlp`` :106).

Megatron-style sharded linears over a ``tp`` mesh axis:

- a column-parallel linear splits W along its OUT features: each rank
  computes its slice of the hidden layer, with no communication (the
  input is replicated; its gradient is all-reduced over tp on the way
  back, Megatron's ``f``);
- a row-parallel linear splits W along its IN features: each rank
  computes a partial product and one ``psum`` over tp restores the full
  output (Megatron's ``g``: identity on the way back).

One all-reduce per column→row block forward. The pattern composes with
dp: a 2-D ``("dp", "tp")`` mesh, the batch sharded over dp, the weights
over tp. In the port each rank is one process holding its shards
(``shard_tp_params``) and its slice of the batch; the MLP ``make_tp_mlp``
returns is numerically equal to ``mlp_reference``, and a trailing
column layer's output is gathered over tp, as JAX assembles the global
array. The parameters of a layer replicated over tp get the same
gradient on every tp rank; over a dp axis the caller sums them (as
data parallelism does).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.parallel import collective_ops as cops
from paddlebox_tpu_torch.parallel.mesh import Mesh, make_named_mesh

TP_AXIS = "tp"


def make_tp_mesh(n_tp: int, n_dp: int = 1, backend: str | None = None,
                 device: str | torch.device | None = None) -> Mesh:
    """``("tp",)``, or ``("dp", "tp")`` with ``n_dp > 1``, over the
    process group's ranks (the card unless ``device="cpu"``)."""
    axes = ([("dp", n_dp), (TP_AXIS, n_tp)] if n_dp > 1
            else [(TP_AXIS, n_tp)])
    return make_named_mesh(axes, backend=backend, device=device)


def init_tp_mlp(seed: int, dims: Sequence[int],
                device: str | torch.device | None = None
                ) -> list[dict[str, torch.Tensor]]:
    """Unsharded parameters for a [d0, d1, ..., dn] MLP (relu between,
    linear head): ``w`` ~ N(0, 1/d_in), ``b`` = 0."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        params.append({
            "w": torch.randn((din, dout), generator=gen, device=dev)
            / float(din) ** 0.5,
            "b": torch.zeros((dout,), device=dev)})
    return params


def mlp_reference(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def plan_modes(dims: Sequence[int], n_tp: int) -> list[str]:
    """Per-layer parallel mode: "col" (OUT sharded), "row" (IN sharded,
    psum), or "rep" (replicated — e.g. a width-1 head).

    Greedy: col whenever features are complete and OUT divides by tp; row
    whenever features arrive sharded (its IN is the previous col's OUT);
    rep otherwise. A col layer is therefore always followed by a row
    layer (or ends the MLP) — no gathers inside."""
    modes, sharded = [], False
    for din, dout in zip(dims[:-1], dims[1:]):
        if sharded:
            modes.append("row")
            sharded = False
        elif dout % n_tp == 0:
            modes.append("col")
            sharded = True
        else:
            modes.append("rep")
    return modes


def _mlp_dims(params: list[dict]) -> list[int]:
    return [int(params[0]["w"].shape[0])] + [int(p["w"].shape[1])
                                             for p in params]


def shard_tp_params(mesh: Mesh, params: list[dict]) -> list[dict]:
    """This rank's shards per the mode plan (col: OUT split and a
    sharded bias; row: IN split and the whole bias; rep: whole), as new
    tensors on the mesh's device."""
    n_tp = mesh.axis_size(TP_AXIS)
    i = mesh.axis_index(TP_AXIS)
    out = []
    for p, mode in zip(params, plan_modes(_mlp_dims(params), n_tp)):
        w, b = p["w"], p["b"]
        if mode == "col":
            k = w.shape[1] // n_tp
            w, b = w[:, i * k:(i + 1) * k], b[i * k:(i + 1) * k]
        elif mode == "row":
            k = w.shape[0] // n_tp
            w = w[i * k:(i + 1) * k]
        out.append({"w": w.detach().to(mesh.device).contiguous().clone(),
                    "b": b.detach().to(mesh.device).contiguous().clone()})
    return out


def make_tp_mlp(mesh: Mesh, dims: Sequence[int],
                dp_axis: str | None = None) -> Callable:
    """→ ``fn(sharded_params, x)`` running the planned col/row/rep MLP
    with one psum per row layer; numerically equal to ``mlp_reference``.

    ``x`` is this rank's batch: the whole batch (replicated over tp),
    or, with ``dp_axis``, this rank's dp slice of it. The output is this
    rank's rows of the full output."""
    if dp_axis is not None:
        mesh.axis_size(dp_axis)            # a named axis of this mesh
    n_tp = mesh.axis_size(TP_AXIS)
    modes = plan_modes(dims, n_tp)
    n_layers = len(modes)

    def fn(params: list[dict], x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, (p, mode) in enumerate(zip(params, modes)):
            if mode == "row":
                # partial product + one tp all-reduce
                h = cops.psum(h @ p["w"], mesh, TP_AXIS) + p["b"]
            elif mode == "col":
                # the replicated input enters a sharded layer
                h = cops.copy_to(h, mesh, TP_AXIS) @ p["w"] + p["b"]
            else:
                h = h @ p["w"] + p["b"]
            if i < n_layers - 1:
                # relu is elementwise: valid on column-sharded features
                h = torch.relu(h)
        if modes[-1] == "col":
            h = cops.all_gather_last(h, mesh, TP_AXIS)
        return h

    return fn
