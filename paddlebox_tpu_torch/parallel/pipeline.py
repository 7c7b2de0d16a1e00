"""Pipeline parallelism — the port of ``paddlebox_tpu/parallel/pipeline.py``
(``split_stages`` :42, ``stack_stage_params`` :66, ``gpipe_spmd`` :72,
``make_pipeline`` :135, ``mlp_stage_fn`` :158).

GPipe over a ``pp`` mesh axis: one stage function whose parameters are
stacked with a leading stage axis, rank ``i`` of the axis holding stage
``i``'s slice (``shard_stage_params``); activations hop stage → stage
one ring step a tick (the differentiable ``ppermute`` of
``parallel/collective_ops.py``). With S stages and M microbatches the
loop runs M + S - 1 ticks, every stage computes each tick, a tick's
output is banked only once it is a real microbatch (the bubble's writes
are masked), and a ``psum`` from the last stage gives every rank of the
axis the whole output, so a loss around the pipeline is
stage-agnostic. Autograd through the ticks is the reverse schedule; no
backward is written by hand. Stages must be shape-homogeneous (stage
input == stage output).

``torch.distributed.pipelining`` is not used: its ``ScheduleGPipe`` runs
the forward and the backward inside one ``step()`` around a loss
function on the last stage and returns the output there alone, so it
gives neither the reference's ``fn(stacked, x) -> y`` replicated over
pp nor gradients by autograd around the call.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.parallel import collective_ops as cops
from paddlebox_tpu_torch.parallel.mesh import Mesh, make_named_mesh

PP_AXIS = "pp"


def make_pp_mesh(n_pp: int, n_dp: int = 1, backend: str | None = None,
                 device: str | torch.device | None = None) -> Mesh:
    """``("pp",)``, or ``("dp", "pp")`` with ``n_dp > 1``."""
    axes = ([("dp", n_dp), (PP_AXIS, n_pp)] if n_dp > 1
            else [(PP_AXIS, n_pp)])
    return make_named_mesh(axes, backend=backend, device=device)


def split_stages(layers: Sequence[Any],
                 num_stages: int | None = None,
                 cut_list: Sequence[int] | None = None) -> list[list[Any]]:
    """Group a flat layer list into pipeline stages. ``cut_list`` gives
    the index of the first layer of each stage after the zeroth; without
    one, the layers split into ``num_stages`` near-equal groups."""
    n = len(layers)
    if cut_list is not None:
        cuts = [0, *cut_list, n]
        if any(b <= a for a, b in zip(cuts[:-1], cuts[1:])):
            raise ValueError(
                f"cut_list {cut_list} must be strictly increasing within "
                f"(0,{n}) — every stage needs at least one layer")
        return [list(layers[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    if not num_stages or num_stages < 1:
        raise ValueError("need num_stages or cut_list")
    if num_stages > n:
        raise ValueError(f"num_stages={num_stages} > {n} layers — every "
                         f"stage needs at least one layer")
    bounds = np.linspace(0, n, num_stages + 1).round().astype(int)
    return [list(layers[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage: Sequence[Any]) -> Any:
    """Stack per-stage trees (identical structure) along a new leading
    stage axis — the tensors the ``pp`` axis shards."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage)


def shard_stage_params(mesh: Mesh, stacked: Any,
                       axis: str = PP_AXIS) -> Any:
    """This rank's stage: every leaf's ``[i:i + 1]`` slice (a leading
    stage axis of size 1, as ``shard_map`` slices it), as new tensors
    on the mesh's device."""
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)

    def take(a):
        if a.shape[0] != n:
            raise ValueError(f"stacked leading axis {a.shape[0]} != "
                             f"{axis} size {n}")
        return a[i:i + 1].detach().to(mesh.device).contiguous().clone()
    return _tree_map(take, stacked)


def gpipe_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
               stage_params: Any, x: torch.Tensor, num_microbatches: int,
               mesh: Mesh, axis_name: str = PP_AXIS) -> torch.Tensor:
    """Run the GPipe schedule on this rank's stage.

    stage_params : this rank's stage slice, leaves with a leading stage
                   axis of size 1 (``shard_stage_params``).
    x            : (B, ...) this rank's whole local batch (the same on
                   every rank of the pp axis; a dp slice when composed
                   with data parallelism).
    Returns the last stage's outputs for every microbatch, (B, ...), on
    every rank of the pp axis."""
    S = mesh.axis_size(axis_name)
    stage = mesh.axis_index(axis_name)
    params = _tree_map(lambda a: a[0], stage_params)   # drop stage axis
    M = int(num_microbatches)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    xm = x.reshape(M, B // M, *x.shape[1:])
    recv = torch.zeros_like(xm[0])
    # the stage tests are tensors, so every rank builds the same graph:
    # each rank's backward then runs every ppermute's transpose (a
    # collective) in the same order, stage 0 and the masked outputs
    # included (they pass zero cotangents, as JAX's where does)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == S - 1, device=x.device)
    outs: list = [None] * M
    ticks = M + S - 1
    for t in range(ticks):
        # stage 0 feeds microbatch t (clamped: past M its output is never
        # banked); later stages consume what arrived last tick
        inp = torch.where(first, xm[min(t, M - 1)].to(recv.dtype), recv)
        y = stage_fn(params, inp)
        # the last stage banks microbatch t - (S - 1) once it is real;
        # the bubble's ticks (slot < 0) write nothing
        slot = t - (S - 1)
        if slot >= 0:
            outs[slot] = y
        if t < ticks - 1:
            # activations one hop forward around the ring
            recv = cops.ppermute(y, mesh, axis_name, 1)
    out = torch.stack(outs)
    # only stage S-1 holds the real outputs; the psum gives them to the
    # whole pp ring
    out = cops.psum(torch.where(last, out, torch.zeros_like(out)),
                    mesh, axis_name)
    return out.reshape(B, *x.shape[1:])


def make_pipeline(mesh: Mesh,
                  stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  num_microbatches: int, pp_axis: str = PP_AXIS,
                  dp_axis: str | None = None) -> Callable:
    """→ ``fn(stage_params, x) -> y`` over this rank's stage
    (``shard_stage_params``) and its batch (the dp slice when ``dp_axis``
    is given, else the whole batch); differentiable — a loss around it
    and ``backward()`` train it."""
    mesh.axis_size(pp_axis)
    if dp_axis is not None:
        mesh.axis_size(dp_axis)

    def fn(stage_params, x):
        return gpipe_spmd(stage_fn, stage_params, x, num_microbatches,
                          mesh, axis_name=pp_axis)

    return fn


def mlp_stage_fn(activation: Callable[[torch.Tensor], torch.Tensor]
                 = torch.relu):
    """Stage function of a homogeneous dense tower: params
    ``{"w": (L, D, D), "b": (L, D)}`` — L layers a stage, width D."""
    def fn(params, x):
        h = x
        for w, b in zip(params["w"], params["b"]):
            h = activation(h @ w + b)
        return h
    return fn
