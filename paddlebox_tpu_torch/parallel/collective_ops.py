"""Differentiable collectives over a named mesh axis — what ``shard_map``
gives the JAX package's parallel modules (``parallel/tensor.py``,
``expert.py``, ``sequence.py``, ``pipeline.py``) for free, as
``torch.autograd.Function``s over ``parallel/mesh.Mesh``.

The convention is JAX's: a value the caller sees as replicated over an
axis (the output of a ``psum``, the pipeline's broadcast result) has its
loss computed once per rank on identical values, so its cotangent is the
same full cotangent on every rank.

- :func:`psum` — all-reduce forward, identity backward: the Megatron
  ``g`` of a row-parallel layer (JAX's ``psum`` of a device-varying
  value transposes to a ``pvary``, no communication).
- :func:`copy_to` — identity forward, all-reduce backward: Megatron's
  ``f``, where a replicated activation enters a column-parallel layer
  (JAX's implicit ``pvary``, whose transpose is a ``psum``).
- :func:`all_to_all` — tiled on dim 0 (``lax.all_to_all(x, axis, 0, 0,
  tiled=True)``); its backward is the same all-to-all, its own inverse.
- :func:`ppermute` — shift one hop around the axis's ring (``perm = [(d,
  d + offset)]``); the backward shifts the cotangent the other way.
- :func:`all_gather_last` — concatenate the ranks' last-dim shards (a
  trailing column-parallel layer's output, gathered as JAX assembles the
  global array); the backward keeps this rank's slice of the cotangent.

Each function is the identity at an axis of size 1 except ``psum``,
which still runs on the group.
"""

from __future__ import annotations

import torch


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.mesh.axis_size(ctx.axis) == 1:
            return g, None, None
        return ctx.mesh.psum(g.contiguous(), ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axis), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        return mesh.shift(x.contiguous(), axis, offset)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.shift(g.contiguous(), ctx.axis, -ctx.offset),
                None, None, None)


class _AllGatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        n = mesh.axis_size(axis)
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, x.shape[-1]
        if n == 1:
            return x.view_as(x)
        # all_gather concatenates on dim 0: move the last dim there
        parts = mesh.all_gather(x.movedim(-1, 0).contiguous(), axis)
        return parts.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        w = ctx.width
        return g[..., i * w:(i + 1) * w], None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _Psum.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axis)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh, axis: str,
             offset: int = 1) -> torch.Tensor:
    if mesh.axis_size(axis) == 1:
        return x
    return _Ppermute.apply(x, mesh, axis, int(offset))


def all_gather_last(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _AllGatherLast.apply(x, mesh, axis)
