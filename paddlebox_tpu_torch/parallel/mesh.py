"""The device mesh — the port of ``parallel/mesh.py``.

The JAX package drives every chip of a host from one process: its table
and batches are sharded over a ``("node", "dp")`` ``Mesh`` and its bulk
collectives run inside ``shard_map``. In PyTorch the idiom is one
process per card, so a port rank plays the part of a JAX host with one
local device:

- ``make_mesh(num_devices, num_nodes)`` names the ranks of the
  ``torch.distributed`` process group as a ``DeviceMesh`` with the axes
  ``("dp",)`` or ``("node", "dp")``; rank ``r`` is the flat device
  ``r = node * dp_size + dp`` of the JAX mesh, so it holds table shard
  ``r`` and the ``r``-th contiguous slice of every global batch
  (``batch_slice``, JAX's ``batch_sharding``; ``table_rows``, JAX's
  ``table_sharding``).
- The device collectives the JAX step gets from XLA, over a named axis
  or a tuple of axes: ``all_to_all`` (tiled on dim 0), ``psum``,
  ``pmean`` and ``all_gather``.
- ``host_psum`` reduces small host values (loss vectors, histograms,
  drop counts, touch bitmaps) over a gloo group kept beside the device
  group.
- ``shift`` moves each rank's tensor one hop around the ring of an axis
  (``lax.ppermute`` with the perm ``d → d + offset``), by
  ``dist.batch_isend_irecv``: the sends and receives of a hop are posted
  together, so a ring never deadlocks on blocking pairs.
- ``make_named_mesh(axes)`` builds a mesh with any named axes (the
  parallel modules' ``("dp", "tp")``, ``("ep",)``, ``("dp", "pp")``);
  ``axis_index`` is this rank's position along an axis.
  ``parallel/collective_ops.py`` wraps the collectives as autograd
  Functions for the modules that differentiate through them.

The backend is the caller's: ``nccl`` on the card by default, ``gloo``
where the caller asks for it. With ``gloo`` and CUDA tensors every
collective copies through pinned host buffers — that is what the gloo
backend is (its collectives take CPU tensors), chosen by name; it is
never a fallback taken because NCCL failed.

At world 1 the collectives are the identity except ``psum`` /
``pmean`` / ``all_gather``, which still run on the group (an NCCL
all-reduce of one rank returns its input's bits).
"""

from __future__ import annotations

import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from paddlebox_tpu_torch.device import resolve_device

# Canonical axis names (the JAX package's)
NODE_AXIS = "node"
DP_AXIS = "dp"
BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Mesh:
    """The ``("node", "dp")`` mesh over the ranks of the process group.

    ``device`` is where this rank's table shard and batch slice live;
    ``backend`` the group's backend. Collective methods take the axis
    names they reduce over (a name or a tuple of names; the tuple of
    every axis is the whole world)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...],
                 device: torch.device, backend: str, device_mesh):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device = device
        self.backend = backend
        self.device_mesh = device_mesh
        self.world = int(np.prod(self.shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        # the all-to-alls this rank ran and the bytes it handed them (its
        # own chunk included), and the host seconds the staged (gloo on
        # CUDA tensors) collectives took, copies included
        self.a2a_calls = 0
        self.a2a_bytes = 0
        self.staged_seconds = 0.0
        # host control values travel over gloo whatever the device
        # backend is (an NCCL group takes CUDA tensors only)
        self._host_group = (dist.new_group(backend="gloo")
                            if backend != "gloo" and self.world > 1
                            else None)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axes={self.axis_names}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")

    # -- axes ------------------------------------------------------------

    def _axes(self, axes) -> tuple[str, ...]:
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in mesh axes "
                                 f"{self.axis_names}")
        return axes

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``):
        ranks fill the mesh in row-major order."""
        (axis,) = self._axes(axis)
        i = self.axis_names.index(axis)
        stride = int(np.prod(self.shape[i + 1:]))
        return (self.rank // stride) % self.shape[i]

    def axis_size(self, axes=None) -> int:
        axes = self._axes(axes)
        return int(np.prod([self.shape[self.axis_names.index(a)]
                            for a in axes]))

    def group(self, axes=None):
        """The process group spanning ``axes`` through this rank."""
        axes = self._axes(axes)
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        if len(axes) != 1:
            raise ValueError(f"axes {axes} must be one axis or all of "
                             f"{self.axis_names}")
        return self.device_mesh.get_group(axes[0])

    # -- slices ----------------------------------------------------------

    def batch_slice(self, batch: int) -> slice:
        """This rank's contiguous slice of a global batch of ``batch``
        examples (JAX ``batch_sharding``: ``P(axes)`` on dim 0)."""
        if batch % self.world:
            raise ValueError(f"global batch {batch} does not divide by "
                             f"the mesh size {self.world}")
        b = batch // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def table_rows(self, rows_per_shard: int) -> slice:
        """This rank's row range of the global working-set table (JAX
        ``table_sharding``: rows contiguously sharded over all axes)."""
        return slice(self.rank * rows_per_shard,
                     (self.rank + 1) * rows_per_shard)

    # -- device collectives ----------------------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective runs on: ``t``, or its copy in a
        pinned host buffer under gloo."""
        if not self._staged(t):
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def _back(self, host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if not self._staged(like):
            return host
        return host.to(like.device, non_blocking=True)

    def all_to_all(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Tiled all-to-all on dim 0 over ``axes`` (``lax.all_to_all(x,
        axes, 0, 0, tiled=True)``): chunk i of the n equal dim-0 chunks
        goes to the rank at position i of the group, and the result
        holds the chunks received, in sender order."""
        n = self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) does not "
                             f"split into {n} chunks")
        if x.numel() == 0:
            return x
        t0 = time.perf_counter()
        # bytes on the wire: every dtype crosses both backends as uint8
        # (gloo has no bfloat16); the dim-0 split is unchanged
        src = self._out(x)
        flat = src.reshape(x.shape[0], -1).view(torch.uint8)
        out = torch.empty_like(flat, pin_memory=self._staged(x))
        dist.all_to_all_single(out, flat, group=self.group(axes))
        got = self._back(out.view(x.dtype).reshape(x.shape), x)
        self.a2a_calls += 1
        self.a2a_bytes += flat.numel()
        if self._staged(x):
            self.staged_seconds += time.perf_counter() - t0
        return got

    def psum(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Sum over the group of ``axes`` (a new tensor)."""
        t0 = time.perf_counter()
        t = self._out(x) if self._staged(x) else x.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axes))
        out = self._back(t, x)
        if self._staged(x):
            self.staged_seconds += time.perf_counter() - t0
        return out

    def shift(self, x: torch.Tensor, axis: str, offset: int = 1
              ) -> torch.Tensor:
        """The tensor of the rank ``offset`` hops back along ``axis``'s
        ring: each rank sends ``x`` to position ``(i + offset) % n`` and
        receives from ``(i - offset) % n`` (``lax.ppermute``). Bytes
        cross as uint8, so every dtype travels over both backends."""
        n = self.axis_size(axis)
        if n == 1 or offset % n == 0:
            return x
        t0 = time.perf_counter()
        group = self.group(axis)
        me = dist.get_rank(group)
        dst = dist.get_global_rank(group, (me + offset) % n)
        src = dist.get_global_rank(group, (me - offset) % n)
        send = self._out(x).reshape(-1).view(torch.uint8)
        recv = torch.empty_like(send, pin_memory=self._staged(x))
        ops = [dist.P2POp(dist.isend, send, dst, group=group),
               dist.P2POp(dist.irecv, recv, src, group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = self._back(recv.view(x.dtype).reshape(x.shape), x)
        if self._staged(x):
            self.staged_seconds += time.perf_counter() - t0
        return out

    def pmean(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        return self.psum(x, axes) / self.axis_size(axes)

    def all_gather(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """Concatenate every rank's ``x`` on dim 0, in group order."""
        n = self.axis_size(axes)
        src = self._out(x)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group(axes))
        return self._back(torch.cat(parts, dim=0), x)

    # -- host control values ---------------------------------------------

    def host_psum(self, arr) -> np.ndarray:
        """Sum of a small host array over the whole world (float64 and
        int64 stay exact), over gloo."""
        a = np.ascontiguousarray(arr)
        if self.world == 1:
            return a.copy()
        t = torch.from_numpy(a.copy())
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._host_group)
        return t.numpy()

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self._host_group)

    def collectives(self) -> "MeshHostCollectives":
        """A ``HostCollectives``-shaped view (``all_reduce(arr, op)``,
        ``barrier``, ``rank``, ``world``) over this mesh's host group, for
        ``AucAccumulator.compute_global`` and the like."""
        return MeshHostCollectives(self)


class MeshHostCollectives:
    """``all_reduce`` / ``barrier`` over a mesh's host group, with the
    call shapes of ``distributed.HostCollectives``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.rank = mesh.rank
        self.world = mesh.world

    def all_reduce(self, arr, op: str = "sum") -> np.ndarray:
        if op not in ("sum", "mean"):
            raise ValueError(f"op={op!r} (want sum|mean)")
        out = self.mesh.host_psum(np.asarray(arr, np.float64))
        return out / self.world if op == "mean" else out

    def barrier(self, name: str = "barrier") -> None:
        self.mesh.barrier()


def _join(backend, dev):
    """The process group (a world of one formed here when none exists)
    and its backend, checked against the caller's ``backend``."""
    if not dist.is_initialized():
        be = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if be not in BACKENDS:
            raise ValueError(f"backend={be!r} (want one of {BACKENDS})")
        dist.init_process_group(be, init_method=f"tcp://127.0.0.1:"
                                f"{free_port()}", world_size=1, rank=0)
    be = dist.get_backend()
    if backend is not None and backend != be:
        raise ValueError(f"make_mesh(backend={backend!r}): the process "
                         f"group runs {be!r}")
    if be == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group needs device='cuda'")
    return be


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_named_mesh(axes, backend: str | None = None,
                    device: str | torch.device | None = None) -> Mesh:
    """A mesh over the process group's ranks with the named ``axes``
    (``[(name, size), ...]``, outermost first; their product must be
    the world size). ``backend`` and ``device`` as in :func:`make_mesh`;
    with no process group yet a world of one is formed here."""
    axes = [(str(a), int(n)) for a, n in axes]
    names = tuple(a for a, _ in axes)
    shape = tuple(n for _, n in axes)
    if len(set(names)) != len(names) or any(n < 1 for n in shape):
        raise ValueError(f"mesh axes {axes}: names must differ and sizes "
                         f"be >= 1")
    dev = _rank_device(device)
    n = int(np.prod(shape))
    if not dist.is_initialized() and n != 1:
        raise RuntimeError(
            f"a mesh of {n} ranks needs a process group — join the world "
            f"first (RoleMaker.init_distributed, one process per card "
            f"through distributed.launch)")
    be = _join(backend, dev)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(axes)} has {n} ranks in a world of "
                         f"{world}: one rank per device")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if be == "nccl" else "cpu", shape,
                          mesh_dim_names=names)
    return Mesh(shape, names, dev, be, dm)


def make_mesh(num_devices: int | None = None, num_nodes: int = 1,
              backend: str | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """Build the ``(node, dp)`` mesh over the process group's ranks.

    One node: a 1-D ``("dp",)`` mesh; ``num_nodes > 1``: 2-D
    ``("node", "dp")``. ``num_devices`` must equal the world size (None =
    the world). With no process group yet, a world of one is formed here
    on a free localhost port; a larger world must have been joined first
    (``RoleMaker.init_distributed``). ``backend``: the group's, or
    ``nccl`` on the card / ``gloo`` on the CPU when the group is formed
    here. ``device``: this rank's device (the card unless ``"cpu"``);
    the card's index is the current CUDA device, which the launcher set
    from ``LOCAL_RANK`` before the group formed."""
    dev = _rank_device(device)
    if not dist.is_initialized() and num_devices not in (None, 1):
        raise RuntimeError(
            f"make_mesh({num_devices}): no process group — join the "
            f"world first (RoleMaker.init_distributed, one process per "
            f"card through distributed.launch)")
    _join(backend, dev)
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"make_mesh({n}) in a world of {world} ranks: one "
                         f"rank per device")
    if num_nodes > 1:
        if n % num_nodes:
            raise ValueError(f"{n} devices not divisible by {num_nodes} "
                             f"nodes")
        axes = [(NODE_AXIS, num_nodes), (DP_AXIS, n // num_nodes)]
    else:
        axes = [(DP_AXIS, n)]
    return make_named_mesh(axes, device=dev)


def shard_axes(mesh: Mesh) -> tuple[str, ...]:
    """All mesh axes, in order — the embedding table shards over the
    product."""
    return tuple(mesh.axis_names)


def num_shards(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.world

