"""Host-side collectives over a rendezvous store — a copy of the JAX
package's ``distributed/collectives.py``.

Reference: ``GlooWrapper::Barrier/AllReduce/AllGather``
(gloo_wrapper.h:151-200) and ``boxps::MPICluster``'s host
barrier/allreduce_sum (box_wrapper.h:415, .cc:331-356 — the global-AUC
reduction path). These move small host values (metric tables, counters,
donefile decisions); bulk tensors go over the mesh's device group
(``parallel.mesh``), never here.

Every collective gets a fresh sequence number so the same store can host
unlimited rounds; rank 0 reduces and publishes, others wait (the
tree-reduce the reference gets from gloo is overkill at these sizes).
"""

from __future__ import annotations

import io
import json
from typing import Any, Callable

import numpy as np

from paddlebox_tpu_torch.distributed.store import FileStore


def _dump(obj: Any) -> bytes:
    """json + raw-ndarray framing — the same trust stance as ps.py: no
    pickle on anything that crosses a process boundary (a rendezvous store
    is exactly as attacker-reachable as a socket)."""
    if isinstance(obj, np.ndarray):
        buf = io.BytesIO()
        np.save(buf, obj, allow_pickle=False)
        return b"npy" + buf.getvalue()
    try:
        return b"jsn" + json.dumps(obj).encode()
    except TypeError as e:
        raise TypeError(
            f"host collectives carry JSON values or ndarrays, got "
            f"{type(obj).__name__}") from e


def _load(raw: bytes) -> Any:
    tag, body = raw[:3], raw[3:]
    if tag == b"npy":
        return np.load(io.BytesIO(body), allow_pickle=False)
    if tag == b"jsn":
        return json.loads(body.decode())
    raise ValueError(f"unknown collective frame tag {tag!r}")


_REDUCERS: dict[str, Callable] = {
    "sum": lambda xs: sum(xs[1:], xs[0]),
    "max": lambda xs: np.maximum.reduce(xs),
    "min": lambda xs: np.minimum.reduce(xs),
}


class HostCollectives:
    def __init__(self, store: FileStore, rank: int, world: int,
                 run_id: str = "", cleanup_lag: int = 8, watchdog=None):
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} outside world {world}")
        self.store = store
        self.rank = rank
        self.world = world
        # optional HeartbeatMonitor (distributed/resilience.py): its
        # check() is polled inside every store wait, so a dead or stalled
        # peer surfaces as a named-rank error instead of the full barrier
        # timeout
        self.watchdog = watchdog
        # run_id namespaces keys so a relaunched job against the same
        # persistent store dir never consumes a dead run's published values
        # (the launcher stamps PBTPU_RUN_ID per launch)
        self.run_id = run_id
        # Files this rank wrote, per round, unlinked `cleanup_lag` rounds
        # later so a long run doesn't grow the store without bound. The lag
        # is safe as long as no rank falls cleanup_lag collective rounds
        # behind — only possible via long chains of non-synchronizing
        # broadcasts (all_reduce/all_gather/barrier are full syncs).
        self.cleanup_lag = max(2, cleanup_lag)
        self._written: dict[int, list[str]] = {}
        self._seq = 0

    def _next(self, name: str) -> str:
        self._seq += 1
        old = self._written.pop(self._seq - self.cleanup_lag, None)
        if old:
            for key in old:
                self.store.delete(key)
        prefix = f"{self.run_id}." if self.run_id else ""
        return f"{prefix}{name}.{self._seq}"

    def _wrote(self, key: str) -> None:
        self._written.setdefault(self._seq, []).append(key)

    def _check(self):
        w = self.watchdog
        return w.check if w is not None else None

    def barrier(self, name: str = "barrier") -> None:
        if self.world == 1:
            return
        key = self._next(name)
        self.store.add(key, self.rank)
        self._wrote(f"{key}.{self.rank}")
        self.store.wait_count(key, self.world, check=self._check())

    def all_gather(self, value: Any, name: str = "gather") -> list[Any]:
        if self.world == 1:
            return [value]
        key = self._next(name)
        self.store.set(f"{key}.v{self.rank}", _dump(value))
        self._wrote(f"{key}.v{self.rank}")
        return [_load(self.store.wait(f"{key}.v{r}", check=self._check()))
                for r in range(self.world)]

    def all_reduce(self, value: np.ndarray, op: str = "sum",
                   name: str = "reduce") -> np.ndarray:
        """Exact reduction of a small array (AUC tables etc.)."""
        value = np.asarray(value)
        if self.world == 1:
            return value
        key = self._next(name)
        self.store.set(f"{key}.v{self.rank}", _dump(value))
        self._wrote(f"{key}.v{self.rank}")
        if self.rank == 0:
            parts = [_load(self.store.wait(f"{key}.v{r}",
                                           check=self._check()))
                     for r in range(self.world)]
            out = _REDUCERS[op](parts)
            self.store.set(f"{key}.out", _dump(out))
            self._wrote(f"{key}.out")
            return out
        return _load(self.store.wait(f"{key}.out", check=self._check()))

    def broadcast(self, value: Any, root: int = 0,
                  name: str = "bcast") -> Any:
        if self.world == 1:
            return value
        key = self._next(name)
        if self.rank == root:
            self.store.set(f"{key}.out", _dump(value))
            self._wrote(f"{key}.out")
            return value
        return _load(self.store.wait(f"{key}.out", check=self._check()))
