"""Dense-parameter sync strategies — the port of
``parallel/dense_sync.py``.

The reference trains dense params in one of three modes per
``BoxPSWorkerParameter.sync_mode`` (trainer_desc.proto:100-108,
boxps_worker.cc:481-521); ``TrainerConfig.dense_sync_mode`` names them:

- **allreduce** — the per-step global mean of the dense grads over the
  mesh (one flat all-reduce of every grad a step). The default.
- **kstep** — each rank updates its own dense copy with its local grads;
  every ``param_sync_step`` steps, and at the end of a pass, the
  *parameters* are averaged over the mesh (``SyncParam``: an all-reduce
  of the flat parameter vector scaled by 1/n — local-SGD semantics), and
  with ``sync_dense_moment`` the optimizer's moments too.
- **async** — ``AsyncDenseTable``, the host dense table
  (``BoxPSAsynDenseTable``, device_worker.h:586, boxps_worker.cc:37-296):
  each step pulls the whole flat parameter vector and pushes the flat
  global-mean grad through a queue; a background host thread merges up
  to ``merge_limit`` pending grads and applies a hand-rolled Adam-like
  update (betas 0.99 / 0.9999, cc:173-225) with optional per-range
  learning rates.

``flatten_dense`` / ``unflatten_dense`` move the dense parameters as one
flat float32 vector (the reference's single ``param_sync_`` tensor). The
JAX package's ``make_dense_packer`` has no counterpart: the port's step
is eager and carries no argument leaves to pack.
"""

from __future__ import annotations

import queue
import threading
from typing import Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.monitor import context as mon_ctx


def flatten_dense(params: Sequence[torch.Tensor]) -> np.ndarray:
    """Dense parameters → one flat float32 host vector, in order."""
    if not params:
        return np.zeros(0, np.float32)
    return torch.cat([p.detach().reshape(-1).to(torch.float32)
                      for p in params]).cpu().numpy()


def flat_tensor(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Tensors → one flat float32 tensor on their device (no host
    copy)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_into(flat: torch.Tensor,
                   tensors: Sequence[torch.Tensor]) -> None:
    """Copy a flat vector back into ``tensors`` in place, in order."""
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].reshape(t.shape))
        off += n
    if off != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values for "
                         f"{off} parameters")


class AsyncDenseTable:
    """Host-resident async dense parameter server (BoxPSAsynDenseTable).

    Staleness semantics match the reference: pulls return the latest applied
    params without waiting for in-flight grads; the updater thread merges up
    to ``merge_limit`` queued grads into one update step.
    """

    def __init__(self, flat_params: np.ndarray, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.99, 0.9999),
                 eps: float = 1e-8, merge_limit: int = 4,
                 lr_map: list[tuple[slice, float]] | None = None):
        self._params = np.array(flat_params, dtype=np.float32)
        self._mom1 = np.zeros_like(self._params)
        self._mom2 = np.zeros_like(self._params)
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.merge_limit = max(1, merge_limit)
        # per-range LR overrides (the GetLRMap per-param-name map, flattened;
        # (slice, lr) pairs — slices aren't hashable before 3.12)
        self._lr_vec = np.full_like(self._params, lr)
        for sl, r in (lr_map or []):
            self._lr_vec[sl] = r
        self._queue: queue.Queue[np.ndarray | None] = queue.Queue()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.steps_applied = 0
        self.grads_merged = 0

    # ---- worker side ----

    def pull(self) -> np.ndarray:
        with self._lock:
            return self._params.copy()

    def push(self, flat_grad: np.ndarray) -> None:
        self._queue.put(np.asarray(flat_grad, dtype=np.float32))

    # ---- updater thread (ThreadUpdate, boxps_worker.cc:173-225) ----

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = mon_ctx.spawn(self._run, name="async-dense-table")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join()
        self._thread = None

    def flush(self) -> None:
        """Block until every grad pushed so far has been applied."""
        self._queue.join()

    def _run(self) -> None:
        while True:
            grad = self._queue.get()
            if grad is None:
                self._queue.task_done()
                return
            merged, n = grad, 1
            # merge whatever else is already waiting, up to the limit
            while n < self.merge_limit:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._apply(merged, n)
                    for _ in range(n + 1):  # n grads + the stop sentinel
                        self._queue.task_done()
                    return
                merged = merged + nxt
                n += 1
            self._apply(merged, n)
            for _ in range(n):
                self._queue.task_done()

    # ---- checkpoint plane (the dense half of SaveBase/LoadModel) ----

    def state_dict(self) -> dict[str, np.ndarray]:
        with self._lock:
            return {"params": self._params.copy(),
                    "mom1": self._mom1.copy(), "mom2": self._mom2.copy(),
                    "steps": np.asarray([self.steps_applied])}

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        with self._lock:
            self._params[:] = state["params"]
            self._mom1[:] = state["mom1"]
            self._mom2[:] = state["mom2"]
            self.steps_applied = int(np.asarray(state["steps"]).reshape(-1)[0])

    def _apply(self, grad_sum: np.ndarray, n: int) -> None:
        g = grad_sum / n
        b1, b2 = self.betas
        with self._lock:
            self._mom1 *= b1
            self._mom1 += (1 - b1) * g
            self._mom2 *= b2
            self._mom2 += (1 - b2) * g * g
            self._params -= self._lr_vec * self._mom1 / (
                np.sqrt(self._mom2) + self.eps)
            self.steps_applied += 1
            self.grads_merged += n
