"""Cluster role discovery and the process-group join — the port of
``distributed/role_maker.py``.

The launcher (``distributed.launch``) hands every rank its id, the
world's endpoints, a coordinator address, a rendezvous store directory
and a run id through ``PBTPU_*`` variables, as the JAX package's does.
``init_distributed`` then calls ``torch.distributed.init_process_group``
where the JAX package calls ``jax.distributed.initialize``: the address
is ``PBTPU_COORDINATOR`` or ``endpoints[0]``, the world size the
endpoint count. One process drives one card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from paddlebox_tpu_torch.distributed.collectives import HostCollectives
from paddlebox_tpu_torch.distributed.store import FileStore

ENV_RANK = "PBTPU_TRAINER_ID"
ENV_ENDPOINTS = "PBTPU_TRAINER_ENDPOINTS"
ENV_COORDINATOR = "PBTPU_COORDINATOR"
ENV_STORE = "PBTPU_STORE_DIR"
ENV_RUN_ID = "PBTPU_RUN_ID"
ENV_LOCAL_RANK = "LOCAL_RANK"


@dataclass
class RoleMaker:
    rank: int = 0
    endpoints: list[str] = field(default_factory=lambda: ["localhost:0"])
    store_dir: str | None = None
    run_id: str = ""
    # the process group's rendezvous address; defaults to endpoints[0],
    # but a launcher that also serves on rank 0's endpoint hands out a
    # dedicated port (PBTPU_COORDINATOR) to avoid the bind collision
    coordinator: str | None = None
    local_rank: int = 0

    @classmethod
    def from_env(cls) -> "RoleMaker":
        rank = int(os.environ.get(ENV_RANK, "0"))
        eps = os.environ.get(ENV_ENDPOINTS, "localhost:0").split(",")
        return cls(rank=rank, endpoints=[e.strip() for e in eps if e.strip()],
                   store_dir=os.environ.get(ENV_STORE),
                   run_id=os.environ.get(ENV_RUN_ID, ""),
                   coordinator=os.environ.get(ENV_COORDINATOR) or None,
                   local_rank=int(os.environ.get(ENV_LOCAL_RANK, rank)))

    @property
    def world_size(self) -> int:
        return len(self.endpoints)

    @property
    def is_first_worker(self) -> bool:
        return self.rank == 0

    def with_members(self, members: list[int]) -> "RoleMaker":
        """A shrunk view of this role after an elastic re-formation:
        ``members`` are the surviving original ranks; the survivors keep
        their endpoints and renumber densely (the new rank is the index
        in the sorted member list), so everything built from a RoleMaker
        (shuffle services, PS maps, collectives) sees an ordinary world
        of the new size."""
        members = sorted(int(m) for m in members)
        if self.rank not in members:
            raise ValueError(
                f"rank {self.rank} is not among surviving members "
                f"{members} — a fenced rank has no shrunk role")
        return RoleMaker(rank=members.index(self.rank),
                         endpoints=[self.endpoints[m] for m in members],
                         store_dir=self.store_dir, run_id=self.run_id,
                         coordinator=self.coordinator,
                         local_rank=self.local_rank)

    def _check_store_env(self) -> None:
        if self.world_size > 1 and not self.store_dir:
            raise ValueError(
                f"multi-host run needs {ENV_STORE} (shared filesystem dir) "
                "for the rendezvous store")
        if self.world_size > 1 and not self.run_id:
            raise ValueError(
                f"multi-host run needs {ENV_RUN_ID}: without a per-launch "
                "run id, a restart against the same store dir would consume "
                "the dead run's published collective results (the launcher "
                "stamps this automatically; site scripts must set it, e.g. "
                "to the scheduler job id)")

    def base_store(self, timeout_s: float = 300.0) -> FileStore:
        """The launch's run-namespaced rendezvous store: every key this
        launch writes is prefixed with the run id, so a restarted job
        against the same store dir never consumes a dead run's keys."""
        self._check_store_env()
        if not self.store_dir:
            raise ValueError(f"no rendezvous store: set {ENV_STORE}")
        return FileStore(self.store_dir, timeout_s=timeout_s,
                         namespace=self.run_id)

    def collectives(self, timeout_s: float = 300.0) -> HostCollectives:
        return HostCollectives(self.base_store(timeout_s), self.rank,
                               self.world_size)

    def elastic_world(self, timeout_s: float = 300.0, **kw):
        """An :class:`~paddlebox_tpu_torch.distributed.resilience.
        ElasticWorld` for this launch: generation 0 spans every launched
        rank; on a peer failure the training loop calls ``world.reform``
        (usually through ``Trainer.recover_world``) to shrink and go on.
        Heartbeat and re-formation tunables pass through ``**kw``."""
        from paddlebox_tpu_torch.distributed.resilience import ElasticWorld
        return ElasticWorld(self.base_store(timeout_s), self.rank,
                            list(range(self.world_size)),
                            collectives_timeout_s=timeout_s, **kw)

    def init_distributed(self, backend: str | None = None,
                         device: str | None = None,
                         timeout_s: float = 300.0) -> str:
        """Join the world's ``torch.distributed`` process group.

        ``backend``: ``nccl`` (the default on the card) or ``gloo`` (the
        default with ``device="cpu"``, and the choice for several ranks
        sharing one card, which NCCL refuses). On the card the rank's
        device (``LOCAL_RANK``) is made current first, so NCCL binds the
        right card. Returns the backend."""
        import datetime

        import torch
        import torch.distributed as dist

        if dist.is_initialized():
            raise RuntimeError("the process group is already initialized")
        on_card = device != "cpu"
        if on_card:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_distributed: no CUDA device; pass device='cpu' "
                    "to join over gloo on the host")
            torch.cuda.set_device(self.local_rank
                                  % torch.cuda.device_count())
        be = backend or ("nccl" if on_card else "gloo")
        addr = self.coordinator or self.endpoints[0]
        dist.init_process_group(
            be, init_method=f"tcp://{addr}", world_size=self.world_size,
            rank=self.rank, timeout=datetime.timedelta(seconds=timeout_s))
        return be
