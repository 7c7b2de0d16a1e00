"""Host-side distributed control plane — the port of
``paddlebox_tpu/distributed``.

- ``FileStore`` — shared-filesystem rendezvous KV;
- ``HostCollectives`` — barrier / allreduce / allgather / broadcast for
  small host values over a ``FileStore``;
- ``ShardOwnership`` — which store shards this rank's feeds build;
- ``RoleMaker`` — rank / world from the launcher's environment, and
  ``init_distributed``, which joins the ``torch.distributed`` group;
- ``launch`` — one process per card
  (``python -m paddlebox_tpu_torch.distributed.launch``);
- ``resilience`` — the heartbeat watchdog (named dead or hung ranks
  through every collective wait), the coordinated resume election and
  the elastic world (shrink to N-1 and continue, admit to grow);
- ``ps`` — the host parameter-server cluster (sharded sparse tables with
  in-table optimizers, async dense tables, save/load/shrink over TCP).

Device-side collectives never touch this: they run on the mesh's
process group (``parallel.mesh``).
"""

from paddlebox_tpu_torch.distributed.store import FileStore  # noqa: F401
from paddlebox_tpu_torch.distributed.ownership import (  # noqa: F401
    ShardOwnership)
from paddlebox_tpu_torch.distributed.collectives import (  # noqa: F401
    HostCollectives)
from paddlebox_tpu_torch.distributed.role_maker import RoleMaker  # noqa: F401
from paddlebox_tpu_torch.distributed.resilience import (  # noqa: F401
    ElasticWorld, HeartbeatMonitor, PeerFailureError, PeerLostError,
    PeerStalledError, WorldFencedError, WorldTooSmallError,
    coordinated_resume)
from paddlebox_tpu_torch.distributed.ps import (PSClient,  # noqa: F401
                                                PSServer,
                                                RemoteEmbeddingStore)
