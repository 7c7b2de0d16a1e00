"""Host-side distributed control plane — the port of
``paddlebox_tpu/distributed``.

- ``FileStore`` — shared-filesystem rendezvous KV;
- ``HostCollectives`` — barrier / allreduce / allgather / broadcast for
  small host values over a ``FileStore``;
- ``ShardOwnership`` — which store shards this rank's feeds build;
- ``RoleMaker`` — rank / world from the launcher's environment, and
  ``init_distributed``, which joins the ``torch.distributed`` group;
- ``launch`` — one process per card
  (``python -m paddlebox_tpu_torch.distributed.launch``).

Device-side collectives never touch this: they run on the mesh's
process group (``parallel.mesh``). Not ported yet (ROADMAP queue 1 item
6): the heartbeat watchdog and coordinated resume (``resilience``) and
the host parameter server (``ps``).
"""

from paddlebox_tpu_torch.distributed.store import FileStore  # noqa: F401
from paddlebox_tpu_torch.distributed.ownership import (  # noqa: F401
    ShardOwnership)
from paddlebox_tpu_torch.distributed.collectives import (  # noqa: F401
    HostCollectives)
from paddlebox_tpu_torch.distributed.role_maker import RoleMaker  # noqa: F401
