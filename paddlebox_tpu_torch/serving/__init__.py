"""Online model publish and hot-swap serving — the port of
``paddlebox_tpu/serving/``: ``ServingPublisher`` ships a versioned
base/delta artifact from every pass, announced only after it verified;
``ServingServer`` tails the donefile, verifies and hot-swaps under load;
``BatchingFrontend`` batches a request stream into it; ``ServingObs``
attributes latency, scores and AUC per version. The fleet
(``serving/fleet.py``, ``router.py``) is not ported yet (ROADMAP)."""

from paddlebox_tpu_torch.serving.artifact import (read_artifact,
                                                  version_name,
                                                  write_artifact)
from paddlebox_tpu_torch.serving.frontend import BatchingFrontend
from paddlebox_tpu_torch.serving.obs import ServingObs
from paddlebox_tpu_torch.serving.publisher import DONEFILE, ServingPublisher
from paddlebox_tpu_torch.serving.server import (ServingModel, ServingServer,
                                                ServingUnavailableError)

__all__ = ["ServingPublisher", "ServingServer", "ServingModel",
           "ServingUnavailableError", "BatchingFrontend", "ServingObs",
           "DONEFILE", "read_artifact", "write_artifact", "version_name"]
