from paddlebox_tpu_torch.fleet.boxps import BoxPS  # noqa: F401
from paddlebox_tpu_torch.fleet.fleet_util import FleetUtil  # noqa: F401
