from paddlebox_tpu_torch.ops.cvm import cvm  # noqa: F401
from paddlebox_tpu_torch.ops.seqpool_cvm import (PooledSlots,  # noqa: F401
                                                 fused_seqpool_cvm)
