from paddlebox_tpu_torch.parallel.mesh import (DP_AXIS, NODE_AXIS,  # noqa: F401
                                               Mesh, make_mesh)
from paddlebox_tpu_torch.parallel.dense_sync import (  # noqa: F401
    AsyncDenseTable, flatten_dense)
