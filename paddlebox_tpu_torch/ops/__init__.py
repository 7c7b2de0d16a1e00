from paddlebox_tpu_torch.ops.cvm import cvm  # noqa: F401
from paddlebox_tpu_torch.ops.seqpool_cvm import (  # noqa: F401
    PooledSlots, fused_gather_seqpool_cvm, fused_seqpool_cvm,
    fused_seqpool_cvm_with_conv, fused_seqpool_cvm_with_pcoc)
from paddlebox_tpu_torch.ops.rank_attention import (  # noqa: F401
    build_rank_offset, rank_attention)
from paddlebox_tpu_torch.ops.batch_fc import batch_fc  # noqa: F401
from paddlebox_tpu_torch.ops.cross_norm import (  # noqa: F401
    cross_norm_hadamard, data_norm, init_summary, summary_update)
from paddlebox_tpu_torch.ops.fused_concat import fused_concat  # noqa: F401
from paddlebox_tpu_torch.ops.extended import (  # noqa: F401
    pull_box_extended_sparse)
from paddlebox_tpu_torch.ops.share_embedding import (  # noqa: F401
    ShareEmbeddingModel, select_share_embedding)
