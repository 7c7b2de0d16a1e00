from paddlebox_tpu_torch.models.dnn_ctr import DNNCTRModel  # noqa: F401
from paddlebox_tpu_torch.models.deepfm import DeepFMModel  # noqa: F401
from paddlebox_tpu_torch.models.wide_deep import WideDeepModel  # noqa: F401
from paddlebox_tpu_torch.models.dcn import DCNv2Model  # noqa: F401
from paddlebox_tpu_torch.models.dlrm import DLRMModel  # noqa: F401
from paddlebox_tpu_torch.models.dlrm import DLRMDCNv2Model  # noqa: F401
from paddlebox_tpu_torch.models.mmoe import MMoEModel  # noqa: F401
from paddlebox_tpu_torch.models.pv_rank import PVRankModel  # noqa: F401

# the JAX package's zoo; DLRMDCNv2Model, which the JAX package lacks, is
# outside it
MODEL_REGISTRY = {
    m.name: m for m in (DNNCTRModel, DeepFMModel, WideDeepModel,
                        DCNv2Model, DLRMModel, MMoEModel, PVRankModel)
}
