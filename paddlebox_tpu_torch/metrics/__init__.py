from paddlebox_tpu_torch.metrics.auc import AucAccumulator  # noqa: F401
from paddlebox_tpu_torch.metrics.metric import MetricRegistry  # noqa: F401
from paddlebox_tpu_torch.metrics.auc_runner import AucRunner  # noqa: F401
