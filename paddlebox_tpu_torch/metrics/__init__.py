from paddlebox_tpu_torch.metrics.auc import AucAccumulator  # noqa: F401
