from paddlebox_tpu_torch.fleet.boxps import BoxPS  # noqa: F401
