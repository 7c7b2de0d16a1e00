from paddlebox_tpu_torch.models.deepfm import DeepFMModel  # noqa: F401
