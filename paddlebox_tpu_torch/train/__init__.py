from paddlebox_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
