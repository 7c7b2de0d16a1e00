from paddlebox_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
from paddlebox_tpu_torch.train.heter import HeterConfig, HeterTrainer  # noqa: F401
from paddlebox_tpu_torch.train.phased import PhasedTrainer  # noqa: F401
