from paddlebox_tpu_torch.inference.serving_table import ServingTable  # noqa: F401
from paddlebox_tpu_torch.inference.export import (  # noqa: F401
    save_inference_model, load_inference_model, model_config)
from paddlebox_tpu_torch.inference.predictor import Predictor  # noqa: F401
