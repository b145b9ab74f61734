from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig  # noqa: F401
from deepspeed_tpu_torch.inference.engine import InferenceEngine  # noqa: F401
from deepspeed_tpu_torch.inference.serving import (  # noqa: F401
    ServingEngine, create_serving_engine)
