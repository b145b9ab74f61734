from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    CausalTransformerLM, TransformerConfig)
from deepspeed_tpu_torch.models.convert import from_jax_params  # noqa: F401
