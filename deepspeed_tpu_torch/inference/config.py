"""Inference config.

Counterpart of ``deepspeed_tpu/inference/config.py``: the same keys and
defaults.  TP degree comes from ``tensor_parallel.tp_size`` or the legacy
``mp_size``.
"""

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    enabled = True
    tp_size = 1
    mpu = None
    tp_group = None


class QuantizationConfig(DeepSpeedConfigModel):
    enabled = False
    num_bits = 8
    group_size = 64


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    dtype = "bfloat16"
    tensor_parallel = {}
    mp_size = None  # legacy alias of tensor_parallel.tp_size
    max_out_tokens = 1024
    min_out_tokens = 1
    max_tokens = None
    replace_with_kernel_inject = False
    injection_policy = None
    checkpoint = None
    base_dir = ""
    quant = {}
    enable_cuda_graph = False
    replace_method = "auto"
    moe = False
    moe_experts = 1
    moe_type = "standard"
    training_mp_size = 1
    return_tuple = True
    triangular_masking = True
    ep_size = 1
    # ZeRO-Inference: {"offload_param": {"device": "cpu"|"nvme", ...}}
    zero = {}
    # serving hardening (inference/robustness.py)
    serving = {}

    def _validate(self):
        if isinstance(self.tensor_parallel, dict):
            self.tensor_parallel = DeepSpeedTPConfig(self.tensor_parallel)
        if self.mp_size is not None:
            self.tensor_parallel.tp_size = self.mp_size
        if isinstance(self.quant, dict):
            self.quant = QuantizationConfig(self.quant)
        if isinstance(self.serving, dict):
            from deepspeed_tpu_torch.inference.robustness import \
                ServingRobustnessConfig
            self.serving = ServingRobustnessConfig(self.serving)

    @property
    def tp_size(self):
        return self.tensor_parallel.tp_size
