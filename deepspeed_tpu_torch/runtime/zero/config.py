"""ZeRO config.

Counterpart of ``deepspeed_tpu/runtime/zero/config.py``
(``DeepSpeedZeroConfig``), same key spellings.  This port runs one
process on one card, where every stage computes the same step (on one
device the JAX plan shards nothing either), so stages 0-3 are accepted
and recorded; a data-parallel world above 1 is refused by the engine
(ROADMAP A8).  The bucketing keys are accepted and advisory, as in the
JAX package.  ``offload_optimizer`` (device cpu or nvme; the legacy
``cpu_offload: true`` means device cpu, as in JAX) runs the optimizer on
the host (``runtime/zero/offload.py``); ``offload_param`` (device cpu or
nvme) streams the parameters from the host
(``runtime/zero/param_stream.py``).  The legacy ``cpu_offload_param:
true`` means ``offload_param`` device cpu, as in the reference (the JAX
config parses the key and leaves it inert).  The explicit overlap block
(A13) raises.
"""

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class OffloadDeviceEnum:
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


def _check_device(block, device):
    if device not in (OffloadDeviceEnum.none, OffloadDeviceEnum.cpu,
                      OffloadDeviceEnum.nvme):
        raise ValueError(f"zero_optimization.{block}.device must be none, "
                         f"cpu or nvme, got {device!r}")


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_param``: where the parameters live
    (``cpu``: host RAM; ``nvme``: memmaps under ``nvme_path``, the temp
    dir when unset).  ``buffer_count`` (at least 2 take effect) layers'
    working sets are on the card at once -- the prefetch runs
    ``buffer_count - 1`` layers ahead -- and as many layers' gradients
    are in flight to the host; ``resident_layers`` pins the first layers'
    working sets on the card for the whole step (the JAX package's
    extension).  ``buffer_size``, ``max_in_cpu`` and ``pin_memory`` are
    accepted and advisory, as in the JAX package."""
    device = OffloadDeviceEnum.none
    nvme_path = None
    buffer_count = 2
    buffer_size = 100_000_000
    max_in_cpu = 1_000_000_000
    pin_memory = False
    resident_layers = 0

    def _validate(self):
        _check_device("offload_param", self.device)
        if int(self.resident_layers or 0) < 0:
            raise ValueError("zero_optimization.offload_param."
                             "resident_layers must be >= 0")


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    """``zero_optimization.offload_optimizer``: where the fp32 master and
    the moments live (``cpu``: host RAM; ``nvme``: the moments in swap
    files under ``nvme_path``, the temp dir when unset, through
    ``buffer_count`` pinned buffers).  The pipeline keys are accepted and
    advisory, as in the JAX package."""
    device = OffloadDeviceEnum.none
    nvme_path = None
    buffer_count = 4
    pin_memory = False
    pipeline_read = False
    pipeline_write = False
    fast_init = False
    ratio = 1.0

    def _validate(self):
        _check_device("offload_optimizer", self.device)


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage = 0
    contiguous_gradients = True
    reduce_scatter = True
    reduce_bucket_size = 500_000_000
    allgather_partitions = True
    allgather_bucket_size = 500_000_000
    overlap_comm = None
    overlap = None
    load_from_fp32_weights = True
    elastic_checkpoint = False
    offload_param = None
    offload_optimizer = None
    sub_group_size = 1_000_000_000
    cpu_offload_param = None
    cpu_offload_use_pin_memory = None
    cpu_offload = None
    prefetch_bucket_size = 50_000_000
    param_persistence_threshold = 100_000
    model_persistence_threshold = 2 ** 63 - 1
    max_live_parameters = 1_000_000_000
    max_reuse_distance = 1_000_000_000
    gather_16bit_weights_on_model_save = False
    ignore_unused_parameters = True
    legacy_stage1 = False
    round_robin_gradients = False

    _deprecated_ = {
        "stage3_prefetch_bucket_size": "prefetch_bucket_size",
        "stage3_param_persistence_threshold": "param_persistence_threshold",
        "stage3_model_persistence_threshold": "model_persistence_threshold",
        "stage3_max_live_parameters": "max_live_parameters",
        "stage3_max_reuse_distance": "max_reuse_distance",
        "stage3_gather_16bit_weights_on_model_save":
            "gather_16bit_weights_on_model_save",
        "stage3_gather_fp16_weights_on_model_save":
            "gather_16bit_weights_on_model_save",
    }

    def _validate(self):
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"invalid ZeRO stage {self.stage}")
        if self.cpu_offload_param:
            self.offload_param = self.offload_param or {"device": "cpu"}
        if isinstance(self.offload_param, dict):
            self.offload_param = DeepSpeedZeroOffloadParamConfig(
                self.offload_param)
        if self.cpu_offload:
            self.offload_optimizer = self.offload_optimizer or {"device":
                                                               "cpu"}
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(
                self.offload_optimizer)
        if (self.overlap or {}).get("enabled", False):
            raise NotImplementedError("zero_optimization.overlap is not "
                                      "ported yet (ROADMAP A13)")

    @property
    def offload_optimizer_device(self):
        if self.offload_optimizer is None:
            return OffloadDeviceEnum.none
        return self.offload_optimizer.device

    @property
    def offload_param_device(self):
        if self.offload_param is None:
            return OffloadDeviceEnum.none
        return self.offload_param.device
