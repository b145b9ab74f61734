"""Checkpoint tools (counterpart of ``deepspeed_tpu/checkpoint/``)."""

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (  # noqa: F401
    DeepSpeedCheckpoint, load_checkpoint_tree, merge_pp_layer_shards,
    merge_tp_shards, read_latest_tag, slice_tp_shards)
from deepspeed_tpu_torch.checkpoint.universal_checkpoint import (  # noqa: F401
    ds_to_universal, load_hp_checkpoint_state, load_universal_checkpoint,
    universal_to_state_dict)
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import (  # noqa: F401
    convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint)
