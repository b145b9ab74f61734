from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing  # noqa: F401
