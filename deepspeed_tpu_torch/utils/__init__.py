from deepspeed_tpu_torch.utils.logging import logger, log_dist  # noqa: F401
