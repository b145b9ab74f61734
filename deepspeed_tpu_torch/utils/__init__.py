from deepspeed_tpu_torch.utils.logging import logger, log_dist  # noqa: F401
from deepspeed_tpu_torch.utils.timer import (  # noqa: F401
    SynchronizedWallClockTimer, ThroughputTimer)
