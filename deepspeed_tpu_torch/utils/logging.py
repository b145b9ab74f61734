"""Rank-aware logging.

Counterpart of ``deepspeed_tpu/utils/logging.py`` (``logger``,
``log_dist``).  The rank is the ``torch.distributed``
rank when a process group is up, else 0.
"""

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class _LoggerFactory:
    @staticmethod
    def create_logger(name="deepspeed_tpu_torch", level=logging.INFO):
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            handler = logging.StreamHandler(stream=sys.stdout)
            handler.setFormatter(formatter)
            logger_.addHandler(handler)
        return logger_


level = LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info"), logging.INFO)
logger = _LoggerFactory.create_logger(level=level)


def _rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the listed ranks (None/[-1] = all)."""
    my_rank = _rank()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
