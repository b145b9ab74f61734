"""Accelerator selection.

Counterpart of ``deepspeed_tpu/accelerator/real_accelerator.py``: the CUDA
accelerator when a card is present, else the CPU one.  Which device an
entry point runs on is decided by
:meth:`DeepSpeedAccelerator.resolve_device`, not by this choice: with no
card and no explicit ``device="cpu"`` it raises.
"""

import torch

ds_accelerator = None


def get_accelerator():
    global ds_accelerator
    if ds_accelerator is None:
        if torch.cuda.is_available():
            from .cuda_accelerator import CUDA_Accelerator
            ds_accelerator = CUDA_Accelerator()
        else:
            from .cpu_accelerator import CPU_Accelerator
            ds_accelerator = CPU_Accelerator()
    return ds_accelerator
