"""CUDA accelerator: the card the port is written for."""

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def is_available(self):
        return torch.cuda.is_available()

    def device_name(self, device_index=None):
        if device_index is None:
            return "cuda"
        return f"cuda:{device_index}"

    def device_count(self):
        return torch.cuda.device_count()

    def synchronize(self, device_index=None):
        torch.cuda.synchronize(device_index)

    def current_stream(self, device_index=None):
        return torch.cuda.current_stream(device_index)
