"""Accelerator abstraction.

Counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``,
cut to the roles this package uses: device enumeration and naming,
synchronisation, streams, and -- the one policy that lives here -- how an
entry point turns a caller's ``device`` argument into a ``torch.device``.
"""

import abc
from abc import ABC

import torch


class DeepSpeedAccelerator(ABC):

    def __init__(self):
        self._name = None
        self._communication_backend_name = None

    @abc.abstractmethod
    def is_available(self):
        ...

    @abc.abstractmethod
    def device_name(self, device_index=None):
        ...

    @abc.abstractmethod
    def device_count(self):
        ...

    @abc.abstractmethod
    def synchronize(self, device_index=None):
        ...

    @abc.abstractmethod
    def current_stream(self, device_index=None):
        ...

    def device(self, device_index=None):
        return torch.device(self.device_name(device_index))

    def communication_backend_name(self):
        return self._communication_backend_name

    def resolve_device(self, device=None) -> torch.device:
        """The device an entry point runs on.  ``None`` means the card:
        this package's entry points never carry on on the CPU unless the
        caller asks for it by name."""
        if device is not None:
            return torch.device(device)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
