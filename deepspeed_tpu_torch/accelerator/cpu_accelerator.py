"""CPU accelerator -- the tests' device, chosen only when no card exists
or the caller names it."""

from .abstract_accelerator import DeepSpeedAccelerator


class CPU_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def is_available(self):
        return True

    def device_name(self, device_index=None):
        return "cpu"

    def device_count(self):
        return 1

    def synchronize(self, device_index=None):
        pass

    def current_stream(self, device_index=None):
        return None
