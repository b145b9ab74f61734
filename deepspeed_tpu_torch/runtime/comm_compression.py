"""Error-feedback sign compression of the gradients: the 1-bit optimizers'
transform at world size 1.

Counterpart of ``error_feedback_compress`` in
``deepspeed_tpu/runtime/comm_compression.py``, the one piece of that module
a single rank runs: ``onebitadam``, ``zerooneadam`` and ``onebitlamb``
chain it before their inner rule.  The compressed all-reduce and the rest
of the module come with ROADMAP A13.
"""

import torch


class ErrorFeedback:
    """The identity while the step number (applied count + 1) is at most
    ``freeze_step``; after that, per parameter leaf, c = g + e, q =
    mean|c| * sign(c) with sign(0) = +1, and the error becomes c - q.
    Works on one flat buffer laid out in leaves (``layout``: a
    ``runtime.optimizers.FlatLayout``); the error buffer is fp32."""

    def __init__(self, freeze_step=100):
        self.freeze_step = int(freeze_step)

    @staticmethod
    def init_error(flat):
        return torch.zeros_like(flat, dtype=torch.float32)

    def compress(self, grads, error, count, layout, keep=None):
        """The compressed gradients (a new buffer of ``grads``' dtype) for
        the step after ``count`` applied steps; ``error`` is updated in
        place unless ``keep`` (a bool scalar tensor, a skipped step) is
        true.  Reads nothing back to the host: the stage is chosen on the
        device."""
        enabled = (count + 1) > self.freeze_step
        c = grads.float() + error
        scale = layout.expand(layout.leaf_mean_abs(c))
        q = torch.where(c >= 0, scale, -scale)
        new_e = torch.where(enabled, c - q, error)
        error.copy_(new_e if keep is None else torch.where(keep, error, new_e))
        return torch.where(enabled, q, grads.float()).to(grads.dtype)
