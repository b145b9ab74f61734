"""Built-in optimizers: the Adam family over flat buffers.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py`` (``build_optimizer``,
``_adam``).  The JAX engine steps through optax and XLA fuses the whole
update into one program; eager PyTorch fuses nothing, so here every Adam
variant is a :class:`FusedAdam` that steps the engine's flat fp32 master
buffer through ``ops/adam.fused_adam`` -- one kernel launch per step --
with ``_adam``'s defaults: ``weight_decay`` 0.01 in AdamW mode and 0
otherwise, applied to EVERY parameter (norms and biases too, as
``optax.adamw`` without a mask does), ``adam_w_mode`` honoured, bias
correction on, fp32 moments.  ``lr`` may be a schedule and beta1 may
follow 1Cycle's momentum schedule (``_b1_schedule``), as the JAX engine
passes them into optax: both are functions of the count of applied steps,
evaluated on the card each step.  The other optimizers raise
``NotImplementedError`` naming their ROADMAP item.
"""

from typing import Any, Dict

import torch

from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper, fused_adam,
                                          init_state)

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"

# names the JAX registry knows that this port does not run yet
_UNPORTED = {
    CPU_ADAM: "host-offloaded Adam (ZeRO-Offload), ROADMAP A12",
    LAMB_OPTIMIZER: "LAMB, ROADMAP A7",
    FUSED_LAMB: "LAMB, ROADMAP A7",
    ONEBIT_ADAM_OPTIMIZER: "1-bit Adam, ROADMAP A7",
    ZERO_ONE_ADAM_OPTIMIZER: "0/1 Adam, ROADMAP A7",
    ONEBIT_LAMB_OPTIMIZER: "1-bit LAMB, ROADMAP A7",
    SGD_OPTIMIZER: "SGD, ROADMAP A7",
    ADAGRAD_OPTIMIZER: "Adagrad, ROADMAP A7",
}


class FusedAdam:
    """Adam / AdamW over one flat fp32 buffer.  ``step`` updates the
    buffer and the moments in place in one ``fused_adam`` call.  ``lr``: a
    number or a schedule (a function of the 0-dim fp32 count of applied
    steps, on the card); ``b1_schedule``: None or such a schedule for
    beta1 (1Cycle momentum, optax's ``inject_hyperparams``)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, b1_schedule=None):
        self.lr = lr if callable(lr) else float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.b1_schedule = b1_schedule

    def init_state(self, flat_params) -> AdamState:
        return init_state(flat_params)

    def hyper(self, state: AdamState):
        """The step's scalar buffer (``ops.adam.adam_hyper``) from the
        schedules at the state's applied count, on the card."""
        t = state.count.to(torch.float32)
        lr = self.lr(t) if callable(self.lr) else self.lr
        b1 = self.b1_schedule(t) if self.b1_schedule else self.betas[0]
        return adam_hyper(state.count, lr, b1, self.betas[1])

    def step(self, flat_params, flat_grads, state: AdamState, skip=None,
             backend="auto") -> AdamState:
        """One update; ``skip`` (an int32 scalar tensor, nonzero on fp16
        overflow) leaves everything, the count included, as it was."""
        _, state = fused_adam(
            flat_params, flat_grads, state, self.hyper(state), skip,
            beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, adamw_mode=self.adamw_mode,
            backend=backend)
        return state


def _adam(params: Dict[str, Any], adamw_mode=True) -> FusedAdam:
    moment_dtype = str(params.get("moment_dtype", "float32")).lower()
    if moment_dtype not in ("float32", "fp32"):
        raise NotImplementedError(
            f"moment_dtype {moment_dtype!r}: only fp32 Adam moments are "
            f"ported (bf16 moments with stochastic rounding: ROADMAP A7)")
    return FusedAdam(lr=params.get("lr", 1e-3),
                     betas=params.get("betas", (0.9, 0.999)),
                     eps=params.get("eps", 1e-8),
                     weight_decay=params.get("weight_decay",
                                             0.01 if adamw_mode else 0.0),
                     adamw_mode=adamw_mode,
                     b1_schedule=params.get("_b1_schedule"))


OPTIMIZER_REGISTRY = {
    ADAM_OPTIMIZER: lambda p: _adam(p, adamw_mode=p.get("adam_w_mode",
                                                        True)),
    ADAMW_OPTIMIZER: lambda p: _adam(p, adamw_mode=True),
    FUSED_ADAM: lambda p: _adam(p, adamw_mode=p.get("adam_w_mode", True)),
}


def build_optimizer(name: str, params: Dict[str, Any]) -> FusedAdam:
    key = name.lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet "
                                  f"({_UNPORTED[key]})")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer '{name}'. Built-ins: "
                         f"{sorted(OPTIMIZER_REGISTRY)}")
    return OPTIMIZER_REGISTRY[key](params)
