"""Loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/loss_scaler.py``: the scaler's
state is four 0-dim tensors on the card, and :func:`update_scale` advances
the dynamic loss-scale automaton with ``torch.where`` arithmetic, line for
line with the JAX function -- no host branch on the overflow, so the
engine's step never waits for the device to know whether it overflowed.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    cur_scale: torch.Tensor           # fp32 scalar
    cur_hysteresis: torch.Tensor      # int32 scalar
    last_overflow_iter: torch.Tensor  # int32 scalar
    iteration: torch.Tensor           # int32 scalar


def static_loss_scale_state(scale: float, hysteresis: int = 0,
                            device=None) -> LossScaleState:
    def i32(x):
        return torch.full((), x, dtype=torch.int32, device=device)
    return LossScaleState(
        cur_scale=torch.full((), scale, dtype=torch.float32, device=device),
        cur_hysteresis=i32(hysteresis), last_overflow_iter=i32(-1),
        iteration=i32(0))


def dynamic_loss_scale_state(initial_scale_power=16, hysteresis: int = 2,
                             device=None) -> LossScaleState:
    # the full hysteresis budget to start with (DynamicLossScaler's
    # cur_hysteresis = delayed_shift)
    return static_loss_scale_state(2.0 ** initial_scale_power,
                                   hysteresis=hysteresis, device=device)


def has_inf_or_nan(*tensors) -> torch.Tensor:
    """A bool scalar: True if any element of ``tensors`` is inf or nan
    (``check_overflow``), on their device."""
    bad = None
    for t in tensors:
        b = ~torch.isfinite(t).all()
        bad = b if bad is None else bad | b
    return bad


def update_scale(state: LossScaleState, overflow: torch.Tensor, *,
                 dynamic: bool, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0,
                 hysteresis: int = 2) -> LossScaleState:
    """One step of the dynamic loss-scale automaton on a bool scalar
    ``overflow``: an overflow halves the scale once the hysteresis is used
    up; ``scale_window`` clean steps double it
    (``DynamicLossScaler.update_scale``).  A static scaler only counts."""
    it = state.iteration
    if not dynamic:
        return state._replace(iteration=it + 1)

    hyst = torch.where(overflow, torch.clamp(state.cur_hysteresis - 1,
                                             min=0),
                       state.cur_hysteresis)
    shrink = overflow & (state.cur_hysteresis <= 1)
    grown_due = (~overflow) & (torch.remainder(
        it - state.last_overflow_iter, scale_window) == scale_window - 1)

    new_scale = torch.where(
        shrink,
        torch.clamp(state.cur_scale / scale_factor, min=min_scale),
        torch.where(grown_due, state.cur_scale * scale_factor,
                    state.cur_scale))
    new_hyst = torch.where(shrink, torch.full_like(hyst, hysteresis), hyst)
    new_last = torch.where(overflow, it, state.last_overflow_iter)
    return LossScaleState(cur_scale=new_scale, cur_hysteresis=new_hyst,
                          last_overflow_iter=new_last, iteration=it + 1)


class HostLossScale:
    """The automaton of :func:`update_scale` on host ints and floats (the
    JAX package's ``HostLossScale``): the parameter stream drives its step
    from the host and needs the next step's scale as a Python float before
    it starts, and it reads the overflow flag to the host anyway, so the
    mirror costs no device read.  The engine keeps the device state in
    lockstep."""

    def __init__(self, initial_scale, *, dynamic, scale_factor=2.0,
                 scale_window=1000, min_scale=1.0, hysteresis=2):
        self.dynamic = bool(dynamic)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.hysteresis = int(hysteresis)
        self.cur_scale = float(initial_scale)
        self.cur_hysteresis = int(hysteresis) if dynamic else 0
        self.last_overflow_iter = -1
        self.iteration = 0

    def load(self, cur_scale, cur_hysteresis, last_overflow_iter, iteration):
        """Resync from a device :class:`LossScaleState` (a restore)."""
        self.cur_scale = float(cur_scale)
        self.cur_hysteresis = int(cur_hysteresis)
        self.last_overflow_iter = int(last_overflow_iter)
        self.iteration = int(iteration)

    def update(self, overflow: bool) -> float:
        """Advance one step; returns the scale of the next one."""
        overflow = bool(overflow)
        it = self.iteration
        if not self.dynamic:
            self.iteration = it + 1
            return self.cur_scale
        hyst = (max(self.cur_hysteresis - 1, 0) if overflow
                else self.cur_hysteresis)
        shrink = overflow and self.cur_hysteresis <= 1
        grown_due = (not overflow) and (
            (it - self.last_overflow_iter) % self.scale_window
            == self.scale_window - 1)
        if shrink:
            self.cur_scale = max(self.cur_scale / self.scale_factor,
                                 self.min_scale)
            self.cur_hysteresis = self.hysteresis
        else:
            if grown_due:
                self.cur_scale = self.cur_scale * self.scale_factor
            self.cur_hysteresis = hyst
        if overflow:
            self.last_overflow_iter = it
        self.iteration = it + 1
        return self.cur_scale
