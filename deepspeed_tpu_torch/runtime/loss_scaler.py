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
