"""LR schedules.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (LRRangeTest,
OneCycle, WarmupLR, WarmupDecayLR), with the same config ``params`` keys
and defaults.  A schedule is a function ``step -> lr`` of a 0-dim fp32
tensor, written with the JAX functions' float32 formulas in torch ops, so
the engine evaluates it ON THE CARD at its device count of applied steps:
no step waits for the host.  :class:`LRScheduler` is the stateful wrapper
with the torch-style ``step`` / ``get_lr`` API for user loops, evaluated on
the host.
"""

import math
from typing import Any, Callable, Dict

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]


# the schedule-parameter defaults: the schedule builders and the
# add_tuning_arguments CLI table both read this
TUNING_DEFAULTS: Dict[str, Any] = {
    "lr_range_test_min_lr": 1e-3,
    "lr_range_test_step_size": 2000,
    "lr_range_test_step_rate": 1.0,
    "lr_range_test_staircase": False,
    "cycle_min_lr": 1e-3,
    "cycle_max_lr": 1e-2,
    "decay_lr_rate": 0.0,
    "cycle_first_step_size": 2000,
    "cycle_second_step_size": None,   # None -> mirror first_step_size
    "cycle_first_stair_count": 1,
    "cycle_second_stair_count": None,
    "decay_step_size": 0,
    "cycle_min_mom": 0.8,
    "cycle_max_mom": 0.9,
    "decay_mom_rate": 0.0,
    "warmup_min_lr": 0.0,
    "warmup_max_lr": 0.001,
    "warmup_num_steps": 1000,
    "warmup_type": "log",
}


def _param(params: Dict[str, Any], key: str):
    v = params.get(key, TUNING_DEFAULTS.get(key))
    return TUNING_DEFAULTS.get(key) if v is None else v


def _step(step) -> torch.Tensor:
    """The step as a 0-dim fp32 tensor (a number becomes one on the
    host)."""
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def lr_range_test(params: Dict[str, Any]) -> Callable:
    min_lr = _param(params, "lr_range_test_min_lr")
    step_size = _param(params, "lr_range_test_step_size")
    step_rate = _param(params, "lr_range_test_step_rate")
    staircase = _param(params, "lr_range_test_staircase")

    def schedule(step):
        interval = _step(step) / step_size
        if staircase:
            interval = torch.floor(interval)
        return min_lr * (1.0 + interval * step_rate)
    return schedule


def _cycle_phase(params: Dict[str, Any]):
    """The 1Cycle geometry shared by the lr and momentum schedules:
    ``phase(step) -> (scale, in_cycle, decay_intervals)``, ``scale`` the
    up/down triangle in [0, 1]."""
    first = _param(params, "cycle_first_step_size")
    second = params.get("cycle_second_step_size")
    if second is None:
        second = first
    decay_step = _param(params, "decay_step_size")
    total = first + second

    def phase(step):
        step = _step(step)
        up = torch.clamp(step / first, 0.0, 1.0)
        down = torch.clamp((step - first) / second, 0.0, 1.0)
        past = torch.clamp(step - total, min=0.0)
        # decay_step_size 0 (the default) holds lr and momentum after the
        # cycle, as OneCycle's skip_lr_decay / skip_mom_decay do
        intervals = (past / decay_step if decay_step > 0
                     else torch.zeros_like(past))
        return up - down, step <= total, intervals
    return phase


def one_cycle(params: Dict[str, Any]) -> Callable:
    cycle_min_lr = _param(params, "cycle_min_lr")
    cycle_max_lr = _param(params, "cycle_max_lr")
    decay_lr_rate = _param(params, "decay_lr_rate")
    phase = _cycle_phase(params)

    def schedule(step):
        scale, in_cycle, intervals = phase(step)
        in_cycle_lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * scale
        decayed = cycle_min_lr / (1.0 + decay_lr_rate * intervals)
        return torch.where(in_cycle, in_cycle_lr, decayed)
    return schedule


def one_cycle_mom(params: Dict[str, Any]):
    """1Cycle's momentum schedule: beta1 cycles inversely to lr over the
    same triangle, then grows as ``max * (1 + decay_mom_rate * t)``
    (capped at 0.999) after the cycle.  ``cycle_momentum`` defaults on;
    None only when it is turned off."""
    if not params.get("cycle_momentum", True):
        return None
    min_mom = _param(params, "cycle_min_mom")
    max_mom = _param(params, "cycle_max_mom")
    decay_mom_rate = _param(params, "decay_mom_rate")
    phase = _cycle_phase(params)

    def schedule(step):
        scale, in_cycle, intervals = phase(step)
        in_cycle_mom = max_mom - (max_mom - min_mom) * scale
        # growth after the cycle only: Adam's (1 - b1) must stay positive
        decayed = torch.clamp(max_mom * (1.0 + decay_mom_rate * intervals),
                              max=0.999)
        return torch.where(in_cycle, in_cycle_mom, decayed)
    return schedule


def warmup_lr(params: Dict[str, Any]) -> Callable:
    warmup_min_lr = _param(params, "warmup_min_lr")
    warmup_max_lr = _param(params, "warmup_max_lr")
    warmup_num_steps = max(1, _param(params, "warmup_num_steps"))
    warmup_type = _param(params, "warmup_type")

    def schedule(step):
        step = _step(step)
        if warmup_type == "log":
            # log(1 + step) / log(1 + N): the default warmup curve
            gamma = torch.clamp(torch.log1p(step) /
                                math.log(1 + warmup_num_steps), 0.0, 1.0)
        else:
            gamma = torch.clamp(step / warmup_num_steps, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma
    return schedule


def warmup_decay_lr(params: Dict[str, Any]) -> Callable:
    total_num_steps = params.get("total_num_steps", 10000)
    warmup_num_steps = max(1, params.get("warmup_num_steps", 1000))
    base = warmup_lr(params)

    def schedule(step):
        step = _step(step)
        w = base(step)
        decay = torch.clamp(
            (total_num_steps - step) /
            max(1.0, float(total_num_steps - warmup_num_steps)), 0.0, 1.0)
        return torch.where(step < warmup_num_steps, w, w * decay)
    return schedule


SCHEDULE_REGISTRY = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
}


def build_schedule(name: str, params: Dict[str, Any]) -> Callable:
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(
            f"Unknown scheduler '{name}'. Valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](params)


class LRScheduler:
    """Stateful wrapper with the torch-style API (``step`` / ``get_lr`` /
    ``state_dict`` / ``load_state_dict``), evaluated on the host."""

    def __init__(self, schedule_fn: Callable, last_batch_iteration: int = -1):
        self.schedule_fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [float(self.schedule_fn(max(0, self.last_batch_iteration)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "0"):
        return False
    raise ValueError(f"boolean flag got {v!r}")


def add_tuning_arguments(parser):
    """CLI args for schedule tuning: one ``--<key>`` flag per
    TUNING_DEFAULTS entry, so the CLI's defaults are the schedule
    builders' defaults."""
    group = parser.add_argument_group(
        "Convergence Tuning", "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None,
                       help="LR schedule for training.")
    for key, default in TUNING_DEFAULTS.items():
        if isinstance(default, bool):
            typ = _str2bool
        elif isinstance(default, int):
            typ = int
        elif isinstance(default, float):
            typ = float
        elif default is None:
            typ = int          # the None-defaulted step sizes
        else:
            typ = str
        group.add_argument(f"--{key}", type=typ, default=default,
                           help=f"{key} (default {default})")
    return parser
