"""Port parity: the LR schedules.

Each of the port's schedules (``runtime/lr_schedules``: LRRangeTest,
OneCycle, WarmupLR, WarmupDecayLR, and 1Cycle's momentum) against the JAX
package's ``build_schedule`` / ``one_cycle_mom`` at steps 0..N, evaluated
one 0-dim fp32 step at a time as the engine does on the card, in fp32,
rtol 1e-6 + atol 1e-12: the same float32 formulas, where a division by a
Python number may round as a multiply by its reciprocal (one ulp).  Then
``LRScheduler`` and ``add_tuning_arguments``, which must give the same
values and defaults as the JAX ones.
"""

import argparse

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-12)
N = 60

CASES = {
    "range": ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                              "lr_range_test_step_size": 7,
                              "lr_range_test_step_rate": 2.5}),
    "range_staircase": ("LRRangeTest", {"lr_range_test_step_size": 5,
                                        "lr_range_test_staircase": True}),
    "one_cycle": ("OneCycle", {"cycle_min_lr": 1e-3, "cycle_max_lr": 1e-2,
                               "cycle_first_step_size": 10,
                               "cycle_second_step_size": 15,
                               "decay_lr_rate": 0.3, "decay_step_size": 4}),
    "one_cycle_hold": ("OneCycle", {"cycle_first_step_size": 12}),
    "warmup_log": ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2,
                                "warmup_num_steps": 20}),
    "warmup_linear": ("WarmupLR", {"warmup_max_lr": 3e-3,
                                   "warmup_num_steps": 25,
                                   "warmup_type": "linear"}),
    "warmup_decay": ("WarmupDecayLR", {"warmup_min_lr": 1e-5,
                                       "warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 8,
                                       "total_num_steps": 50}),
    "warmup_decay_defaults": ("WarmupDecayLR", {}),
}


def _values(fn, steps, as_tensor):
    return np.array([float(fn(torch.tensor(float(s)) if as_tensor else s))
                     for s in steps], np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_jax(case):
    name, params = CASES[case]
    steps = range(N)
    want = _values(jlr.build_schedule(name, params), steps, False)
    got = _values(tlr.build_schedule(name, params), steps, True)
    np.testing.assert_allclose(got, want, **TOL)
    assert len(set(want.tolist())) > 1 or case == "one_cycle_hold"
    # a number is taken too (the host-side LRScheduler passes ints)
    np.testing.assert_allclose(_values(tlr.build_schedule(name, params),
                                       steps, False), want, **TOL)


@pytest.mark.parametrize("params", [
    {"cycle_min_mom": 0.85, "cycle_max_mom": 0.95, "cycle_first_step_size": 9},
    {"cycle_first_step_size": 6, "decay_mom_rate": 0.1, "decay_step_size": 3},
    {}])
def test_one_cycle_momentum_matches_jax(params):
    got_fn, want_fn = tlr.one_cycle_mom(params), jlr.one_cycle_mom(params)
    np.testing.assert_allclose(_values(got_fn, range(N), True),
                               _values(want_fn, range(N), False), **TOL)
    assert tlr.one_cycle_mom({"cycle_momentum": False}) is None


def test_schedule_keeps_the_device_and_fp32():
    step = torch.tensor(3, dtype=torch.int32)
    lr = tlr.build_schedule("WarmupDecayLR", {"warmup_num_steps": 5})(step)
    assert lr.dtype == torch.float32 and lr.dim() == 0
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tlr.build_schedule("Cosine", {})
    assert tlr.VALID_LR_SCHEDULES == jlr.VALID_LR_SCHEDULES


def test_lr_scheduler_matches_jax():
    params = {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2,
              "warmup_num_steps": 10, "total_num_steps": 30}
    jsched = jlr.LRScheduler(jlr.build_schedule("WarmupDecayLR", params))
    tsched = tlr.LRScheduler(tlr.build_schedule("WarmupDecayLR", params))
    for _ in range(12):
        np.testing.assert_allclose(tsched.get_lr(), jsched.get_lr(), **TOL)
        assert tsched.get_last_lr() == tsched.get_lr()
        jsched.step()
        tsched.step()
    assert tsched.state_dict() == jsched.state_dict() == {
        "last_batch_iteration": 11}
    other = tlr.LRScheduler(tsched.schedule_fn)
    other.load_state_dict(tsched.state_dict())
    assert other.get_lr() == tsched.get_lr()
    tsched.step(20)
    jsched.step(20)
    np.testing.assert_allclose(tsched.get_lr(), jsched.get_lr(), **TOL)


def test_add_tuning_arguments_matches_jax():
    assert tlr.TUNING_DEFAULTS == jlr.TUNING_DEFAULTS
    argv = ["--lr_schedule", "OneCycle", "--cycle_max_lr", "0.05",
            "--cycle_second_step_size", "7", "--lr_range_test_staircase",
            "true", "--warmup_type", "linear"]
    got = vars(tlr.add_tuning_arguments(argparse.ArgumentParser())
               .parse_args(argv))
    want = vars(jlr.add_tuning_arguments(argparse.ArgumentParser())
                .parse_args(argv))
    assert got == want
    assert got["cycle_max_lr"] == 0.05 and got["lr_range_test_staircase"]
    assert vars(tlr.add_tuning_arguments(argparse.ArgumentParser())
                .parse_args([])) == vars(jlr.add_tuning_arguments(
                    argparse.ArgumentParser()).parse_args([]))
