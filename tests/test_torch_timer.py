"""Port parity: the wall-clock and throughput timers, and the engine's use
of them.

``deepspeed_tpu_torch.utils.timer`` against ``deepspeed_tpu.utils.timer``
under one fake clock (``time.time`` and the device sync of both modules
replaced): elapsed, mean, ``get_mean`` and both log lines, exact.  Then
the engines: ``initialize`` on the CPU with ``steps_per_print: 1`` and
``wall_clock_breakdown: true``; ``train_batch`` logs the JAX engine's
``RunningAvgSamplesPerSec`` line and the three-call path its ``time (ms)
| fwd | bwd | step`` line, the same strings as the JAX engine under the
same clock.
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (CausalTransformerLM as JaxLM,
                                              TransformerConfig as JaxConfig)
from deepspeed_tpu.utils import timer as jax_timer
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.utils import timer as port_timer
from torch_threads import _one_torch_thread  # noqa: F401

MODULES = {"jax": jax_timer, "port": port_timer}


class FakeClock:
    """time.time() that advances by the next of ``steps`` seconds (cycled)
    at every reading."""

    def __init__(self, steps=(0.25, 0.5, 1.0, 0.125)):
        self.now, self.steps, self.i = 100.0, steps, 0

    def time(self):
        self.now += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.now


@pytest.fixture
def logged(monkeypatch):
    """Both timer modules on their own fake clock (the same readings), no
    device sync, and their log lines captured: {"jax": [...], "port":
    [...]}."""
    lines = {}
    for name, mod in MODULES.items():
        lines[name] = []
        monkeypatch.setattr(mod, "time", FakeClock())
        monkeypatch.setattr(mod, "_device_sync", lambda: None)
        monkeypatch.setattr(mod, "log_dist",
                            lambda msg, ranks=None, out=lines[name]:
                            out.append(msg))
    return lines


def _drive_wall_clock(mod):
    timers = mod.SynchronizedWallClockTimer()
    out = []
    for _ in range(3):
        timers("fwd").start()
        timers("fwd").stop()
        timers("bwd").start()
        timers("bwd").stop(reset=True)
    timers("step").start()
    out.append(timers("step").elapsed(reset=False))  # while it runs
    timers("step").stop(record=False)
    out.append(timers("fwd").mean())
    out.append(timers.get_mean(["fwd", "bwd", "step", "absent"],
                               normalizer=2.0))
    timers.log(["fwd", "bwd", "step", "absent"], normalizer=3.0)
    out.append(timers("fwd").elapsed())          # reset by the log
    timers.log(["bwd"], reset=False)
    out.append(timers.has_timer("step"))
    return out


def test_wall_clock_timer_matches_jax(logged):
    got = {name: _drive_wall_clock(mod) for name, mod in MODULES.items()}
    assert got["port"] == got["jax"]
    assert logged["port"] == logged["jax"]
    assert logged["port"][0].startswith("time (ms) | fwd: ")
    assert len(logged["port"]) == 2


def _drive_throughput(mod):
    tt = mod.ThroughputTimer(batch_size=16, start_step=2,
                             steps_per_output=2)
    out = []
    for step in range(7):
        tt.start()
        if step == 4:
            tt.stop(global_step=False)       # a micro-step of its own
            tt.start()
        tt.stop(global_step=True)
        out.append((tt.global_step_count, tt.micro_step_count,
                    round(tt.total_elapsed_time, 9)))
    tt.update_epoch_count()
    out.append(tt.avg_samples_per_sec())
    return out


def test_throughput_timer_matches_jax(logged):
    got = {name: _drive_throughput(mod) for name, mod in MODULES.items()}
    assert got["port"] == got["jax"]
    assert logged["port"] == logged["jax"]
    assert len(logged["port"]) == 2         # global steps 4 and 6
    assert logged["port"][0].startswith(
        "epoch=0/micro_step=4/global_step=4, RunningAvgSamplesPerSec=")


def test_throughput_before_its_start_step_is_nan():
    tt = port_timer.ThroughputTimer(batch_size=4)
    tt.start()
    tt.stop(global_step=True)
    assert np.isnan(tt.avg_samples_per_sec())


# the engines: a 1-layer tiny model, micro 8 (the JAX engine's 8 virtual
# devices one sequence each), gas 2, seq 8
MODEL = dict(hidden_size=32, n_heads=2, n_layers=1)
GAS, SEQ, DEVICES = 2, 8, 8


def _config(micro):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": GAS, "steps_per_print": 1,
            "wall_clock_breakdown": True,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def _drive_engine(eng, batches):
    """Three train_batch calls, then one three-call step."""
    for b in batches[:3]:
        eng.train_batch(batch=b)
    for i in range(GAS):
        loss = eng.forward({"input_ids": batches[3]["input_ids"][i]})
        eng.backward(loss)
        eng.step()


def test_engine_logs_the_jax_timer_lines(logged):
    """C6: the port's engine logs what the JAX engine logs for the same
    config -- ``RunningAvgSamplesPerSec`` from the third train_batch on
    (``start_step`` 2) every ``steps_per_print`` calls, and with
    ``wall_clock_breakdown`` the fwd / bwd / step line at each three-call
    step -- the same strings under the same clock."""
    jcfg, tcfg = JaxConfig.tiny(**MODEL), TransformerConfig.tiny(**MODEL)
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (GAS, DEVICES, SEQ))}
               for _ in range(4)]
    params = jax.tree_util.tree_map(np.asarray,
                                    JaxLM(jcfg).init(jax.random.key(0)))
    jeng, *_ = deepspeed_tpu.initialize(model=JaxLM(jcfg),
                                        model_parameters=params,
                                        config=_config(1))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params, config=_config(DEVICES), device="cpu")
    assert teng._config.wall_clock_breakdown is True
    _drive_engine(jeng, batches)
    _drive_engine(teng, batches)
    assert logged["port"] == logged["jax"]
    assert len(logged["port"]) == 2
    assert logged["port"][0].startswith(
        "epoch=0/micro_step=3/global_step=3, RunningAvgSamplesPerSec=")
    assert logged["port"][1].startswith("time (ms) | fwd: ")
    assert " | bwd: " in logged["port"][1] and \
        " | step: " in logged["port"][1]


def test_engine_times_nothing_without_the_breakdown(logged):
    """Without ``wall_clock_breakdown`` the three-call path starts no
    timer and logs nothing; ``train_batch`` still logs every
    ``steps_per_print`` calls."""
    tcfg = TransformerConfig.tiny(**MODEL)
    conf = dict(_config(DEVICES), wall_clock_breakdown=False,
                steps_per_print=2)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu").init(0), config=conf,
        device="cpu")
    ids = np.random.default_rng(1).integers(0, 256, (GAS, DEVICES, SEQ))
    for _ in range(4):
        eng.train_batch(batch={"input_ids": ids})
    for i in range(GAS):
        eng.backward(eng.forward({"input_ids": ids[i]}))
        eng.step()
    assert eng.timers.timers == {}
    assert [line.split(",")[0] for line in logged["port"]] == [
        "epoch=0/micro_step=4/global_step=4"]


def test_timers_on_the_card_need_no_card_until_a_reading():
    """A timer built for a CUDA device records events only at start / stop
    (what the engine on the card does); building one needs no card."""
    t = port_timer.SynchronizedWallClockTimer(device="cuda")
    assert t("fwd")._events is not None
    tt = port_timer.ThroughputTimer(4, device="cuda")
    assert tt._events is not None
    assert port_timer.SynchronizedWallClockTimer()("x")._events is None
