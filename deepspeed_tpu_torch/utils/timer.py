"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py``
(``SynchronizedWallClockTimer``, ``ThroughputTimer``): the same timer
names, arithmetic and log lines.  Two clocks:

* the host's (``device`` None or a CPU device): ``time.time()`` around
  the timed work, ``_device_sync`` before each reading, as the JAX
  timers block on the device before theirs;
* the card's (``device`` a CUDA device): a CUDA event recorded on the
  current stream at each start and stop, so timing adds no host sync to
  the work it times.  The events are resolved -- one wait, on the newest
  -- only when a number is read: ``elapsed``, ``mean``, ``log``,
  ``get_mean``, or a ``ThroughputTimer`` step that prints.  A span is
  then the stream's time from the start event to the stop event.

Each reading replays the timer's starts and stops in order, so a value
means what the JAX timer's means: the accumulated, reset and recorded
spans follow its rules.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def _device_sync():
    """Wait for the card's queued work before a host-clock reading, when a
    card is in use (the JAX timers' ``effects_barrier``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _on_card(device):
    return device is not None and torch.device(device).type == "cuda"


class _Events:
    """Start / stop event pairs of one timer on the card, resolved to
    seconds in the order they were recorded."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pending = []      # (start event, stop event, payload)

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def resolve(self):
        """[(seconds, payload)] of every pair recorded since the last
        call, after one wait on the newest stop event."""
        if not self.pending:
            return []
        self.pending[-1][1].synchronize()
        out = [(a.elapsed_time(b) / 1000.0, payload)
               for a, b, payload in self.pending]
        self.pending = []
        return out


class SynchronizedWallClockTimer:
    """Named timers; start/stop pairs may repeat and accumulate.

    ``device``: where the timed work runs; on a CUDA device the timers
    read CUDA events (see the module's docstring)."""

    class Timer:
        def __init__(self, name, device=None):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = 0.0
            self.records = []
            self._events = _Events(device) if _on_card(device) else None
            self._start_ev = None

        def start(self, sync=True):
            assert not self.started_, f"timer {self.name_} already started"
            if self._events is not None:
                self._start_ev = self._events.mark()
            else:
                if sync:
                    _device_sync()
                self.start_time = time.time()
            self.started_ = True

        def _add(self, elapsed, reset, record):
            if reset:
                self.elapsed_ = elapsed
            else:
                self.elapsed_ += elapsed
            if record:
                self.records.append(elapsed)

        def stop(self, reset=False, record=True, sync=True):
            assert self.started_, f"timer {self.name_} not started"
            if self._events is not None:
                self._events.pending.append(
                    (self._start_ev, self._events.mark(), (reset, record)))
            else:
                if sync:
                    _device_sync()
                self._add(time.time() - self.start_time, reset, record)
            self.started_ = False

        def _resolve(self):
            if self._events is not None:
                for elapsed, (reset, record) in self._events.resolve():
                    self._add(elapsed, reset, record)

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False
            self.records = []
            if self._events is not None:
                self._events.pending = []

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop(record=False)
            self._resolve()
            elapsed = self.elapsed_
            if reset:
                self.elapsed_ = 0.0
            if started:
                self.start()
            return elapsed

        def mean(self):
            self._resolve()
            if not self.records:
                return 0.0
            return float(sum(self.records) / len(self.records))

    def __init__(self, device=None):
        self.timers = {}
        self.device = device

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def has_timer(self, name):
        return name in self.timers

    def log(self, names, normalizer=1.0, reset=True, ranks=None):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {elapsed:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks)

    def get_mean(self, names, normalizer=1.0):
        assert normalizer > 0.0
        return {
            name: self.timers[name].mean() * 1000.0 / normalizer
            for name in names if name in self.timers
        }


class ThroughputTimer:
    """Samples/sec across steps, logged every ``steps_per_output`` global
    steps.  ``device``: where the timed work runs; on a CUDA device the
    steps are spans between CUDA events, resolved only on a step that
    logs (``sync`` then has no effect)."""

    def __init__(self, batch_size, start_step=2, steps_per_output=None,
                 monitor_memory=False, logging_fn=None, sync=True,
                 device=None):
        self.sync = sync
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.initialized = False
        self._events = _Events(device) if _on_card(device) else None
        self._start_ev = None
        self._curr = None      # CurrSamplesPerSec's step time, when logged

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            if self._events is not None:
                self._start_ev = self._events.mark()
                self.start_time = 1    # timing from here on, as in JAX
            else:
                if self.sync:
                    _device_sync()
                self.start_time = time.time()

    def _account(self, duration, global_step):
        self.total_elapsed_time += duration
        self.step_elapsed_time += duration
        if global_step:
            self._curr = self.step_elapsed_time
            self.step_elapsed_time = 0

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            report = (global_step and report_speed and
                      self.steps_per_output and
                      self.global_step_count % self.steps_per_output == 0)
            if self._events is not None:
                self._events.pending.append(
                    (self._start_ev, self._events.mark(), global_step))
                if not report:
                    return
                for duration, g in self._events.resolve():
                    self._account(duration, g)
            else:
                if self.sync:
                    _device_sync()
                self.end_time = time.time()
                self._account(self.end_time - self.start_time, global_step)
            if report:
                self.logging(
                    f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                    f"global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.2f}, "
                    f"CurrSamplesPerSec={self.batch_size / self._curr:.2f}")

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step:
            for duration, g in (self._events.resolve()
                                if self._events is not None else ()):
                self._account(duration, g)
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / max(self.total_elapsed_time, 1e-12)
        return float("nan")
