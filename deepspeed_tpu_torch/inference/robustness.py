"""Serving hardening layer: typed rejection, admission control, deadlines
and per-request lifecycle tracing for ``ServingEngine``.

Counterpart of ``deepspeed_tpu/inference/robustness.py``, the subset the
engine needs: :class:`RequestRejected`, :class:`ServingStalled`,
:class:`RequestResult`, :class:`ServingRobustnessConfig` (same keys; the
attention backend vocabulary is this package's "auto" | "cuda" |
"plain"), :class:`AdmissionController`, and :class:`RequestTracer` /
:class:`RequestTrace`, which feed ``leak_report()``'s trace-completeness
check.  Telemetry events (the frozen ``serve`` vocabulary) come with
the telemetry plane (ROADMAP A17).
"""

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.ops.decode_attention import ATTENTION_BACKENDS
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

# ----------------------------------------------------------------------
# typed reasons (frozen vocabulary: telemetry attrs + docs/serving.md)
# ----------------------------------------------------------------------
# admission-time rejections (RequestRejected.reason)
REJECT_OVERSIZED = "oversized_prompt"     # prompt + budget exceeds max_seq
REJECT_INFEASIBLE = "infeasible_pages"    # reservation can never fit pool
REJECT_DUPLICATE = "duplicate_id"         # req_id already queued/active
REJECT_BAD_SAMPLING = "bad_sampling"      # top_k/top_p/temperature invalid
REJECT_BAD_REQUEST = "bad_request"        # empty prompt / non-positive budget
REJECT_QUEUE_FULL = "queue_full"          # bounded queue at hard cap
REJECT_OVERLOADED = "overloaded"          # watermark overload, policy=reject
REJECT_DRAINING = "draining"              # drain() stopped admission

# post-admission terminations (RequestResult.reason)
SHED_OLDEST = "shed_oldest"               # displaced by newer arrival
SHED_DEADLINE = "deadline"                # TTL expired (queued or mid-flight)
EVICT_FAULT = "fault"                     # per-slot failure isolated
SHED_DRAIN = "drain"                      # drain() gave up on it

OVERLOAD_POLICIES = ("reject", "shed-oldest", "block")

# the closed set of trace terminals; RequestResult statuses map onto it
# via ``ServingEngine._TERMINAL_BY_STATUS``
TRACE_TERMINALS = ("finish", "shed", "deadline", "evict")


class RequestRejected(Exception):
    """``add_request`` refused this request — the engine state is untouched
    and every other request keeps serving.  ``reason`` is one of the
    ``REJECT_*`` constants; ``detail`` is the human-readable specifics."""

    def __init__(self, req_id, reason: str, detail: str = ""):
        self.req_id = req_id
        self.reason = reason
        self.detail = detail
        super().__init__(
            f"request {req_id!r} rejected ({reason})"
            + (f": {detail}" if detail else ""))


class ServingStalled(RuntimeError):
    """``generate()`` (or ``drain``) could not make progress within its
    step budget.  Unlike the assert it replaces, every already-completed
    result survives in ``partial`` and the stuck state is reported."""

    def __init__(self, partial, stuck_req_ids, free_pages, queue_depth,
                 steps):
        self.partial = dict(partial)
        self.stuck_req_ids = list(stuck_req_ids)
        self.free_pages = int(free_pages)
        self.queue_depth = int(queue_depth)
        self.steps = int(steps)
        super().__init__(
            f"serving stalled after {steps} steps: "
            f"{len(self.partial)} finished, stuck={self.stuck_req_ids}, "
            f"free_pages={free_pages}, queue_depth={queue_depth}")


@dataclass
class RequestResult:
    """Terminal record for a request that did not finish normally.
    ``tokens`` is the partial output (prompt + everything generated before
    termination); ``status`` is one of ``shed`` / ``deadline`` /
    ``evicted`` / ``drained``."""
    req_id: Any
    status: str
    reason: str
    tokens: List[int] = field(default_factory=list)
    n_generated: int = 0
    detail: str = ""


class ServingRobustnessConfig(DeepSpeedConfigModel):
    """The ``serving`` config block (``DeepSpeedInferenceConfig.serving``
    or the ``ServingEngine(serving=...)`` kwarg).  Defaults preserve the
    pre-hardening behaviour: unbounded queue, no deadlines, no shedding —
    only the typed validation is always on."""

    max_queue = 0                   # hard queue cap (0 = unbounded)
    queue_high_watermark = 0        # overload engages at this depth (0=off)
    queue_low_watermark = 0         # ...and releases at this depth
    free_page_low_watermark = 0     # overload engages at <= this many free
    overload_policy = "reject"      # "reject" | "shed-oldest" | "block"
    block_max_steps = 256           # policy=block: step budget before reject
    default_deadline_s = 0.0        # TTL applied when add_request has none
    max_prompt_tokens = 0           # extra prompt cap under max_seq (0=off)
    step_fault_limit = 8            # consecutive serve_step faults -> raise
    fault_injection = {}            # FaultInjector spec (serving sites)
    # paged-attention implementation: "auto" (the CUDA kernel for tensors
    # on the card, the plain version for CPU tensors) | "cuda" | "plain"
    attention_backend = "auto"
    # content-hashed KV-page reuse (inference/prefix_cache.py):
    # {"enabled": bool, "max_cached_pages": int, "min_prefix_tokens": int}
    prefix_cache = {}
    # multi-replica fleet front-end (inference/fleet.py): replicas /
    # min_replicas / max_replicas, health_interval, redispatch_max,
    # autoscale thresholds.  Ignored by a bare ServingEngine.
    fleet = {}
    # step scheduler (inference/scheduler.py): policy ("monolithic" |
    # "chunked"), prefill_chunk_tokens, max_prefill_chunks_per_step,
    # slo_class_default / slo_classes, speculative {enabled,
    # num_draft_tokens}
    scheduler = {}

    def _validate(self):
        # the fleet block stays a dict: a bare engine ignores it
        if isinstance(self.prefix_cache, dict):
            from deepspeed_tpu_torch.inference.prefix_cache import \
                PrefixCacheConfig
            self.prefix_cache = PrefixCacheConfig(self.prefix_cache)
        if isinstance(self.scheduler, dict):
            from deepspeed_tpu_torch.inference.scheduler import \
                SchedulerConfig
            self.scheduler = SchedulerConfig(self.scheduler)
        if self.overload_policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"serving.overload_policy must be one of {OVERLOAD_POLICIES}")
        if self.attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(
                f"serving.attention_backend must be one of "
                f"{ATTENTION_BACKENDS}, got {self.attention_backend!r}")
        for k in ("max_queue", "queue_high_watermark", "queue_low_watermark",
                  "free_page_low_watermark", "block_max_steps",
                  "max_prompt_tokens", "step_fault_limit"):
            if int(getattr(self, k)) < 0:
                raise ValueError(f"serving.{k} must be >= 0")
        if float(self.default_deadline_s) < 0:
            raise ValueError("serving.default_deadline_s must be >= 0")
        if self.queue_high_watermark and \
                int(self.queue_low_watermark) > int(self.queue_high_watermark):
            raise ValueError("serving.queue_low_watermark must be <= "
                             "queue_high_watermark")


class AdmissionController:
    """Watermark hysteresis over (queue depth, free KV pages).

    Overload engages when the queue reaches ``queue_high_watermark`` OR
    free pages fall to ``free_page_low_watermark``; it releases only when
    the queue is back at ``queue_low_watermark`` AND free pages are above
    the page watermark — so one request finishing at the boundary doesn't
    flap admission open and shut."""

    def __init__(self, cfg: ServingRobustnessConfig):
        self.cfg = cfg
        self.overloaded = False

    def update(self, queue_depth: int, free_pages: int) -> bool:
        """Re-evaluate and return the overload state."""
        qhi = int(self.cfg.queue_high_watermark)
        qlo = int(self.cfg.queue_low_watermark)
        plo = int(self.cfg.free_page_low_watermark)
        if not self.overloaded:
            if (qhi and queue_depth >= qhi) or (plo and free_pages <= plo):
                self.overloaded = True
        else:
            queue_ok = (not qhi) or queue_depth <= qlo
            pages_ok = (not plo) or free_pages > plo
            if queue_ok and pages_ok:
                self.overloaded = False
        return self.overloaded


# ----------------------------------------------------------------------
# per-request lifecycle tracing
# ----------------------------------------------------------------------
@dataclass
class RequestTrace:
    """One request's lifecycle timestamps (engine-clock seconds) and the
    latencies derived from them.  ``-1.0`` marks a state never reached —
    the derived accessors return ``None`` for those, so a request evicted
    before its first token reports no TTFT rather than a garbage one."""
    req_id: Any
    t_admit: float
    deadline: float = 0.0       # absolute engine-clock deadline (0 = none)
    slot: int = -1              # batch slot once scheduled
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0
    terminal: str = ""          # one of TRACE_TERMINALS once closed
    t_terminal: float = -1.0
    n_generated: int = 0
    reason: str = ""            # typed reason for abnormal terminals

    def queue_wait_ms(self) -> Optional[float]:
        if self.t_prefill_start < 0:
            return None
        return (self.t_prefill_start - self.t_admit) * 1000.0

    def ttft_ms(self) -> Optional[float]:
        if self.t_first_token < 0:
            return None
        return (self.t_first_token - self.t_admit) * 1000.0

    def tpot_ms(self) -> Optional[float]:
        """Mean time per output token AFTER the first (the decode-rate
        half of the TTFT/TPOT split)."""
        if self.t_first_token < 0 or self.t_terminal < 0 or \
                self.n_generated < 2:
            return None
        return (self.t_terminal - self.t_first_token) * 1000.0 / \
            (self.n_generated - 1)

    def e2e_ms(self) -> Optional[float]:
        if self.t_terminal < 0:
            return None
        return (self.t_terminal - self.t_admit) * 1000.0

    def slo(self) -> Optional[str]:
        """SLO attainment for deadline-bearing requests: ``"ok"`` when the
        request finished on time, ``"miss"`` for every other terminal (a
        shed or evicted deadline request did not meet its SLO either).
        ``None`` when no deadline was set or the trace is still open."""
        if not self.deadline or not self.terminal:
            return None
        ok = self.terminal == "finish" and self.t_terminal <= self.deadline
        return "ok" if ok else "miss"


class RequestTracer:
    """Always-on host-side request lifecycle bookkeeping for the serving
    engine.  Transitions are dict updates against an injectable clock —
    cheap enough to leave on with telemetry disabled; the engine pairs
    each transition with a frozen ``serve/request/*`` event when the
    stream is live.

    The contract this class exists to enforce: every admitted request
    reaches EXACTLY ONE terminal (:data:`TRACE_TERMINALS`).  Violations —
    a double admit, a terminal on an unknown/closed request, an open trace
    with no live owner — are recorded and surfaced by :meth:`audit`, which
    ``ServingEngine.leak_report()`` folds in, so trace leaks fail the same
    invariant sweep page leaks do.

    ``epoch`` namespaces every request id: under a fleet front-end the
    same id legitimately reappears on a respawned replica (redispatch
    after a kill), and without the namespace a merged audit would read
    that as a double admit.  Ids in reports keep the ``epoch:id`` form so
    the replica generation stays visible."""

    def __init__(self, clock=None, max_completed=4096, epoch=None):
        self._clock = clock if clock is not None else time.monotonic
        self.epoch = epoch
        self.open: Dict[Any, RequestTrace] = {}
        # bounded retention: a long-running server must not accumulate a
        # trace per request forever — the counters below stay exact
        self.completed = deque(maxlen=max_completed)
        self.admitted = 0
        self.closed = 0
        self.terminals = {t: 0 for t in TRACE_TERMINALS}
        self.errors: List[str] = []

    def _key(self, req_id):
        """The id this tracer books under — ``"epoch:id"`` when the owner
        is an epoch-stamped fleet replica, the raw id otherwise."""
        return req_id if self.epoch is None else f"{self.epoch}:{req_id}"

    def admit(self, req_id, deadline: float = 0.0,
              now: Optional[float] = None) -> RequestTrace:
        now = self._clock() if now is None else now
        key = self._key(req_id)
        if key in self.open:
            self.errors.append(f"double admit for {key!r}")
            return self.open[key]
        tr = RequestTrace(key, t_admit=now, deadline=float(deadline))
        self.open[key] = tr
        self.admitted += 1
        return tr

    def prefill_start(self, req_id, slot: int) -> Optional[RequestTrace]:
        key = self._key(req_id)
        tr = self.open.get(key)
        if tr is None:
            self.errors.append(f"prefill_start for untracked {key!r}")
            return None
        tr.slot = int(slot)
        tr.t_prefill_start = self._clock()
        return tr

    def first_token(self, req_id) -> Optional[RequestTrace]:
        key = self._key(req_id)
        tr = self.open.get(key)
        if tr is None:
            self.errors.append(f"first_token for untracked {key!r}")
            return None
        tr.t_first_token = self._clock()
        return tr

    def terminal(self, req_id, terminal: str, n_generated: int = 0,
                 reason: str = "") -> Optional[RequestTrace]:
        key = self._key(req_id)
        if terminal not in TRACE_TERMINALS:
            self.errors.append(
                f"unknown terminal {terminal!r} for {key!r}")
            return None
        tr = self.open.pop(key, None)
        if tr is None:
            self.errors.append(
                f"terminal {terminal!r} for closed/unknown {key!r}")
            return None
        tr.terminal = terminal
        tr.t_terminal = self._clock()
        tr.n_generated = int(n_generated)
        tr.reason = reason
        self.terminals[terminal] += 1
        self.closed += 1
        self.completed.append(tr)
        return tr

    def audit(self, live_req_ids) -> Dict[str, Any]:
        """Trace-completeness invariant sweep.  ``live_req_ids`` is every
        request currently queued or active in the engine; returns {} when
        clean, else typed leak entries (the ``leak_report()`` shape)."""
        live = {self._key(r) for r in live_req_ids}
        leaks: Dict[str, Any] = {}
        orphans = sorted(set(self.open) - live, key=str)
        if orphans:
            leaks["trace_open_orphans"] = orphans
        untraced = sorted(live - set(self.open), key=str)
        if untraced:
            leaks["untraced_requests"] = untraced
        if self.errors:
            leaks["trace_errors"] = list(self.errors)
        if self.admitted != self.closed + len(self.open):
            leaks["trace_count_mismatch"] = {
                "admitted": self.admitted, "closed": self.closed,
                "open": len(self.open)}
        return leaks
