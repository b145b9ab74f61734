"""Serving step scheduler.

Counterpart of ``deepspeed_tpu/inference/scheduler.py``, monolithic
subset: the whole (uncached) prompt prefills in one bucketed dispatch when
a request lands in a slot, and every active slot decodes one token per
engine step.  ``SchedulerConfig`` / ``SpeculativeConfig`` keep every key
and validate as the JAX code does (``num_draft_tokens: 0`` is accepted as
"speculation off"); the chunked policy and speculative decoding raise
``NotImplementedError`` (ROADMAP A5).

:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine` keeps
admission, page reservation, deadlines and tracing, and the device
primitives (``_run_step`` / ``_sample`` / ``_prefill``); the scheduler owns
what each step dispatches.
"""

from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.utils.logging import logger

SCHEDULER_POLICIES = ("monolithic", "chunked")

# SLO classes order admission under the chunked policy; they ride every
# request regardless of policy
SLO_CLASSES = ("latency", "throughput")


class SpeculativeConfig(DeepSpeedConfigModel):
    """``serving.scheduler.speculative``: draft-model speculative
    decoding on top of the chunked policy."""

    enabled = False
    num_draft_tokens = 4

    def _validate(self):
        n = int(self.num_draft_tokens)
        if n < 0:
            raise ValueError(
                "serving.scheduler.speculative.num_draft_tokens must be "
                ">= 0")
        if n == 0:
            # 0 is the "speculation off" point
            self.enabled = False


class SchedulerConfig(DeepSpeedConfigModel):
    """The ``serving.scheduler`` config block."""

    policy = "monolithic"
    prefill_chunk_tokens = 256
    max_prefill_chunks_per_step = 1
    slo_class_default = "throughput"
    # per-class deadline defaults: {"latency": {"default_deadline_s": 2.0}}
    slo_classes = {}
    speculative = {}

    def _validate(self):
        if isinstance(self.speculative, dict):
            self.speculative = SpeculativeConfig(self.speculative)
        if self.policy not in SCHEDULER_POLICIES:
            raise ValueError(
                f"serving.scheduler.policy must be one of "
                f"{SCHEDULER_POLICIES}")
        if int(self.prefill_chunk_tokens) < 1:
            raise ValueError(
                "serving.scheduler.prefill_chunk_tokens must be >= 1")
        if int(self.max_prefill_chunks_per_step) < 1:
            raise ValueError(
                "serving.scheduler.max_prefill_chunks_per_step must be "
                ">= 1")
        if self.slo_class_default not in SLO_CLASSES:
            raise ValueError(
                f"serving.scheduler.slo_class_default must be one of "
                f"{SLO_CLASSES}")
        for cls in self.slo_classes:
            if cls not in SLO_CLASSES:
                raise ValueError(
                    f"serving.scheduler.slo_classes key {cls!r} is not "
                    f"one of {SLO_CLASSES}")

    def class_deadline_s(self, slo_class: str) -> Optional[float]:
        """Per-class default TTL, or None when the class has none."""
        spec = self.slo_classes.get(slo_class)
        if not isinstance(spec, dict):
            return None
        ttl = spec.get("default_deadline_s")
        return float(ttl) if ttl else None


class SchedulerBase:
    """Decode machinery shared by every policy.  The decode dispatch masks
    non-ready slots by feeding them a zeroed block-table row and length 0:
    their writes land on the reserved scratch page and the host loop skips
    their outputs."""

    policy = "base"

    def __init__(self, engine, cfg: SchedulerConfig):
        self.engine = engine
        self.cfg = cfg
        self.sched_stats = {"decode_steps": 0, "decode_tokens": 0}

    # -- hooks the engine calls -------------------------------------------
    def prefill_padded_len(self, suffix_tokens: int) -> int:
        """Padded device length the prefill of ``suffix_tokens`` will
        write -- the engine sizes the page reservation from it."""
        raise NotImplementedError

    def fill_slot(self, slot: int, req, cached: int) -> bool:
        """A queued request just landed in ``slot`` (pages reserved).
        Returns True when its prefill ran to completion here."""
        raise NotImplementedError

    def release_slot(self, slot: int, req):
        """The request in ``slot`` is leaving the engine."""

    def run_step(self) -> Dict[Any, List[int]]:
        raise NotImplementedError

    def leak_report(self) -> Dict[str, Any]:
        return {}

    # -- shared decode body ------------------------------------------------
    def _ready_slots(self) -> List[int]:
        eng = self.engine
        return [s for s, r in enumerate(eng.slots)
                if r is not None and r.last_token is not None]

    def _decode_once(self, ready: List[int]) -> Dict[Any, List[int]]:
        """One token for every ready slot."""
        from deepspeed_tpu_torch.inference.robustness import EVICT_FAULT
        eng = self.engine
        last = np.zeros((eng.max_batch, 1), np.int32)
        tables = np.zeros_like(eng.tables)
        lengths = np.zeros_like(eng.lengths)
        for slot in ready:
            req = eng.slots[slot]
            last[slot, 0] = req.last_token
            tables[slot] = eng.tables[slot]
            lengths[slot] = eng.lengths[slot]
        logits = eng._run_step(last, tables, lengths)
        logits_np = logits[:, 0].cpu().numpy()
        self.sched_stats["decode_steps"] += 1

        # finishing frees slots, which admits (and may prefill) queued
        # requests -- defer that until after the loop so a mid-loop
        # admission is never mistaken for a slot this decode step served
        done_slots, fault_slots = [], []
        done_now: Dict[Any, List[int]] = {}
        for slot in ready:
            req = eng.slots[slot]
            req.out.append(req.last_token)
            eng.lengths[slot] += 1
            self.sched_stats["decode_tokens"] += 1
            ended = (eng.eos is not None and req.last_token == eng.eos)
            if ended or len(req.out) >= req.max_new_tokens:
                done_slots.append(slot)
            else:
                try:
                    req.last_token = eng._sample(req, logits_np[slot])
                except Exception as e:   # per-slot fault isolation
                    fault_slots.append((slot, str(e)))
        for slot, err in fault_slots:
            rid = eng.slots[slot].req_id
            logger.warning(f"evicting request {rid!r} after sampler "
                           f"fault: {err}")
            eng._evict_slot(slot, "evicted", EVICT_FAULT, detail=err)
            eng.stats["evicted"] += 1
        if fault_slots:
            eng._admit()
        for slot in done_slots:
            rid = eng.slots[slot].req_id
            eng._finish(slot)
            done_now[rid] = eng.finished.pop(rid)
        return done_now


class MonolithicScheduler(SchedulerBase):
    """The whole (uncached) prompt prefills in one bucketed dispatch at
    slot-fill time; every active slot decodes every step."""

    policy = "monolithic"

    def prefill_padded_len(self, suffix_tokens: int) -> int:
        eng = self.engine
        return min(eng._bucket(suffix_tokens), eng.max_seq)

    def fill_slot(self, slot: int, req, cached: int) -> bool:
        eng = self.engine
        bucket = self.prefill_padded_len(len(req.prompt) - cached)
        eng._prefill(slot, req, bucket, cached)
        return True

    def run_step(self) -> Dict[Any, List[int]]:
        eng = self.engine
        if eng.n_active == 0:
            return {}
        return self._decode_once(self._ready_slots())


def create_scheduler(engine, cfg: SchedulerConfig,
                     draft_model=None, draft_params=None) -> SchedulerBase:
    """Build the policy the ``serving.scheduler`` block selects."""
    if not isinstance(cfg, SchedulerConfig):
        cfg = SchedulerConfig(cfg or {})
    if cfg.policy == "chunked":
        raise NotImplementedError("the chunked prefill scheduler and "
                                  "speculative decoding are not ported yet "
                                  "(ROADMAP A5)")
    if cfg.speculative.enabled:
        raise ValueError(
            "serving.scheduler.speculative needs policy='chunked'")
    if draft_model is not None:
        logger.warning("draft_model ignored: scheduler policy is "
                       f"{cfg.policy!r} without speculative decoding")
    return MonolithicScheduler(engine, cfg)
