"""Serving step schedulers: monolithic vs chunked prefill, draft-model
speculative decoding, and multi-token decode dispatch.

Counterpart of ``deepspeed_tpu/inference/scheduler.py``:

- ``monolithic`` (default): the whole (uncached) prompt prefills in one
  bucketed dispatch when a request lands in a slot; every active slot
  decodes one token per engine step, or ``decode_chunk`` tokens.
- ``chunked``: prefill runs ``prefill_chunk_tokens`` at a time, each chunk
  one ``[1, prefill_chunk_tokens]`` dispatch at the chunk's start
  position, interleaved with decode; SLO classes (``latency`` before
  ``throughput``) order queue admission and chunk scheduling, and
  deadlines are checked at every chunk boundary.
- ``chunked`` + ``speculative``: a draft model proposes
  ``num_draft_tokens`` greedy tokens per slot through its OWN paged
  allocator; the target verifies the whole window in one
  ``[max_batch, 1 + num_draft_tokens]`` dispatch.  Greedy accept keeps the
  output identical to the non-speculative run: every accepted token is the
  target's argmax given the true prefix, and the first mismatch is
  replaced by that argmax (the "bonus" token).  Rejected draft positions
  need no rollback: K/V entries past ``lengths`` are never read and are
  overwritten by the next write.

``decode_chunk = K > 1`` runs K decode iterations per engine step on the
model's device with no host sync inside: sampling is on the device
(:func:`sample_tokens`), and the K tokens come to the host once.  Its
random stream is the port's own (a counter-based hash, not JAX's
threefry): a request's draws depend only on (seed, tokens generated so
far), never on its slot or arrival order, and greedy / ``top_k=1`` tokens
and the set of tokens that survive top-k / top-p are the JAX engine's.

:class:`~deepspeed_tpu_torch.inference.serving.ServingEngine` keeps
admission, page reservation, deadlines and tracing, and the device
primitives (``_run_step`` / ``_sample`` / ``_prefill``); the scheduler
owns what each step dispatches.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.utils.hashing import MASK32 as _MASK32
from deepspeed_tpu_torch.utils.hashing import mix32 as _mix32
from deepspeed_tpu_torch.utils.logging import logger

SCHEDULER_POLICIES = ("monolithic", "chunked")

# SLO classes order admission and chunk scheduling under the chunked
# policy: "latency" requests jump the queue and prefill first
SLO_CLASSES = ("latency", "throughput")
_SLO_PRIORITY = {c: i for i, c in enumerate(SLO_CLASSES)}


class SpeculativeConfig(DeepSpeedConfigModel):
    """``serving.scheduler.speculative``: draft-model speculative
    decoding on top of the chunked policy."""

    enabled = False
    # draft tokens proposed (and verified) per decode step; the verify
    # window writes up to num_draft_tokens past the reservation tail, so
    # num_draft_tokens + 1 <= page_size (checked where the page size is
    # known)
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


# ----------------------------------------------------------------------
# on-device sampling
# ----------------------------------------------------------------------
def uniform_noise(seeds, counters, vocab):
    """[B, vocab] float64 uniforms in (0, 1), a pure function of (seed,
    counter, token id): row b hashes (seeds[b], counters[b]) into a key
    and each token id into it.  seeds / counters: int64 [B] tensors."""
    key = _mix32(_mix32(seeds.long() & _MASK32) ^
                 (counters.long() & _MASK32))
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _mix32(key[:, None] ^ ((ids[None, :] * 0x9E3779B1) & _MASK32))
    return (bits.double() + 0.5) / 2.0 ** 32


def filter_logits(logits, temps, top_ks, top_ps):
    """Temperature, then top-k, then top-p, per row, rank-based as the JAX
    engine's ``one_sample``: one stable descending argsort; exactly
    ``k_eff`` ranked tokens survive top-k and the smallest ranked prefix
    whose mass reaches ``top_p`` survives top-p (``top_k = 0`` /
    ``top_p = 1.0`` turn a stage off).  Returns the filtered fp32 logits,
    -1e30 where a token is cut.  logits: [B, V] fp32; temps / top_ps fp32
    [B]; top_ks int [B]."""
    B, V = logits.shape
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=logits.device)
    l = logits / torch.clamp(temps, min=1e-6)[:, None]
    order = torch.argsort(-l, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(V, device=l.device)
                   .expand(B, V).contiguous())
    k_eff = torch.where((top_ks > 0) & (top_ks < V), top_ks,
                        torch.full_like(top_ks, V))
    l = torch.where(ranks < k_eff[:, None].long(), l, neg)
    p = torch.softmax(l, dim=-1)
    cs = torch.cumsum(torch.gather(p, 1, order), dim=-1)
    cut = torch.where(top_ps < 1.0,
                      (cs < top_ps[:, None]).sum(-1) + 1,
                      torch.full_like(k_eff, V).long())
    return torch.where(ranks < cut[:, None], l, neg)


def sample_tokens(logits, temps, seeds, counters, top_ks, top_ps,
                  use_filters=True):
    """One token per row, on the logits' device: the argmax where
    ``temps`` is 0, else a draw from the filtered distribution by the
    Gumbel-max rule over :func:`uniform_noise`.  ``use_filters=False``
    skips the vocabulary sort when no row sets top-k or top-p (the JAX
    engine's plain-temperature branch)."""
    greedy = torch.argmax(logits, dim=-1)
    if use_filters:
        l = filter_logits(logits, temps, top_ks, top_ps)
    else:
        l = logits / torch.clamp(temps, min=1e-6)[:, None]
    u = uniform_noise(seeds, counters, logits.shape[-1])
    gumbel = (-torch.log(-torch.log(u))).to(l.dtype)
    sampled = torch.argmax(l + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy)


class SchedulerBase:
    """Decode machinery shared by every policy.  The decode dispatches
    mask NON-READY slots (empty, or still prefilling under the chunked
    policy) by feeding them a zeroed block-table row and length 0: their
    writes land on the reserved scratch page and the host loop skips
    their outputs."""

    policy = "base"

    def __init__(self, engine, cfg: SchedulerConfig):
        self.engine = engine
        self.cfg = cfg
        self.sched_stats = {"prefill_chunks": 0, "prefills_split": 0,
                            "decode_steps": 0, "decode_tokens": 0}

    # -- admission hooks (called by ServingEngine._admit) ----------------
    def order_queue(self):
        """Reorder the waiting queue before slot filling (policy hook)."""

    def prefill_padded_len(self, suffix_tokens: int) -> int:
        """Padded device length the prefill of ``suffix_tokens`` will
        write -- the engine sizes the page reservation from it."""
        raise NotImplementedError

    def fill_slot(self, slot: int, req, cached: int) -> bool:
        """A queued request just landed in ``slot`` (pages reserved, COW
        done).  Returns True when its prefill ran to completion here."""
        raise NotImplementedError

    def release_slot(self, slot: int, req):
        """The request in ``slot`` is leaving the engine."""

    # -- step hooks ------------------------------------------------------
    def run_step(self) -> Dict[Any, List[int]]:
        raise NotImplementedError

    def pending_prefill_steps(self) -> int:
        """Upper bound on extra step() calls needed to finish every
        in-flight prefill (drain budget sizing)."""
        return 0

    def snapshot(self) -> Dict[str, Any]:
        return {"policy": self.policy, **self.sched_stats}

    def leak_report(self) -> Dict[str, Any]:
        return {}

    # -- shared decode bodies -------------------------------------------
    def _ready_slots(self) -> List[int]:
        eng = self.engine
        return [s for s, r in enumerate(eng.slots)
                if r is not None and r.last_token is not None
                and self._slot_ready(s, r)]

    def _slot_ready(self, slot: int, req) -> bool:
        return True

    def _decode_once(self, ready: List[int]) -> Dict[Any, List[int]]:
        """One token for every ready slot."""
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
        self._evict_faulted(fault_slots)
        return self._finish_slots(done_slots, done_now)

    def _evict_faulted(self, fault_slots):
        from deepspeed_tpu_torch.inference.robustness import EVICT_FAULT
        eng = self.engine
        for slot, err in fault_slots:
            rid = eng.slots[slot].req_id
            logger.warning(f"evicting request {rid!r} after sampler "
                           f"fault: {err}")
            eng._evict_slot(slot, "evicted", EVICT_FAULT, detail=err)
            eng.stats["evicted"] += 1
        if fault_slots:
            eng._admit()

    def _finish_slots(self, done_slots, done_now):
        eng = self.engine
        for slot in done_slots:
            rid = eng.slots[slot].req_id
            eng._finish(slot)
            # hand the result back ONCE
            done_now[rid] = eng.finished.pop(rid)
        return done_now

    # -- the multi-token decode step (K tokens per dispatch) ------------
    def _decode_chunk(self, ready: List[int]) -> Dict[Any, List[int]]:
        """K = ``decode_chunk`` decode iterations on the device, sampling
        included; the K tokens come to the host once.  The host truncates
        past EOS / max_new_tokens (overrun writes land on the scratch
        page: admission reserved every page a live request can validly
        reach).  Sampling keys on (request seed, tokens generated so
        far), so a request's stream is independent of slot and arrival
        order."""
        eng = self.engine
        K = eng.decode_chunk
        B = eng.max_batch
        last = np.zeros(B, np.int64)
        temps = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int64)
        gen_counts = np.zeros(B, np.int64)
        top_ks = np.zeros(B, np.int64)
        top_ps = np.ones(B, np.float32)
        tables = np.zeros_like(eng.tables)
        lengths = np.zeros_like(eng.lengths)
        for slot in ready:
            req = eng.slots[slot]
            last[slot] = req.last_token
            temps[slot] = max(0.0, req.temperature)
            seeds[slot] = int(req.seed) & _MASK32
            gen_counts[slot] = len(req.out)
            top_ks[slot] = req.top_k
            top_ps[slot] = req.top_p
            tables[slot] = eng.tables[slot]
            lengths[slot] = eng.lengths[slot]
        use_filters = any(eng.slots[s].top_k or eng.slots[s].top_p < 1.0
                          for s in ready)
        dev = eng.device

        def put(x):
            return torch.as_tensor(x).to(dev)

        temps_t, seeds_t, counts_t = put(temps), put(seeds), put(gen_counts)
        top_ks_t, top_ps_t = put(top_ks), put(top_ps)
        tables_t = put(tables.astype(np.int32))
        lengths_t = put(lengths.astype(np.int32))
        tok = put(last)
        toks = []
        for t in range(K):
            logits = eng._model_call(tok[:, None], tables_t, lengths_t)
            tok = sample_tokens(logits[:, 0], temps_t, seeds_t,
                                counts_t + t, top_ks_t, top_ps_t,
                                use_filters)
            lengths_t = lengths_t + 1
            toks.append(tok)
        toks = torch.stack(toks, dim=1).cpu().numpy()     # [B, K]
        self.sched_stats["decode_steps"] += 1

        done_slots = []
        for slot in ready:
            req = eng.slots[slot]
            # tokens appended to the cache this chunk: the pre-chunk last
            # token, then the first K-1 samples; sample K-1 is the next
            # chunk's carry
            seq = [req.last_token] + toks[slot, :-1].tolist()
            finished = False
            for tk in seq:
                req.out.append(int(tk))
                eng.lengths[slot] += 1
                self.sched_stats["decode_tokens"] += 1
                if (eng.eos is not None and int(tk) == eng.eos) or \
                        len(req.out) >= req.max_new_tokens:
                    finished = True
                    break
            if finished:
                done_slots.append(slot)
            else:
                req.last_token = int(toks[slot, -1])
        return self._finish_slots(done_slots, {})

    def _decode(self, ready: List[int]) -> Dict[Any, List[int]]:
        if self.engine.decode_chunk > 1:
            return self._decode_chunk(ready)
        return self._decode_once(ready)


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
        return self._decode(self._ready_slots())


class ChunkedScheduler(SchedulerBase):
    """Chunked prefill interleaved with decode, SLO-class ordering, and
    (optionally) draft-model speculative decoding.

    Per engine step: up to ``max_prefill_chunks_per_step`` prefill-chunk
    dispatches run first -- ordered (SLO class, submit time) -- with a
    deadline sweep after EVERY chunk boundary; then one decode dispatch
    advances the slots whose prefill (target AND draft) is complete."""

    policy = "chunked"

    def __init__(self, engine, cfg: SchedulerConfig, draft_model=None):
        super().__init__(engine, cfg)
        self.chunk = int(cfg.prefill_chunk_tokens)
        self.max_chunks = int(cfg.max_prefill_chunks_per_step)
        self.spec = bool(cfg.speculative.enabled)
        self.sched_stats.update(prefill_chunk_tokens=self.chunk)
        if self.spec:
            self._init_spec(draft_model)

    # -- speculative state ----------------------------------------------
    def _init_spec(self, draft_model):
        from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
        eng = self.engine
        if draft_model is None:
            raise ValueError(
                "serving.scheduler.speculative.enabled needs "
                "ServingEngine(draft_model=...)")
        if eng.decode_chunk != 1:
            raise ValueError(
                "speculative decoding replaces decode_chunk batching; "
                "use decode_chunk=1")
        self.gamma = int(self.cfg.speculative.num_draft_tokens)
        if self.gamma + 1 > eng.page_size:
            # the verify window (and the draft's write of the same tokens)
            # overruns the reservation tail by up to gamma positions -- the
            # +1 scratch column absorbs exactly one page
            raise ValueError(
                f"num_draft_tokens + 1 ({self.gamma + 1}) must fit one "
                f"page (page_size {eng.page_size})")
        self.draft_model = draft_model
        # the draft runs through its OWN paged allocator, caches and
        # tables, sized so a full batch of max-length reservations never
        # fails
        draft_pages = eng.max_batch * eng.max_pages_per_seq + 1
        self.draft_alloc = PagedAllocator(draft_pages, eng.page_size,
                                          eng.max_pages_per_seq,
                                          reserve_scratch=True)
        self.draft_caches = draft_model.init_paged_caches(
            draft_pages, eng.page_size, dtype=eng.cache_dtype)
        self.draft_tables = np.zeros_like(eng.tables)
        self.draft_lengths = np.zeros(eng.max_batch, np.int32)
        self._spec_slots = set()
        self.sched_stats.update(spec_windows=0, spec_proposed=0,
                                spec_accepted=0, spec_rejected=0,
                                draft_calls=0)

    def _draft_call(self, ids, tables, lengths):
        """One draft model call on device tensors; returns its logits."""
        eng = self.engine
        logits, self.draft_caches, _ = self.draft_model.apply_with_paged_cache(
            ids, self.draft_caches, tables, lengths,
            attn_backend=eng.attention_backend)
        self.sched_stats["draft_calls"] += 1
        return logits

    def _propose(self, tables, lengths, last):
        """Greedy draft proposal: ``gamma + 1`` single-token draft decodes
        on the device.  The extra iteration writes the LAST proposed token
        into the draft cache, so an accept-all verify leaves no hole.
        Returns [B, gamma + 1] host tokens (only the first gamma used)."""
        toks = []
        tok = last
        for _ in range(self.gamma + 1):
            logits = self._draft_call(tok[:, None], tables, lengths)
            tok = torch.argmax(logits[:, 0], dim=-1)
            lengths = lengths + 1
            toks.append(tok)
        return torch.stack(toks, dim=1).cpu().numpy()

    # -- admission hooks -------------------------------------------------
    def order_queue(self):
        # stable: latency-class requests first, FIFO within a class
        self.engine.queue.sort(
            key=lambda r: _SLO_PRIORITY.get(r.slo_class, 1))

    def prefill_padded_len(self, suffix_tokens: int) -> int:
        return -(-max(suffix_tokens, 1) // self.chunk) * self.chunk

    def fill_slot(self, slot: int, req, cached: int) -> bool:
        eng = self.engine
        req.prefilled = cached
        req.draft_filled = 0
        eng.lengths[slot] = cached
        if len(req.prompt) - cached > self.chunk:
            self.sched_stats["prefills_split"] += 1
        if self.spec and req.temperature <= 0.0:
            # full draft reservation up front, like the target's
            total = len(req.prompt) + req.max_new_tokens
            padded = self.prefill_padded_len(len(req.prompt))
            need = min(max(total, padded),
                       eng.max_pages_per_seq * eng.page_size)
            pages = self.draft_alloc.allocate(req.req_id, need)
            self.draft_tables[slot, :] = 0
            self.draft_tables[slot, :len(pages)] = pages
            self.draft_lengths[slot] = 0
            self._spec_slots.add(slot)
        return False

    def release_slot(self, slot: int, req):
        if self.spec and slot in self._spec_slots:
            self._spec_slots.discard(slot)
            self.draft_alloc.free_sequence(req.req_id)
            self.draft_tables[slot, :] = 0
            self.draft_lengths[slot] = 0

    # -- prefill chunk scheduling ----------------------------------------
    def _prefill_pending(self, slot: int, req) -> bool:
        if req.prefilled < len(req.prompt):
            return True
        return self.spec and slot in self._spec_slots and \
            req.draft_filled < len(req.prompt)

    def _next_prefill_slot(self) -> Optional[int]:
        eng = self.engine
        best, best_key = None, None
        for slot, req in enumerate(eng.slots):
            if req is None or not self._prefill_pending(slot, req):
                continue
            key = (_SLO_PRIORITY.get(req.slo_class, 1), req.submit_time,
                   slot)
            if best_key is None or key < best_key:
                best, best_key = slot, key
        return best

    def _chunk_ids(self, prompt, start):
        toks = prompt[start:start + self.chunk]
        ids = np.zeros((1, self.chunk), np.int32)
        ids[0, :len(toks)] = toks
        return ids, len(toks)

    def _prefill_chunk_unit(self, slot: int, req):
        """One prefill-chunk dispatch for ``slot``: the target prompt
        first, then (spec slots) the draft's own full-prompt prefill.  The
        final target chunk samples the first token and completes the
        admission sequence (trim + prefix insert)."""
        eng = self.engine
        P = len(req.prompt)
        if req.prefilled < P:
            start = req.prefilled
            ids, n = self._chunk_ids(req.prompt, start)
            logits = eng._run_step(ids, eng.tables[slot:slot + 1],
                                   np.full((1,), start, np.int32))
            req.prefilled = start + n
            eng.lengths[slot] = req.prefilled
            self.sched_stats["prefill_chunks"] += 1
            if req.prefilled >= P:
                # the last prompt token's logits seed sampling -- same
                # contract as the monolithic prefill
                req.last_token = eng._sample(
                    req, logits[0, n - 1].cpu().numpy())
                eng.tracer.first_token(req.req_id)
                eng._complete_prefill(slot, req)
            return
        # target done -> catch the draft up on its own cache
        start = req.draft_filled
        ids, n = self._chunk_ids(req.prompt, start)
        dev = eng.device
        self._draft_call(
            torch.as_tensor(ids, dtype=torch.long).to(dev),
            torch.as_tensor(self.draft_tables[slot:slot + 1]).to(dev),
            torch.full((1,), start, dtype=torch.int32, device=dev))
        req.draft_filled = start + n
        self.draft_lengths[slot] = req.draft_filled
        if req.draft_filled >= P:
            # drop the draft's padding surplus, mirroring the target trim
            self.draft_alloc.shrink(req.req_id, P + req.max_new_tokens)
            pages = self.draft_alloc.seq_pages[req.req_id]
            self.draft_tables[slot, :] = 0
            self.draft_tables[slot, :len(pages)] = pages

    def _run_prefill_chunks(self):
        from deepspeed_tpu_torch.inference.robustness import EVICT_FAULT
        eng = self.engine
        for _ in range(self.max_chunks):
            slot = self._next_prefill_slot()
            if slot is None:
                return
            req = eng.slots[slot]
            try:
                self._prefill_chunk_unit(slot, req)
            except Exception as e:   # fault isolation: only THIS request
                logger.warning(f"evicting request {req.req_id!r} after "
                               f"prefill-chunk fault: {e}")
                eng._evict_slot(slot, "evicted", EVICT_FAULT,
                                detail=str(e))
                eng.stats["evicted"] += 1
                continue
            # every chunk boundary cancels expired requests, queued or
            # mid-flight (including the one that was just prefilling)
            eng._expire_deadlines()

    # -- decode ----------------------------------------------------------
    def _slot_ready(self, slot: int, req) -> bool:
        if req.prefilled < len(req.prompt):
            return False
        if self.spec and slot in self._spec_slots:
            return req.draft_filled >= len(req.prompt)
        return True

    def run_step(self) -> Dict[Any, List[int]]:
        self._run_prefill_chunks()
        ready = self._ready_slots()
        if not ready:
            return {}
        if self.spec:
            return self._spec_decode(ready)
        return self._decode(ready)

    def pending_prefill_steps(self) -> int:
        eng = self.engine
        pending = 0
        for slot, req in enumerate(eng.slots):
            if req is None:
                continue
            if req.prefilled < len(req.prompt):
                pending += -(-(len(req.prompt) - req.prefilled)
                             // self.chunk)
            if self.spec and slot in self._spec_slots:
                pending += -(-(len(req.prompt) - req.draft_filled)
                             // self.chunk)
        return pending

    def snapshot(self) -> Dict[str, Any]:
        snap = super().snapshot()
        snap["prefilling_slots"] = sum(
            1 for s, r in enumerate(self.engine.slots)
            if r is not None and self._prefill_pending(s, r))
        if self.spec:
            prop = snap.get("spec_proposed", 0)
            snap["spec_acceptance_rate"] = (
                snap.get("spec_accepted", 0) / prop if prop else 0.0)
        return snap

    def leak_report(self) -> Dict[str, Any]:
        if not self.spec:
            return {}
        eng = self.engine
        leaks: Dict[str, Any] = {}
        active = {r.req_id for r in eng.slots if r is not None}
        stray = sorted(set(self.draft_alloc.seq_pages) - active, key=str)
        if stray:
            leaks["spec_stray_draft_owners"] = stray
        for k, v in self.draft_alloc.audit().items():
            leaks[f"spec_draft_{k}"] = v
        return leaks

    # -- speculative decode ---------------------------------------------
    def _spec_decode(self, ready: List[int]) -> Dict[Any, List[int]]:
        """Draft-propose + single-dispatch verify for every ready slot.

        Greedy slots accept the longest draft prefix matching the
        target's argmaxes, then take the argmax at the first mismatch as
        the bonus token.  Sampled (temperature > 0) slots and slots with a
        1-token remaining budget ride the same verify dispatch at window
        0: position 0 of the window is causally a T=1 decode, so their
        host sampling (and its RNG stream) is untouched."""
        eng = self.engine
        G = self.gamma
        dev = eng.device
        win = np.zeros(eng.max_batch, np.int32)
        specs = []
        for s in ready:
            req = eng.slots[s]
            if s in self._spec_slots and req.temperature <= 0.0:
                w = min(G, req.max_new_tokens - len(req.out) - 1)
                if w > 0:
                    win[s] = w
                    specs.append(s)
        props = np.zeros((eng.max_batch, G), np.int32)
        if specs:
            dlast = np.zeros(eng.max_batch, np.int64)
            dtables = np.zeros_like(self.draft_tables)
            dlengths = np.zeros(eng.max_batch, np.int32)
            for s in specs:
                dlast[s] = eng.slots[s].last_token
                dtables[s] = self.draft_tables[s]
                dlengths[s] = self.draft_lengths[s]
            toks = self._propose(torch.as_tensor(dtables).to(dev),
                                 torch.as_tensor(dlengths).to(dev),
                                 torch.as_tensor(dlast).to(dev))
            props[:, :] = toks[:, :G]
        ids = np.zeros((eng.max_batch, 1 + G), np.int32)
        tables = np.zeros_like(eng.tables)
        lengths = np.zeros_like(eng.lengths)
        for s in ready:
            ids[s, 0] = eng.slots[s].last_token
            tables[s] = eng.tables[s]
            lengths[s] = eng.lengths[s]
        for s in specs:
            ids[s, 1:1 + win[s]] = props[s, :win[s]]
        logits_np = eng._run_step(ids, tables, lengths).cpu().numpy()
        self.sched_stats["decode_steps"] += 1

        done_slots, fault_slots = [], []
        for s in ready:
            req = eng.slots[s]
            if s not in specs:
                # per-token semantics on window position 0
                req.out.append(req.last_token)
                eng.lengths[s] += 1
                self.sched_stats["decode_tokens"] += 1
                ended = (eng.eos is not None and req.last_token == eng.eos)
                if ended or len(req.out) >= req.max_new_tokens:
                    done_slots.append(s)
                else:
                    try:
                        req.last_token = eng._sample(req, logits_np[s, 0])
                    except Exception as e:
                        fault_slots.append((s, str(e)))
                continue
            w = int(win[s])
            g = np.argmax(logits_np[s, :w + 1], axis=-1).astype(np.int32)
            req.out.append(req.last_token)
            eng.lengths[s] += 1
            self.sched_stats["decode_tokens"] += 1
            finished = (eng.eos is not None and req.last_token == eng.eos) \
                or len(req.out) >= req.max_new_tokens
            m = 0
            while not finished and m < w and int(props[s, m]) == int(g[m]):
                tok = int(props[s, m])
                req.out.append(tok)
                eng.lengths[s] += 1
                self.sched_stats["decode_tokens"] += 1
                m += 1
                finished = (eng.eos is not None and tok == eng.eos) or \
                    len(req.out) >= req.max_new_tokens
            self.sched_stats["spec_proposed"] += w
            self.sched_stats["spec_accepted"] += m
            self.sched_stats["spec_rejected"] += w - m
            if finished:
                done_slots.append(s)
            else:
                # g[m]: the target's argmax given the accepted prefix --
                # the bonus (m == w) or the correction at the mismatch
                req.last_token = int(g[m])
            # the draft cache holds every committed position (the extra
            # propose iteration wrote the final proposal too): resume it
            # at the target's new length
            self.draft_lengths[s] = eng.lengths[s]
        if specs:
            self.sched_stats["spec_windows"] += 1
        self._evict_faulted(fault_slots)
        return self._finish_slots(done_slots, {})


def create_scheduler(engine, cfg: SchedulerConfig,
                     draft_model=None) -> SchedulerBase:
    """Build the policy the ``serving.scheduler`` block selects."""
    if not isinstance(cfg, SchedulerConfig):
        cfg = SchedulerConfig(cfg or {})
    if cfg.policy == "chunked":
        return ChunkedScheduler(engine, cfg, draft_model=draft_model)
    if cfg.speculative.enabled:
        raise ValueError(
            "serving.scheduler.speculative needs policy='chunked'")
    if draft_model is not None:
        logger.warning("draft_model ignored: scheduler policy is "
                       f"{cfg.policy!r} without speculative decoding")
    return MonolithicScheduler(engine, cfg)
