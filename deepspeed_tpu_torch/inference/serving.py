"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``deepspeed_tpu/inference/serving.py``: fixed-size pages
shared across sequences through block tables, slot-based continuous
batching (a finished request's pages free immediately and the next prompt
is admitted mid-flight), and one decode dispatch for the whole active
batch regardless of ragged lengths.  Prefill lengths are bucketed to
powers of two, as in the JAX package, so the two engines run the same
shapes and emit the same tokens.

Host/device split: page allocation, admission, deadlines, tracing and
per-token sampling are host control flow; prefill and the batched decode
step are ``CausalTransformerLM.apply_with_paged_cache`` on the model's
device, whose attention is the ragged paged-attention CUDA kernel on the
card (fp32, bf16 or fp16 caches).  The page pools are updated IN PLACE --
the counterpart of the JAX engine's buffer donation.  The
``serving.scheduler`` block picks what each step dispatches
(``inference/scheduler.py``: monolithic or chunked prefill, speculative
decoding with a ``draft_model``, ``decode_chunk`` tokens per dispatch
with on-device sampling), and ``serving.prefix_cache`` attaches cached
prompt pages instead of prefilling them (``inference/prefix_cache.py``).

``serving.fault_injection`` builds the engine's ``FaultInjector``
(``runtime/resilience.py``) when no ``injector`` is passed.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
tensor/expert parallel serving (A14), the disaggregated-fleet
handoff/import plumbing (A11), and telemetry events (A17).
"""

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.prefix_cache import (PrefixCache,
                                                        PrefixMatch)
from deepspeed_tpu_torch.inference.robustness import (
    EVICT_FAULT, REJECT_BAD_REQUEST, REJECT_BAD_SAMPLING, REJECT_DRAINING,
    REJECT_DUPLICATE, REJECT_INFEASIBLE, REJECT_OVERLOADED, REJECT_OVERSIZED,
    REJECT_QUEUE_FULL, SHED_DEADLINE, SHED_DRAIN, SHED_OLDEST,
    AdmissionController, RequestRejected, RequestResult, RequestTracer,
    ServingRobustnessConfig, ServingStalled)
from deepspeed_tpu_torch.inference.scheduler import (SLO_CLASSES,
                                                     create_scheduler)
from deepspeed_tpu_torch.ops.paged_attention import (
    PageAllocationError, PagedAllocator, resolve_attention_backend)
from deepspeed_tpu_torch.runtime.resilience import FaultInjector
from deepspeed_tpu_torch.utils.logging import logger

# RequestResult statuses -> lifecycle-trace terminal names ("drained"
# folds into "shed": a drain IS a shed, engine-initiated)
_TERMINAL_BY_STATUS = {"shed": "shed", "drained": "shed",
                       "deadline": "deadline", "evicted": "evict"}

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16}


def to_torch_dtype(dtype):
    """A torch dtype from a torch dtype or one of the config spellings."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) in _DTYPES:
        return _DTYPES[str(dtype)]
    raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                     f"{sorted(_DTYPES)}")


@dataclass
class _Request:
    req_id: Any
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    top_k: int = 0              # 0 = off
    top_p: float = 1.0          # 1.0 = off
    out: List[int] = field(default_factory=list)
    last_token: Optional[int] = None
    submit_time: float = 0.0
    deadline: float = 0.0       # absolute clock time; 0.0 = no deadline
    slo_class: str = "throughput"
    # chunked-prefill progress: prompt tokens already written to the
    # target / draft KV cache
    prefilled: int = 0
    draft_filled: int = 0


class ServingEngine:
    """``add_request`` -> ``step`` until ``finished`` -- or just
    ``generate(prompts, max_new_tokens)``.

    The weights are the model's own parameters (an ``nn.Module`` on its
    device).  One decode ``step()`` advances EVERY active slot by one
    token; slots free and refill from the queue as requests finish.
    Inactive slots point at the reserved scratch page (page 0) and their
    outputs are ignored.
    """

    def __init__(self, model, max_batch: int = 8, page_size: int = 128,
                 num_pages: Optional[int] = None, max_seq: int = 2048,
                 dtype=torch.bfloat16, eos_token_id: Optional[int] = None,
                 tp_size: int = 1, ep_size: int = 1, decode_chunk: int = 1,
                 serving=None, injector=None, clock=None, draft_model=None):
        """``serving``: a :class:`ServingRobustnessConfig` or its dict.
        ``injector``: an object with ``check(site)`` consulted at the
        ``serve_step`` / ``serve_sample`` / ``page_alloc`` sites (built
        from ``serving.fault_injection`` when omitted).
        ``clock``: monotonic-seconds callable, injectable so deadline
        tests don't sleep.  ``decode_chunk``: decode tokens per dispatch
        (K > 1 samples on the device).  ``draft_model``: the speculative
        proposer, a ``CausalTransformerLM`` on the same device with its
        own weights (``serving.scheduler.speculative``)."""
        if tp_size > 1 or ep_size > 1:
            raise NotImplementedError("tensor/expert-parallel serving is "
                                      "not ported yet (ROADMAP A14)")
        self.decode_chunk = int(decode_chunk)
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.model = model
        self.config = model.config
        self.device = model.device
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_pages_per_seq = -(-max_seq // page_size)
        if num_pages is None:
            num_pages = max_batch * self.max_pages_per_seq + 1
        if isinstance(serving, ServingRobustnessConfig):
            self.serving = serving
        else:
            self.serving = ServingRobustnessConfig(serving or {})
        self.cache_dtype = to_torch_dtype(dtype)
        self.caches = model.init_paged_caches(num_pages, page_size,
                                              dtype=self.cache_dtype)
        if injector is None:
            injector = FaultInjector.from_config(
                self.serving.fault_injection)
        self.injector = injector
        self.alloc = PagedAllocator(num_pages, page_size,
                                    self.max_pages_per_seq,
                                    reserve_scratch=True, injector=injector)
        # content-hashed KV-page reuse: the namespace pins cached pages to
        # this model shape / cache dtype / page size -- the JAX engine's
        # string for the same model, so both index under the same keys
        self.prefix_cache = None
        pc_cfg = self.serving.prefix_cache
        if pc_cfg.enabled:
            mc = self.config
            ns = (f"{type(model).__name__}/L{mc.n_layers}h{mc.hidden_size}"
                  f"q{mc.n_heads}kv{mc.kv_heads}v{mc.vocab_size}/"
                  f"{str(self.cache_dtype).split('.')[-1]}/page{page_size}")
            self.prefix_cache = PrefixCache(
                self.alloc, page_size, namespace=ns,
                max_cached_pages=int(pc_cfg.max_cached_pages),
                min_prefix_tokens=int(pc_cfg.min_prefix_tokens),
                on_evict=self._on_prefix_evict)
        self.eos = eos_token_id
        if not self.config.use_rope and not self.config.use_alibi:
            # learned positions: bound the serve length to the table
            if max_seq > self.config.max_seq_len:
                raise ValueError(
                    f"max_seq {max_seq} exceeds the model's position table "
                    f"({self.config.max_seq_len})")
        self.max_seq = max_seq

        self.slots: List[Optional[_Request]] = [None] * max_batch
        self.queue: List[_Request] = []
        self.finished: Dict[Any, List[int]] = {}
        self.terminated: Dict[Any, RequestResult] = {}
        self.lengths = np.zeros(max_batch, np.int32)
        # +1 overrun column, permanently the scratch page (page 0)
        self.tables = np.zeros((max_batch, self.max_pages_per_seq + 1),
                               np.int32)
        # "auto" (the CUDA kernel for tensors on the card, the plain
        # version for CPU tensors), "cuda" or "plain"
        self.attention_backend = resolve_attention_backend(
            self.serving.attention_backend)
        self._rng = {}
        self._clock = clock if clock is not None else time.monotonic
        self._admission = AdmissionController(self.serving)
        self.tracer = RequestTracer(clock=self._clock)
        self._consec_step_faults = 0
        self.draining = False
        self.stats = {"admitted": 0, "rejected": 0, "shed": 0,
                      "deadline": 0, "evicted": 0, "finished": 0,
                      "step_faults": 0, "drains": 0, "prefix_hits": 0,
                      "prefix_cow_copies": 0, "prefix_evictions": 0,
                      "slo_attained": 0, "slo_missed": 0,
                      "goodput_tokens": 0, "model_calls": 0}
        self.scheduler = create_scheduler(self, self.serving.scheduler,
                                          draft_model=draft_model)

    # -- lifecycle tracing -------------------------------------------------
    def _close_trace(self, req: _Request, terminal: str, reason: str = ""):
        tr = self.tracer.terminal(req.req_id, terminal,
                                  n_generated=len(req.out), reason=reason)
        if tr is None:   # leak_report() will surface the tracer error
            return
        slo = tr.slo()
        if slo == "ok":
            self.stats["slo_attained"] += 1
        elif slo == "miss":
            self.stats["slo_missed"] += 1
        if terminal == "finish":
            self.stats["goodput_tokens"] += len(req.out)

    # -- host control flow ---------------------------------------------
    def _reject(self, req_id, reason, detail=""):
        self.stats["rejected"] += 1
        raise RequestRejected(req_id, reason, detail)

    def add_request(self, req_id, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0, seed: int = 0,
                    top_k: int = 0, top_p: float = 1.0,
                    deadline_s: Optional[float] = None,
                    slo_class: Optional[str] = None):
        """Validate and enqueue one request.  Raises
        :class:`RequestRejected` (typed reason, engine state untouched);
        ``deadline_s`` is a TTL from now."""
        cfg = self.serving
        if self.draining:
            self._reject(req_id, REJECT_DRAINING,
                         "engine is draining; admission stopped")
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt or int(max_new_tokens) <= 0:
            self._reject(req_id, REJECT_BAD_REQUEST,
                         f"prompt len {len(prompt)}, "
                         f"max_new_tokens {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_seq:
            self._reject(req_id, REJECT_OVERSIZED,
                         f"prompt {len(prompt)} + budget {max_new_tokens} "
                         f"exceeds max_seq {self.max_seq}")
        if cfg.max_prompt_tokens and len(prompt) > int(cfg.max_prompt_tokens):
            self._reject(req_id, REJECT_OVERSIZED,
                         f"prompt {len(prompt)} exceeds "
                         f"serving.max_prompt_tokens {cfg.max_prompt_tokens}")
        total = len(prompt) + max_new_tokens
        padded = self.scheduler.prefill_padded_len(len(prompt))
        need = -(-min(max(total, padded),
                      self.max_pages_per_seq * self.page_size)
                 // self.page_size)
        usable = self.alloc.num_pages - 1   # minus the scratch page
        if need > usable:
            self._reject(req_id, REJECT_INFEASIBLE,
                         f"needs {need} pages but the pool only has "
                         f"{usable}; it would deadlock the queue "
                         "head-of-line")
        if req_id in self.alloc.seq_pages or req_id in self.finished or \
                any(r.req_id == req_id for r in self.queue):
            self._reject(req_id, REJECT_DUPLICATE,
                         "req_id already queued, active, or undelivered")
        if not (0.0 < top_p <= 1.0) or top_k < 0 or temperature < 0.0:
            self._reject(req_id, REJECT_BAD_SAMPLING,
                         f"top_k={top_k}, top_p={top_p}, "
                         f"temperature={temperature}")
        sched_cfg = cfg.scheduler
        if slo_class is None:
            slo_class = sched_cfg.slo_class_default
        if slo_class not in SLO_CLASSES:
            self._reject(req_id, REJECT_BAD_REQUEST,
                         f"slo_class {slo_class!r} is not one of "
                         f"{SLO_CLASSES}")
        self._apply_admission_policy(req_id)
        now = self._clock()
        ttl = deadline_s if deadline_s is not None \
            else (sched_cfg.class_deadline_s(slo_class)
                  or float(cfg.default_deadline_s) or None)
        deadline = (now + ttl) if ttl else 0.0
        self.queue.append(_Request(req_id, prompt, max_new_tokens,
                                   temperature, seed, top_k, top_p,
                                   submit_time=now, deadline=deadline,
                                   slo_class=slo_class))
        self.stats["admitted"] += 1
        self.tracer.admit(req_id, deadline=deadline, now=now)
        self._admit()

    def _admission_pressure(self):
        cfg = self.serving
        hard_full = bool(cfg.max_queue) and \
            len(self.queue) >= int(cfg.max_queue)
        overloaded = self._admission.update(len(self.queue),
                                            self.alloc.available_page_count)
        return hard_full, overloaded

    def _apply_admission_policy(self, req_id):
        """No-op until the hard queue cap or a watermark trips, then apply
        ``serving.overload_policy`` (reject | shed-oldest | block)."""
        hard_full, overloaded = self._admission_pressure()
        if not hard_full and not overloaded:
            return
        policy = self.serving.overload_policy
        if policy == "block":
            for _ in range(int(self.serving.block_max_steps)):
                if not (self.queue or self.n_active):
                    break
                self.finished.update(self.step())
                hard_full, overloaded = self._admission_pressure()
                if not hard_full and not overloaded:
                    return
        elif policy == "shed-oldest" and self.queue:
            victim = self.queue.pop(0)
            self._terminate(victim, "shed", SHED_OLDEST,
                            detail=f"displaced by {req_id!r}")
            self.stats["shed"] += 1
            return
        reason = REJECT_QUEUE_FULL if hard_full else REJECT_OVERLOADED
        self._reject(req_id, reason,
                     f"queue_depth={len(self.queue)}, "
                     f"free_pages={self.alloc.free_page_count}, "
                     f"policy={policy}")

    def _bucket(self, n: int) -> int:
        return 1 << max(3, math.ceil(math.log2(max(n, 1))))

    def _terminate(self, req: _Request, status: str, reason: str,
                   detail: str = ""):
        """Record the typed terminal result for a request leaving the
        engine abnormally (partial output included)."""
        self._rng.pop(req.req_id, None)
        self.terminated[req.req_id] = RequestResult(
            req_id=req.req_id, status=status, reason=reason,
            tokens=list(req.prompt) + list(req.out),
            n_generated=len(req.out), detail=detail)
        self._close_trace(req, _TERMINAL_BY_STATUS[status], reason=reason)

    def _evict_slot(self, slot: int, status: str, reason: str,
                    detail: str = ""):
        """Remove ONE active request: free its pages, zero its table row
        and length, record the terminal result."""
        req = self.slots[slot]
        self.scheduler.release_slot(slot, req)
        self.alloc.free_sequence(req.req_id)
        self.slots[slot] = None
        self.lengths[slot] = 0
        self.tables[slot, :] = 0
        self._terminate(req, status, reason, detail)

    def _expire_deadlines(self):
        """Cancel every expired request at this step boundary."""
        now = self._clock()
        keep, expired = [], []
        for req in self.queue:
            (expired if req.deadline and now >= req.deadline
             else keep).append(req)
        self.queue = keep
        for req in expired:
            self._terminate(req, "deadline", SHED_DEADLINE,
                            detail="expired while queued")
            self.stats["deadline"] += 1
        evicted = False
        for slot, req in enumerate(self.slots):
            if req is not None and req.deadline and now >= req.deadline:
                self._evict_slot(slot, "deadline", SHED_DEADLINE,
                                 detail="expired mid-flight")
                self.stats["deadline"] += 1
                evicted = True
        if evicted:
            self._admit()

    def _admit(self):
        # policy hook: the chunked scheduler stable-sorts latency-class
        # requests ahead of throughput-class ones (FIFO within a class)
        self.scheduler.order_queue()
        for slot in range(self.max_batch):
            if not self.queue or self.slots[slot] is not None:
                continue
            req = self.queue[0]
            total = len(req.prompt) + req.max_new_tokens
            # prefix cache: attach every fully cached prefix page without
            # prefill; a partial next-page match copies on write.  The
            # lookup is a pure read -- nothing is pinned until allocate().
            match = (self.prefix_cache.lookup(req.prompt)
                     if self.prefix_cache is not None else PrefixMatch())
            cached = match.cached_tokens(self.page_size)
            padded = self.scheduler.prefill_padded_len(
                len(req.prompt) - cached)
            # reservation covers the budget AND the padded suffix prefill;
            # padding writes past it land on the scratch page
            need_tokens = min(max(total, cached + padded),
                              self.max_pages_per_seq * self.page_size)
            shared = list(match.pages)
            protect = (match.cow_src,) if match.cow_src is not None else ()
            need_fresh = -(-need_tokens // self.page_size) - len(shared)
            pinned = set(shared) | set(protect)
            evictable = sum(1 for p in self.alloc.reclaimable
                            if p not in pinned)
            if need_fresh > self.alloc.free_page_count + evictable:
                return          # head-of-line: keep FIFO order
            # full reservation (prompt + budget) at admission: an admitted
            # request never deadlocks on pages mid-flight.  Allocate
            # BEFORE popping, so an allocation fault mutates nothing.
            try:
                pages = self.alloc.allocate(req.req_id, need_tokens,
                                            shared=shared, protect=protect)
            except PageAllocationError:
                self.stats["step_faults"] += 1
                return
            if cached:
                self.stats["prefix_hits"] += 1
            self.queue.pop(0)
            self.tables[slot, :] = 0
            self.tables[slot, :len(pages)] = pages
            self.lengths[slot] = 0
            self.slots[slot] = req
            self.tracer.prefill_start(req.req_id, slot)
            try:
                if match.cow_src is not None:
                    # the request's first owned page inherits the partial
                    # match's content; its divergent tail is overwritten
                    # by the suffix prefill, so the shared source page is
                    # never touched
                    self._copy_page(match.cow_src, pages[len(shared)])
                    self.stats["prefix_cow_copies"] += 1
                complete = self.scheduler.fill_slot(slot, req, cached)
            except Exception as e:   # fault isolation: only THIS request
                logger.warning(f"evicting request {req.req_id!r} after "
                               f"prefill fault: {e}")
                self._evict_slot(slot, "evicted", EVICT_FAULT,
                                 detail=str(e))
                self.stats["evicted"] += 1
                continue
            if complete:
                # monolithic: the whole prefill ran inside fill_slot; the
                # chunked policy completes at its last chunk
                self._complete_prefill(slot, req)

    def _complete_prefill(self, slot: int, req: _Request):
        """Admission tail once the prompt is in cache: trim the padded
        reservation to the true need and index the prompt's full pages
        into the prefix cache."""
        self._trim_reservation(slot, req)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt,
                                     self.alloc.seq_pages[req.req_id])

    def _trim_reservation(self, slot: int, req: _Request):
        """Trim the slot's reservation to the request's TRUE page need
        (the bucketed prefill over-allocates to the padded length)."""
        total = len(req.prompt) + req.max_new_tokens
        self.alloc.shrink(req.req_id, total)
        pages = self.alloc.seq_pages[req.req_id]
        expected = max(1, -(-total // self.page_size))
        if len(pages) != expected:
            raise RuntimeError(
                f"request {req.req_id!r}: {len(pages)} pages held after "
                f"trim, expected {expected} for {total} tokens "
                f"(page_size {self.page_size})")
        self.tables[slot, :] = 0
        self.tables[slot, :len(pages)] = pages

    def _model_call(self, ids, tables, lengths):
        """One model call on device tensors: ids [B, T] (long), tables
        [B, cols] and lengths [B] (int32).  The page pools update in
        place; returns the fp32 logits [B, T, V]."""
        logits, self.caches, _ = self.model.apply_with_paged_cache(
            ids, self.caches, tables, lengths,
            attn_backend=self.attention_backend)
        self.stats["model_calls"] += 1
        return logits

    def _run_step(self, ids, tables, lengths):
        """:meth:`_model_call` on host arrays."""
        dev = self.device
        return self._model_call(
            torch.as_tensor(ids, dtype=torch.long).to(dev),
            torch.as_tensor(tables, dtype=torch.int32).to(dev),
            torch.as_tensor(lengths, dtype=torch.int32).to(dev))

    # -- prefix-cache plumbing ------------------------------------------
    def _on_prefix_evict(self, page: int):
        """The allocator reclaimed a cached page for a fresh allocation
        (the cache already dropped its index entries)."""
        self.stats["prefix_evictions"] += 1

    def _copy_page(self, src: int, dst: int):
        """Copy-on-write: copy one KV page (every layer, K and V) into the
        request's own fresh page, in place on the pools."""
        for pool in (self.caches.k_pages, self.caches.v_pages):
            pool[:, dst] = pool[:, src]

    def _prefill(self, slot: int, req: _Request, bucket: int,
                 cached: int = 0):
        """Prefill the prompt in one bucket-padded dispatch at start
        position ``cached`` and sample the first token."""
        suffix = req.prompt[cached:]
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :len(suffix)] = suffix
        logits = self._run_step(ids, self.tables[slot:slot + 1],
                                np.full((1,), cached, np.int32))
        self.lengths[slot] = len(req.prompt)
        req.prefilled = len(req.prompt)
        req.last_token = self._sample(
            req, logits[0, len(suffix) - 1].cpu().numpy())
        self.tracer.first_token(req.req_id)

    def _sample(self, req: _Request, logits: np.ndarray) -> int:
        if self.injector is not None:
            self.injector.check("serve_sample")
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        rng = self._rng.setdefault(req.req_id,
                                   np.random.default_rng(req.seed))
        l = logits.astype(np.float64) / req.temperature
        V = len(l)
        if req.top_k or req.top_p < 1.0:
            # rank-based filtering -- EXACTLY cut tokens survive, stable
            # tie order
            order = np.argsort(-l, kind="stable")
            ranks = np.empty(V, np.int64)
            ranks[order] = np.arange(V)
            k_eff = req.top_k if 0 < req.top_k < V else V
            l = np.where(ranks < k_eff, l, -np.inf)
            p = np.exp(l - l.max())
            p = p / p.sum()
            if req.top_p < 1.0:
                cs = np.cumsum(p[order])
                # smallest prefix whose mass reaches top_p
                cut = int(np.searchsorted(cs, req.top_p) + 1)
                p = np.where(ranks < cut, p, 0.0)
                p = p / p.sum()
        else:
            p = np.exp(l - l.max())
            p = p / p.sum()
        return int(rng.choice(V, p=p))

    def _finish(self, slot: int):
        req = self.slots[slot]
        self.finished[req.req_id] = req.prompt + req.out
        if self.prefix_cache is not None:
            # index the finished sequence's full pages (prompt AND
            # generated tokens: a turn's output is the next turn's prompt)
            # BEFORE the refcounts drop, so they park in the reclaimable
            # tier instead of dissolving into the free list
            self.prefix_cache.insert(req.prompt + req.out,
                                     self.alloc.seq_pages[req.req_id])
        self.scheduler.release_slot(slot, req)
        self.alloc.free_sequence(req.req_id)
        self._rng.pop(req.req_id, None)
        self.slots[slot] = None
        self.lengths[slot] = 0
        self.tables[slot, :] = 0
        self.stats["finished"] += 1
        self._close_trace(req, "finish")
        self._admit()

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- the batched decode step ---------------------------------------
    def step(self) -> Dict[Any, List[int]]:
        """Advance the engine by one scheduler step: under the monolithic
        policy every active request by one token (``decode_chunk`` tokens
        when configured); under the chunked policy up to
        ``max_prefill_chunks_per_step`` prefill chunks first, then one
        decode (or speculative draft + verify) dispatch for every fully
        prefilled slot.  Returns ONLY the requests that finished during
        this step (req_id -> full tokens).
        Expired deadlines are cancelled first; an injected ``serve_step``
        fault returns {} without mutating any request, and raises only
        after ``serving.step_fault_limit`` consecutive faults."""
        self._expire_deadlines()
        if self.injector is not None:
            try:
                self.injector.check("serve_step")
            except Exception:
                self._consec_step_faults += 1
                self.stats["step_faults"] += 1
                if self._consec_step_faults > \
                        int(self.serving.step_fault_limit):
                    raise
                return {}
            self._consec_step_faults = 0
        self._admit()
        return self.scheduler.run_step()

    # -- lifecycle / introspection --------------------------------------
    def pop_terminated(self) -> Dict[Any, RequestResult]:
        out = self.terminated
        self.terminated = {}
        return out

    def drain(self, timeout_s: Optional[float] = None,
              max_steps: Optional[int] = None) -> Dict[str, Any]:
        """Gracefully quiesce: stop admission, shed everything still
        queued, then step until in-flight work finishes or the budget
        (``max_steps``, default the largest remaining token budget over
        ``decode_chunk`` plus pending prefill chunks; ``timeout_s`` wall
        clock) runs out -- whatever is left is shed with its partial
        output.  Returns ``{"finished", "shed", "steps", "health"}``;
        afterwards the engine holds no active slot and no page."""
        self.draining = True
        shed_ids = []
        for req in list(self.queue):
            self._terminate(req, "drained", SHED_DRAIN,
                            detail="shed from queue by drain()")
            self.stats["shed"] += 1
            shed_ids.append(req.req_id)
        self.queue = []
        if max_steps is None:
            remaining = [r.max_new_tokens - len(r.out)
                         for r in self.slots if r is not None]
            max_steps = (-(-max(remaining) // self.decode_chunk) + 4) \
                if remaining else 0
            # chunked policy: in-flight prefills consume whole steps
            max_steps += self.scheduler.pending_prefill_steps()
        start = self._clock()
        finished: Dict[Any, List[int]] = {}
        steps = 0
        while self.n_active and steps < max_steps:
            if timeout_s is not None and \
                    self._clock() - start >= timeout_s:
                break
            finished.update(self.step())
            steps += 1
        for slot, req in enumerate(self.slots):
            if req is not None:
                self._evict_slot(slot, "drained", SHED_DRAIN,
                                 detail="drain budget exhausted")
                self.stats["shed"] += 1
                shed_ids.append(req.req_id)
        self.stats["drains"] += 1
        return {"finished": finished, "shed": shed_ids, "steps": steps,
                "health": self.health()}

    def health(self) -> Dict[str, Any]:
        """Operational snapshot: pages, queue, slots, counters, the
        scheduler's stats and (when on) the prefix cache's."""
        now = self._clock()
        live = list(self.queue) + [r for r in self.slots if r is not None]
        snap = {
            "free_pages": self.alloc.free_page_count,
            # free + reclaimable: what admission actually sees
            "available_pages": self.alloc.available_page_count,
            "total_pages": self.alloc.num_pages - 1,
            "queue_depth": len(self.queue),
            "active_slots": self.n_active,
            "max_batch": self.max_batch,
            "oldest_request_age_s": float(max(
                (now - r.submit_time for r in live), default=0.0)),
            "draining": self.draining,
            "overloaded": self._admission.overloaded,
            "undelivered_terminated": len(self.terminated),
            "counters": dict(self.stats),
            "slo": {"attained": self.stats["slo_attained"],
                    "missed": self.stats["slo_missed"],
                    "goodput_tokens": self.stats["goodput_tokens"]},
            "traces": {"open": len(self.tracer.open),
                       "admitted": self.tracer.admitted,
                       "closed": self.tracer.closed,
                       "terminals": dict(self.tracer.terminals)},
            "scheduler": self.scheduler.snapshot(),
        }
        if self.prefix_cache is not None:
            snap["prefix_cache"] = self.prefix_cache.snapshot()
        return snap

    def leak_report(self) -> Dict[str, Any]:
        """Invariant audit: every page, RNG stream and table row is owned
        by a live slot, refcounts match (pages are SHARED under the prefix
        cache), the prefix-cache index agrees with the allocator's cached
        set, every active reservation equals its true page need, and every
        admitted request is live or reached exactly one terminal.  Returns
        {} when clean."""
        active = {r.req_id for r in self.slots if r is not None}
        leaks: Dict[str, Any] = {}
        stray_pages = sorted(set(self.alloc.seq_pages) - active, key=str)
        if stray_pages:
            leaks["stray_page_owners"] = stray_pages
        stray_rng = sorted(set(self._rng) - active, key=str)
        if stray_rng:
            leaks["stray_rng"] = stray_rng
        leaks.update(self.alloc.audit())
        if self.prefix_cache is not None:
            leaks.update(self.prefix_cache.audit())
        dirty = [s for s in range(self.max_batch)
                 if self.slots[s] is None and
                 (self.lengths[s] != 0 or self.tables[s].any())]
        if dirty:
            leaks["dirty_inactive_slots"] = dirty
        over = {}
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            total = len(req.prompt) + req.max_new_tokens
            expected = max(1, -(-total // self.page_size))
            held = len(self.alloc.seq_pages.get(req.req_id, ()))
            if held != expected:
                over[str(req.req_id)] = {"held": held, "expected": expected}
        if over:
            leaks["over_reserved_slots"] = over
        leaks.update(self.scheduler.leak_report())
        live = {r.req_id for r in self.queue} | active
        leaks.update(self.tracer.audit(live))
        return leaks

    # -- convenience ----------------------------------------------------
    def generate(self, prompts, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> List[List[int]]:
        """Serve a list of prompts (continuous batching when
        len(prompts) > max_batch); returns full token lists in order.  A
        stall raises :class:`ServingStalled` carrying every completed
        result."""
        for i, p in enumerate(prompts):
            self.add_request(i, p, max_new_tokens, temperature,
                             top_k=top_k, top_p=top_p)
        steps = 0
        results: Dict[Any, List[int]] = {}
        limit = (max(len(p) for p in prompts) + max_new_tokens + 4) * \
            (len(prompts) + 1)
        if self.scheduler.policy == "chunked":
            # prefill chunks (and the draft's own prefill under
            # speculative decoding) consume whole steps before a slot
            # decodes: 3x covers target + draft chunks with slack
            limit *= 3
        while (self.queue or self.n_active) and steps < limit:
            results.update(self.step())
            steps += 1
        if self.queue or self.n_active:
            stuck = [r.req_id for r in self.queue] + \
                [r.req_id for r in self.slots if r is not None]
            raise ServingStalled(results, stuck,
                                 self.alloc.free_page_count,
                                 len(self.queue), steps)
        out = []
        for i in range(len(prompts)):
            if i in results:
                out.append(results[i])
            elif i in self.finished:   # finished inside a blocked add
                out.append(self.finished.pop(i))
            else:   # terminated mid-flight: partial tokens, in place
                out.append(self.terminated.pop(i).tokens)
        return out


def create_serving_engine(model, config=None, **kwargs):
    """Build a :class:`ServingEngine` from a ds-style config dict: engine
    geometry (``max_batch`` / ``page_size`` / ``num_pages`` / ``max_seq``
    / ``decode_chunk`` / ``tp_size`` / ``ep_size`` / ``eos_token_id``) may
    sit at top level or inside the ``serving`` block; everything else in
    ``serving`` is the engine's robustness config.  Explicit ``**kwargs``
    win.  The autotuner overlay is not ported (ROADMAP A17)."""
    cfg = dict(config or {})
    if (cfg.get("autotuning") or {}).get("overlay_path"):
        raise NotImplementedError("autotuner overlays are not ported yet "
                                  "(ROADMAP A17)")
    serving = dict(cfg.get("serving") or {})
    geometry = ("max_batch", "page_size", "num_pages", "max_seq",
                "decode_chunk", "tp_size", "ep_size", "eos_token_id")
    eng_kwargs = {}
    for key in geometry:
        if key in cfg:
            eng_kwargs[key] = cfg[key]
        if key in serving:
            eng_kwargs[key] = serving.pop(key)
    eng_kwargs["serving"] = serving
    eng_kwargs.update(kwargs)
    return ServingEngine(model, **eng_kwargs)
