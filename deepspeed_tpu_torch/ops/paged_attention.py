"""Paged (block-table) KV cache + ragged decode attention.

Counterpart of ``deepspeed_tpu/ops/paged_attention.py``.  Layout:

  k_pages/v_pages: [num_pages, Hkv, page_size, D] -- the physical pool
  block_tables:    [B, max_pages_per_seq] int32 -- page ids per sequence
  lengths:         [B] int32 -- tokens currently stored per sequence

Two compute paths behind one API: the ragged paged-attention CUDA kernel
(``ops/csrc/ragged_paged_attention.cu``; K/V pages read in place through
the block table) and the plain gather path.  ``resolve_attention_backend``
maps the ``serving.attention_backend`` strings onto them.  Page allocation
is host-side (``PagedAllocator``, a copy of the JAX package's) because it
is control flow, not compute.  The cache writers update the pools IN
PLACE.
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
    paged_attention_plain, ragged_paged_attention_rect)
from deepspeed_tpu_torch.ops.decode_attention import (ATTENTION_BACKENDS,
                                                      resolve_backend,
                                                      validate_backend)

__all__ = ["ATTENTION_BACKENDS", "PagedKVCache", "init_paged_cache",
           "append_paged", "prefill_paged", "paged_decode_attention",
           "PageAllocationError", "PagedAllocator",
           "resolve_attention_backend"]


@dataclass
class PagedKVCache:
    k_pages: torch.Tensor   # [P, Hkv, page, D] (or [L, ...] per layer)
    v_pages: torch.Tensor


def resolve_attention_backend(backend) -> str:
    """Validate a ``serving.attention_backend`` string: "auto" (None),
    "cuda" or "plain".  The JAX spellings ("jnp", "pallas",
    "pallas-interpret") raise a one-line ValueError."""
    return validate_backend(backend)


def init_paged_cache(num_pages, page_size, n_kv_heads, head_dim,
                     dtype=torch.bfloat16, device=None) -> PagedKVCache:
    shape = (num_pages, n_kv_heads, page_size, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device))


def _page_slots(block_tables, pos, page_size):
    """(page id, offset) of absolute positions ``pos`` [B, T].  The table
    column is clamped to the table, as the JAX gather clamps an
    out-of-range index."""
    col = torch.clamp(pos // page_size, max=block_tables.shape[1] - 1)
    page_idx = torch.gather(block_tables.long(), 1, col.long())
    return page_idx, pos % page_size


def append_paged(cache: PagedKVCache, block_tables, lengths, k_new, v_new):
    """Append ONE token per sequence (decode step), in place.
    k_new/v_new: [B, 1, Hkv, D].  Returns (cache, lengths + 1)."""
    return prefill_paged(cache, block_tables, lengths, k_new, v_new)


def prefill_paged(cache: PagedKVCache, block_tables, lengths, k_new, v_new):
    """Write [B, T, Hkv, D] starting at ``lengths`` [B], in place.  The
    pages written must already be mapped in ``block_tables``.  Returns
    (cache, lengths + T)."""
    T = k_new.shape[1]
    page_size = cache.k_pages.shape[2]
    pos = lengths.long()[:, None] + torch.arange(T, device=lengths.device)
    page_idx, offset = _page_slots(block_tables, pos, page_size)
    # advanced indices around the ':' put their broadcast dims first: the
    # indexed view is [B, T, Hkv, D], k_new's layout
    cache.k_pages[page_idx, :, offset] = k_new.to(cache.k_pages.dtype)
    cache.v_pages[page_idx, :, offset] = v_new.to(cache.v_pages.dtype)
    return cache, lengths + T


def paged_decode_attention(q, cache: PagedKVCache, block_tables, lengths,
                           softmax_scale: Optional[float] = None,
                           backend: Optional[str] = "auto",
                           logit_softcap: Optional[float] = None):
    """q: [B, T, H, D] -- the last T tokens of each sequence; lengths: [B]
    int32 tokens stored including them.  ``backend``: "auto" (the kernel
    for CUDA tensors, the plain gather path for CPU tensors), "cuda" or
    "plain"."""
    if logit_softcap:
        raise NotImplementedError("paged attention with a logit softcap is "
                                  "not ported yet (ROADMAP A16)")
    if resolve_backend(backend, q) == "cuda":
        if not q.is_cuda:
            raise ValueError("attention backend 'cuda' needs CUDA tensors")
        return ragged_paged_attention_rect(q, cache.k_pages, cache.v_pages,
                                           block_tables, lengths,
                                           softmax_scale=softmax_scale)
    return paged_attention_plain(q, cache.k_pages, cache.v_pages,
                                 block_tables, lengths,
                                 softmax_scale=softmax_scale)


class PageAllocationError(RuntimeError):
    """Typed allocator failure (pool exhausted, per-sequence cap exceeded,
    or an injected ``page_alloc`` fault)."""


class PagedAllocator:
    """Host-side page bookkeeping: per-sequence page lists over a fixed
    pool with free-list reuse, refcounted pages (a prefix cache may attach
    one page to many sequences) and an LRU "reclaimable" tier for cached
    pages whose last reference dropped.  A copy of the JAX package's
    allocator: the same call sequence yields the same tables."""

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_seq: int, reserve_scratch: bool = False,
                 injector=None):
        """``reserve_scratch``: keep page 0 out of the pool -- serving
        engines point INACTIVE batch slots' tables at page 0.
        ``injector``: an object with ``check(site)`` consulted at the
        ``page_alloc`` site before any page leaves the free list."""
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.scratch_reserved = bool(reserve_scratch)
        self.free: List[int] = list(range(1 if reserve_scratch else 0,
                                          num_pages))
        self.seq_pages = {}
        self.injector = injector
        self.ref = {}                       # page -> live-sequence refcount
        self.cached = set()                 # pages a prefix cache indexed
        self.reclaimable = OrderedDict()    # ref==0 cached pages, LRU order
        self.evict_hook = None              # called with each evicted page
        self.pages_taken = 0
        self.reclaim_evictions = 0

    def can_allocate(self, n_pages: int) -> bool:
        return self.available_page_count >= n_pages

    @property
    def free_page_count(self) -> int:
        return len(self.free)

    @property
    def available_page_count(self) -> int:
        return len(self.free) + len(self.reclaimable)

    def _ref_page(self, page: int):
        self.ref[page] = self.ref.get(page, 0) + 1
        self.reclaimable.pop(page, None)

    def _release_page(self, page: int):
        n = self.ref.get(page, 1) - 1
        if n > 0:
            self.ref[page] = n
            return
        self.ref.pop(page, None)
        if page in self.cached:
            self.reclaimable[page] = None
            self.reclaimable.move_to_end(page)
        else:
            self.free.append(page)

    def _take_page(self) -> int:
        if self.free:
            page = self.free.pop()
        else:
            page = self.evict_reclaimable()
            if page is None:
                raise PageAllocationError("out of KV pages: free list and "
                                          "reclaimable tier both empty")
        self.ref[page] = 1
        self.pages_taken += 1
        return page

    def evict_reclaimable(self) -> Optional[int]:
        if not self.reclaimable:
            return None
        page, _ = self.reclaimable.popitem(last=False)
        self.cached.discard(page)
        self.reclaim_evictions += 1
        if self.evict_hook is not None:
            self.evict_hook(page)
        return page

    def reclaim_to_free(self) -> Optional[int]:
        page = self.evict_reclaimable()
        if page is not None:
            self.free.append(page)
        return page

    def mark_cached(self, page: int):
        self.cached.add(page)

    def unmark_cached(self, page: int):
        self.cached.discard(page)
        if page in self.reclaimable:
            del self.reclaimable[page]
            self.free.append(page)

    def _check_injector(self):
        if self.injector is not None:
            try:
                self.injector.check("page_alloc")
            except Exception as e:
                raise PageAllocationError(
                    f"injected page_alloc fault: {e}") from e

    def allocate(self, seq_id, n_tokens: int, shared=(),
                 protect=()) -> List[int]:
        """Pages for ``n_tokens``, reusing ``shared`` pages (in order) as
        the sequence's leading pages; ``protect`` pages are pinned for the
        duration of the call.  All checks run before any state mutates."""
        shared = list(shared)
        need = -(-n_tokens // self.page_size)
        if need > self.max_pages_per_seq:
            raise PageAllocationError(
                f"{n_tokens} tokens exceed max_pages_per_seq "
                f"({self.max_pages_per_seq})")
        if len(shared) > need:
            raise PageAllocationError(
                f"{len(shared)} shared pages exceed the {need}-page "
                f"reservation for {n_tokens} tokens")
        fresh_needed = need - len(shared)
        pinned = set(shared) | set(protect)
        evictable = sum(1 for p in self.reclaimable if p not in pinned)
        if fresh_needed > len(self.free) + evictable:
            raise PageAllocationError(
                f"out of KV pages: need {fresh_needed}, free "
                f"{len(self.free)} (+{evictable} reclaimable)")
        self._check_injector()
        for p in protect:
            self._ref_page(p)
        try:
            for p in shared:
                self._ref_page(p)
            pages = shared + [self._take_page() for _ in range(fresh_needed)]
        finally:
            for p in protect:
                self._release_page(p)
        self.seq_pages[seq_id] = pages
        return pages

    def extend(self, seq_id, total_tokens: int) -> List[int]:
        pages = self.seq_pages[seq_id]
        need = -(-total_tokens // self.page_size)
        if need > self.max_pages_per_seq:
            raise PageAllocationError(
                f"{total_tokens} tokens exceed max_pages_per_seq "
                f"({self.max_pages_per_seq})")
        if len(pages) < need:
            if not self.can_allocate(need - len(pages)):
                raise PageAllocationError(
                    f"out of KV pages: need {need - len(pages)} more, "
                    f"free {len(self.free)}")
            self._check_injector()
            while len(pages) < need:
                pages.append(self._take_page())
        return pages

    def shrink(self, seq_id, total_tokens: int):
        pages = self.seq_pages[seq_id]
        need = max(1, -(-total_tokens // self.page_size))
        while len(pages) > need:
            self._release_page(pages.pop())

    def free_sequence(self, seq_id):
        for page in self.seq_pages.pop(seq_id, []):
            self._release_page(page)

    def audit(self) -> dict:
        """Refcount/accounting invariants; {} when clean."""
        problems = {}
        held = {}
        for pages in self.seq_pages.values():
            for p in pages:
                held[p] = held.get(p, 0) + 1
        if held != self.ref:
            dangling = {p: n for p, n in self.ref.items()
                        if held.get(p) != n}
            unrefed = {p: n for p, n in held.items()
                       if self.ref.get(p) != n}
            problems["refcounts"] = {"dangling": dangling,
                                     "unreferenced_held": unrefed}
        overlap = (set(self.free) & set(self.reclaimable)) | \
                  (set(self.free) & set(self.ref)) | \
                  (set(self.reclaimable) & set(self.ref))
        if overlap:
            problems["tier_overlap"] = sorted(overlap)
        pool = self.num_pages - (1 if self.scratch_reserved else 0)
        total = len(self.free) + len(self.reclaimable) + len(self.ref)
        if total != pool:
            problems["page_accounting"] = {
                "free": len(self.free), "reclaimable": len(self.reclaimable),
                "referenced": len(self.ref), "pool": pool}
        if not self.cached >= set(self.reclaimable):
            problems["uncached_reclaimable"] = sorted(
                set(self.reclaimable) - self.cached)
        return problems

    def block_table(self, seq_ids) -> np.ndarray:
        """[B, max_pages_per_seq] table (0-padded) for the given batch."""
        out = np.zeros((len(seq_ids), self.max_pages_per_seq), np.int32)
        for b, sid in enumerate(seq_ids):
            pages = self.seq_pages[sid]
            out[b, :len(pages)] = pages
        return out
