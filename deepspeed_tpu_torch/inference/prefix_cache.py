"""Prefix cache: content-hashed KV-page reuse for the serving engine.

Counterpart of ``deepspeed_tpu/inference/prefix_cache.py``: the same
blake2b chain keys, lookup, insert and eviction rules, so the two engines
index the same pages under the same keys.  Layered on the refcounted
:class:`~deepspeed_tpu_torch.ops.paged_attention.PagedAllocator`:

* **Content-hash chain.**  Every FULL page of a served sequence is indexed
  under ``key_j = H(key_{j-1} || tokens[j*ps:(j+1)*ps])``, the chain
  seeded by a namespace string (model shape / cache dtype / page size),
  so page ``j`` is shared iff two prompts agree on every token up to
  ``(j+1)*ps``, and a page of another model, dtype or page size is
  unreachable.
* **Attach, don't copy.**  A lookup hands back the matched pages; the
  engine attaches them to the new request's block table
  (``allocate(..., shared=...)``: refcount bumps, no prefill, no copy).
  Suffix writes start after the match, so a shared full page is never
  written.
* **Copy-on-write for partial pages.**  When the next cached page agrees
  with the remaining prompt on a proper prefix, the engine copies it into
  a fresh page of the request's own and prefills only the divergent tail.
* **LRU reclaim tier.**  A cached page whose last reference drops parks
  in the allocator's reclaimable tier, still holding its K/V; the
  allocator evicts it (oldest first) only when an allocation outgrows the
  free list, calling back here so the index never points at a recycled
  page.

The last prompt token is never served from cache (its logits seed
sampling), so every request prefills at least one token.  Everything here
is host control flow; the only device work is the engine's page copy.
"""

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class PrefixCacheConfig(DeepSpeedConfigModel):
    """The ``serving.prefix_cache`` config block."""

    enabled = False
    max_cached_pages = 0     # cap on indexed pages (0 = bounded by pool)
    min_prefix_tokens = 0    # don't consult/populate below this prompt len

    def _validate(self):
        for k in ("max_cached_pages", "min_prefix_tokens"):
            if int(getattr(self, k)) < 0:
                raise ValueError(f"serving.prefix_cache.{k} must be >= 0")


@dataclass
class PrefixMatch:
    """One lookup's result: ``pages`` are full cached pages to attach
    (refcount-shared, in chain order); ``cow_src`` an optional partial
    match whose first ``cow_tokens`` tokens agree with the prompt (the
    engine copies it into a fresh page before writing)."""
    pages: List[int] = field(default_factory=list)
    cow_src: Optional[int] = None
    cow_tokens: int = 0

    def cached_tokens(self, page_size: int) -> int:
        """Total prompt tokens this match serves from cache."""
        return len(self.pages) * page_size + self.cow_tokens


class PrefixCache:
    """Content-hash index over full KV pages, layered on a refcounted
    :class:`~deepspeed_tpu_torch.ops.paged_attention.PagedAllocator`."""

    def __init__(self, alloc, page_size: int, namespace: str = "",
                 max_cached_pages: int = 0, min_prefix_tokens: int = 0,
                 on_evict=None):
        self.alloc = alloc
        self.page_size = int(page_size)
        self.namespace = str(namespace)
        self.max_cached_pages = int(max_cached_pages)
        self.min_prefix_tokens = int(min_prefix_tokens)
        self._on_evict_cb = on_evict
        self._root = hashlib.blake2b(
            self.namespace.encode(), digest_size=16).digest()
        self.index: Dict[bytes, int] = {}        # chain key -> page id
        self.key_of: Dict[int, bytes] = {}       # page id -> chain key
        self.tokens_of: Dict[int, Tuple[int, ...]] = {}
        self.parent_of: Dict[int, bytes] = {}
        self.children: Dict[bytes, Set[int]] = {}
        self.stats = {"lookups": 0, "hits": 0, "pages_reused": 0,
                      "tokens_reused": 0, "cow_copies": 0, "inserts": 0,
                      "evictions": 0, "pages_needed": 0}
        alloc.evict_hook = self._on_evict

    # -- hashing ---------------------------------------------------------
    def _chain_key(self, parent: bytes, page_tokens) -> bytes:
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.asarray(page_tokens, np.int64).tobytes())
        return h.digest()

    # -- lookup ----------------------------------------------------------
    def lookup(self, prompt: List[int]) -> PrefixMatch:
        """Longest cached prefix of ``prompt`` (full pages, then one
        optional partial/COW page), capped at ``len(prompt) - 1`` so the
        last token always prefills.  Pure read: the engine must attach the
        pages in the same host step for the ids to stay valid."""
        ps = self.page_size
        match = PrefixMatch()
        self.stats["lookups"] += 1
        self.stats["pages_needed"] += -(-len(prompt) // ps)
        if len(prompt) < max(self.min_prefix_tokens, 2):
            return match
        usable = len(prompt) - 1
        key, pos = self._root, 0
        while pos + ps <= usable:
            nxt = self._chain_key(key, prompt[pos:pos + ps])
            page = self.index.get(nxt)
            if page is None:
                break
            match.pages.append(page)
            key, pos = nxt, pos + ps
        rem = usable - pos
        if rem > 0:
            best, best_m = None, 0
            for page in self.children.get(key, ()):
                toks = self.tokens_of.get(page)
                if not toks:
                    continue
                m = 0
                while m < rem and toks[m] == prompt[pos + m]:
                    m += 1
                if m > best_m:
                    best, best_m = page, m
            if best is not None:
                match.cow_src, match.cow_tokens = best, best_m
                # the engine copies every COW match it attaches, so the
                # match count IS the copy count
                self.stats["cow_copies"] += 1
        reused = len(match.pages) * ps + match.cow_tokens
        if reused:
            self.stats["hits"] += 1
            self.stats["pages_reused"] += len(match.pages)
            self.stats["tokens_reused"] += reused
        return match

    def resident_prefix(self, tokens: List[int]) -> List[int]:
        """Page ids of the leading FULL pages of ``tokens`` resident in
        this cache, in chain order.  Unlike :meth:`lookup` there is no
        ``len - 1`` cap and no COW leg.  Pure read."""
        ps = self.page_size
        pages, key, pos = [], self._root, 0
        while pos + ps <= len(tokens):
            nxt = self._chain_key(key, tokens[pos:pos + ps])
            page = self.index.get(nxt)
            if page is None:
                break
            pages.append(page)
            key, pos = nxt, pos + ps
        return pages

    # -- insert ----------------------------------------------------------
    def insert(self, tokens: List[int], pages: List[int]) -> int:
        """Index every FULL page of ``(tokens, pages)`` not yet cached
        (pages past the last full boundary hold padding and are skipped).
        Chain keys are recomputed from the root, so partially shared
        sequences deduplicate onto the pages already indexed.  Respects
        ``max_cached_pages`` by evicting LRU reclaimable pages, and stops
        when nothing is evictable.  Returns the pages newly indexed."""
        ps = self.page_size
        if len(tokens) < max(self.min_prefix_tokens, ps):
            return 0
        added, key = 0, self._root
        for j in range(min(len(pages), len(tokens) // ps)):
            page_tokens = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            nxt = self._chain_key(key, page_tokens)
            page = pages[j]
            if nxt in self.index:
                # prefix already cached (possibly on another physical page
                # this request didn't attach): keep the incumbent
                key = nxt
                continue
            if page == 0 or page in self.key_of:
                # never index the scratch page; a page already indexed
                # under another chain can't serve two keys
                key = nxt
                continue
            if self.max_cached_pages and \
                    len(self.key_of) >= self.max_cached_pages:
                if self.alloc.reclaim_to_free() is None:
                    break   # everything cached is live; skip the rest
            self.index[nxt] = page
            self.key_of[page] = nxt
            self.tokens_of[page] = page_tokens
            self.parent_of[page] = key
            self.children.setdefault(key, set()).add(page)
            self.alloc.mark_cached(page)
            self.stats["inserts"] += 1
            added += 1
            key = nxt
        return added

    # -- eviction --------------------------------------------------------
    def _on_evict(self, page: int):
        """The allocator surrendered a reclaimable page: drop its index
        entries so no later lookup can hand out the recycled id."""
        key = self.key_of.pop(page, None)
        if key is None:
            return
        self.index.pop(key, None)
        self.tokens_of.pop(page, None)
        parent = self.parent_of.pop(page, None)
        if parent is not None:
            kids = self.children.get(parent)
            if kids is not None:
                kids.discard(page)
                if not kids:
                    del self.children[parent]
        self.stats["evictions"] += 1
        if self._on_evict_cb is not None:
            self._on_evict_cb(page)

    # -- introspection ---------------------------------------------------
    @property
    def cached_page_count(self) -> int:
        return len(self.key_of)

    @property
    def hit_rate(self) -> float:
        """Fraction of prefill pages served from cache across all lookups
        (full shared pages over the pages the prompts spanned)."""
        needed = self.stats["pages_needed"]
        return (self.stats["pages_reused"] / needed) if needed else 0.0

    def audit(self) -> dict:
        """Index/allocator consistency; {} when clean."""
        problems = {}
        if set(self.index.values()) != set(self.key_of):
            problems["index_mismatch"] = True
        not_marked = set(self.key_of) - self.alloc.cached
        if not_marked:
            problems["unmarked_cached_pages"] = sorted(not_marked)
        stray = self.alloc.cached - set(self.key_of)
        if stray:
            problems["stale_allocator_marks"] = sorted(stray)
        if self.max_cached_pages and \
                len(self.key_of) > self.max_cached_pages:
            problems["over_capacity"] = len(self.key_of)
        return problems

    def snapshot(self) -> dict:
        return {"cached_pages": self.cached_page_count,
                "hit_rate": round(self.hit_rate, 4), **self.stats}
