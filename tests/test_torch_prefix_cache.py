"""Port parity: the serving prefix cache.

The workloads of ``tests/unit/test_prefix_cache.py`` run through the JAX
engine and the port's, fp32 on the CPU, from the same JAX-initialised
weights (converted through numpy): tokens must be IDENTICAL, the two
caches must hold the same chain keys on the same page ids, and their
hit / insert / eviction counts must agree.  Copy-on-write must leave a
shared source page untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.prefix_cache import PrefixCache as JaxCache
from deepspeed_tpu.inference.serving import ServingEngine as JaxServing
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.ops.paged_attention import PagedAllocator as JaxAlloc
from deepspeed_tpu.runtime.resilience import FaultInjector
from deepspeed_tpu_torch.inference.prefix_cache import (PrefixCache,
                                                        PrefixCacheConfig)
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
from torch_threads import _one_torch_thread  # noqa: F401

KW = dict(hidden_size=64, n_heads=4, n_kv_heads=2)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxLM(JaxConfig.tiny(**KW))
    params = jmodel.init(jax.random.key(0))
    cfg = TransformerConfig.tiny(**KW)
    tmodel = CausalTransformerLM(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return cfg, jmodel, params, tmodel


def _engines(tiny, enabled=True, pc=None, injectors=(None, None), **kw):
    """(JAX engine, port engine) over the same weights and config."""
    cfg, jmodel, params, tmodel = tiny
    serving = dict(kw.pop("serving", {}))
    serving["prefix_cache"] = dict({"enabled": enabled}, **(pc or {}))
    kw.setdefault("max_batch", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seq", 64)
    jeng = JaxServing(jmodel, params, dtype=jnp.float32,
                      serving=dict(serving, attention_backend="jnp"),
                      injector=injectors[0], **kw)
    teng = ServingEngine(tmodel, dtype=torch.float32, serving=serving,
                         injector=injectors[1], **kw)
    return jeng, teng


def _shared_prefix_prompts(cfg, seed=0, shared_len=20,
                           suffixes=(5, 9, 3, 7)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, (shared_len,)).tolist()
    ps = [shared + rng.integers(0, cfg.vocab_size, (n,)).tolist()
          for n in suffixes]
    ps.append(list(ps[0]))          # exact repeat: pure full-page reuse
    return ps


def _assert_same_cache(jeng, teng):
    """The same chain keys on the same page ids, the same tokens per page
    and the same counters, in the cache and in the engine."""
    jc, tc = jeng.prefix_cache, teng.prefix_cache
    assert tc.namespace == jc.namespace
    assert tc.index == jc.index
    assert tc.tokens_of == jc.tokens_of
    assert tc.stats == jc.stats
    for k in ("prefix_hits", "prefix_cow_copies", "prefix_evictions"):
        assert teng.stats[k] == jeng.stats[k], k
    assert sorted(teng.alloc.reclaimable) == sorted(jeng.alloc.reclaimable)
    assert teng.alloc.cached == jeng.alloc.cached


def test_config_validation():
    assert PrefixCacheConfig({}).enabled is False
    with pytest.raises(ValueError):
        PrefixCacheConfig({"max_cached_pages": -1})
    with pytest.raises(ValueError):
        PrefixCacheConfig({"min_prefix_tokens": -2})


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, jnp.float16)])
def test_namespace_is_the_jax_engines(tiny, dtype, jdtype):
    """Same model shape, dtype and page size: the same namespace string,
    so both engines seed their chains with the same root."""
    cfg, jmodel, params, tmodel = tiny
    serving = {"prefix_cache": {"enabled": True}}
    jeng = JaxServing(jmodel, params, max_batch=1, page_size=8, max_seq=32,
                      dtype=jdtype, serving=serving)
    teng = ServingEngine(tmodel, max_batch=1, page_size=8, max_seq=32,
                         dtype=dtype, serving=serving)
    assert teng.prefix_cache.namespace == jeng.prefix_cache.namespace
    assert teng.prefix_cache._root == jeng.prefix_cache._root


@pytest.mark.parametrize("page_size,prompts,inserts", [
    (4, [[1, 2, 3, 4, 5, 6, 7, 8, 9]], [[1, 2, 3, 4, 5, 6, 7, 8]]),
    (4, [[1, 2, 3, 4, 5, 6, 9, 9, 9], [1, 2, 3, 4, 5]],
     [[1, 2, 3, 4, 5, 6, 7, 8]]),
    (8, [list(range(20)), list(range(10)) + [0] * 10, [7] * 3],
     [list(range(16)), list(range(8)) + [0] * 8]),
])
def test_lookup_insert_match_jax(page_size, prompts, inserts):
    """Chain keys, full-page matches, the COW leg and insert counts of
    the port's cache equal the JAX cache's over the same allocator
    sequence."""
    caches = []
    for alloc_cls, cache_cls in ((JaxAlloc, JaxCache),
                                 (PagedAllocator, PrefixCache)):
        alloc = alloc_cls(32, page_size, 8, reserve_scratch=True)
        cache = cache_cls(alloc, page_size, namespace="ns")
        added = []
        for i, toks in enumerate(inserts):
            pages = alloc.allocate(("ins", i), len(toks))
            added.append(cache.insert(toks, pages))
            alloc.free_sequence(("ins", i))
        matches = [cache.lookup(p) for p in prompts]
        caches.append((cache, added, [(m.pages, m.cow_src, m.cow_tokens)
                                      for m in matches]))
    (jc, j_added, j_match), (tc, t_added, t_match) = caches
    assert t_added == j_added and t_match == j_match
    assert tc.index == jc.index and tc.stats == jc.stats
    assert tc._chain_key(tc._root, [5, 6]) == jc._chain_key(jc._root, [5, 6])
    assert tc.resident_prefix(inserts[0]) == jc.resident_prefix(inserts[0])


def test_shared_prefix_batch_identical_to_jax_and_hits(tiny):
    cfg = tiny[0]
    prompts = _shared_prefix_prompts(cfg)
    jeng, teng = _engines(tiny, pc={"min_prefix_tokens": 8})
    want = jeng.generate(prompts, max_new_tokens=5)
    got = teng.generate(prompts, max_new_tokens=5)
    assert got == want
    _, off = _engines(tiny, enabled=False)
    assert off.generate(prompts, max_new_tokens=5) == got
    snap = teng.prefix_cache.snapshot()
    assert snap["hits"] >= len(prompts) - 1     # all but the cold first
    assert snap["tokens_reused"] > 0
    assert teng.stats["prefix_hits"] == snap["hits"]
    _assert_same_cache(jeng, teng)
    assert teng.leak_report() == {} and jeng.leak_report() == {}


def test_sampled_outputs_identical_to_jax(tiny):
    cfg = tiny[0]
    prompts = _shared_prefix_prompts(cfg, seed=3)
    jeng, teng = _engines(tiny)
    kw = dict(max_new_tokens=5, temperature=0.8, top_k=12, top_p=0.9)
    assert teng.generate(prompts, **kw) == jeng.generate(prompts, **kw)
    assert teng.prefix_cache.stats["hits"] > 0
    _assert_same_cache(jeng, teng)


def test_cow_isolation_source_page_untouched(tiny):
    cfg = tiny[0]
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, (18,)).tolist()
    a = base + rng.integers(0, cfg.vocab_size, (4,)).tolist()
    b = base + rng.integers(0, cfg.vocab_size, (6,)).tolist()  # diverges@18
    jeng, teng = _engines(tiny, max_batch=1)
    out_a = teng.generate([a], max_new_tokens=4)[0]
    assert out_a == jeng.generate([a], max_new_tokens=4)[0]
    cached = sorted(teng.prefix_cache.key_of)
    before = {p: (teng.caches.k_pages[:, p].clone(),
                  teng.caches.v_pages[:, p].clone()) for p in cached}
    assert teng.generate([b], max_new_tokens=4) == \
        jeng.generate([b], max_new_tokens=4)
    assert teng.stats["prefix_cow_copies"] >= 1
    for p in cached:
        assert torch.equal(teng.caches.k_pages[:, p], before[p][0])
        assert torch.equal(teng.caches.v_pages[:, p], before[p][1])
    # ...and the original prompt still replays identically
    assert teng.generate([list(a)], max_new_tokens=4)[0] == out_a
    jeng.generate([list(a)], max_new_tokens=4)
    _assert_same_cache(jeng, teng)
    assert teng.leak_report() == {}


def test_drain_leaves_zero_refcounts(tiny):
    cfg = tiny[0]
    prompts = _shared_prefix_prompts(cfg, seed=7)
    jeng, teng = _engines(tiny)
    res = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=6)
        eng.step()
        eng.step()                              # leave work in flight
        res[name] = eng.drain()
        assert eng.n_active == 0 and eng.alloc.seq_pages == {}
        assert eng.leak_report() == {}
        assert eng.alloc.available_page_count == eng.alloc.num_pages - 1
    # cached pages survived the drain in the reclaimable tier
    assert res["port"]["health"]["prefix_cache"]["cached_pages"] > 0
    assert res["port"]["finished"] == res["jax"]["finished"]
    assert res["port"]["shed"] == res["jax"]["shed"]
    assert res["port"]["steps"] == res["jax"]["steps"]
    _assert_same_cache(jeng, teng)


def test_lru_eviction_under_pool_pressure(tiny):
    cfg = tiny[0]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, (20,)).tolist()
               for _ in range(4)]               # distinct: no reuse
    jeng, teng = _engines(tiny, max_batch=1, max_seq=32, num_pages=9)
    for p in prompts:
        assert teng.generate([p], max_new_tokens=4) == \
            jeng.generate([p], max_new_tokens=4)
    assert teng.stats["prefix_evictions"] > 0   # pool forced reclaims
    _assert_same_cache(jeng, teng)
    assert teng.prefix_cache.audit() == {} and teng.alloc.audit() == {}
    assert teng.leak_report() == {}


def test_capacity_cap_evicts_like_jax(tiny):
    cfg = tiny[0]
    prompts = _shared_prefix_prompts(cfg, seed=21, shared_len=17)
    jeng, teng = _engines(tiny, pc={"max_cached_pages": 3})
    assert teng.generate(prompts, max_new_tokens=6) == \
        jeng.generate(prompts, max_new_tokens=6)
    assert teng.prefix_cache.cached_page_count <= 3
    _assert_same_cache(jeng, teng)
    assert teng.leak_report() == {}


def test_page_alloc_fault_mid_attach_recovers_identical(tiny):
    cfg = tiny[0]
    prompts = _shared_prefix_prompts(cfg, seed=11)
    _, off = _engines(tiny, enabled=False)
    expect = off.generate(prompts, max_new_tokens=5)
    # allocation call 0 is the cold first request; 1 and 2 fault while
    # attaching SHARED pages: no refcount may leak, the retry is identical
    spec = {"page_alloc": {"fail_at": [1, 2]}}
    jeng, teng = _engines(tiny, injectors=(FaultInjector(spec),
                                           FaultInjector(spec)))
    assert teng.generate(prompts, max_new_tokens=5) == expect
    assert jeng.generate(prompts, max_new_tokens=5) == expect
    assert teng.stats["step_faults"] == jeng.stats["step_faults"] >= 2
    assert teng.prefix_cache.stats["hits"] > 0
    _assert_same_cache(jeng, teng)
    teng.drain()
    assert teng.leak_report() == {} and teng.alloc.audit() == {}


def test_admission_counts_reclaimable_as_available(tiny):
    cfg = tiny[0]
    rng = np.random.default_rng(15)
    warm = rng.integers(0, cfg.vocab_size, (40,)).tolist()
    _, eng = _engines(tiny, max_batch=1,
                      serving={"free_page_low_watermark": 4,
                               "overload_policy": "reject"})
    eng.generate([warm], max_new_tokens=8)
    # the warm cache parked pages reclaimable: the FREE list is below the
    # watermark, but admission must not read that as page pressure
    assert eng.alloc.free_page_count <= 4
    assert eng.alloc.available_page_count > 4
    eng.add_request("next", warm[:10], max_new_tokens=4)   # must not raise
    while eng.queue or eng.n_active:
        eng.step()
    assert eng.leak_report() == {}


def test_disabled_cache_is_inert(tiny):
    cfg = tiny[0]
    jeng, teng = _engines(tiny, enabled=False)
    assert teng.prefix_cache is None
    p = _shared_prefix_prompts(cfg, seed=17)[0]
    assert teng.generate([p], max_new_tokens=4) == \
        jeng.generate([p], max_new_tokens=4)
    assert teng.alloc.reclaimable == {} and teng.alloc.cached == set()
    assert "prefix_cache" not in teng.health()
    assert teng.leak_report() == {}


def test_prefix_cache_with_chunked_and_decode_chunk(tiny):
    """The cache under the chunked scheduler (suffix chunks start after
    the cached pages) and under decode_chunk 4: tokens and cache state
    equal the JAX engine's."""
    cfg = tiny[0]
    prompts = _shared_prefix_prompts(cfg, seed=23, shared_len=19)
    for kw in (dict(serving={"scheduler": {"policy": "chunked",
                                           "prefill_chunk_tokens": 4}}),
               dict(decode_chunk=4)):
        jeng, teng = _engines(tiny, **kw)
        assert teng.generate(prompts, max_new_tokens=6) == \
            jeng.generate(prompts, max_new_tokens=6)
        assert teng.prefix_cache.stats["hits"] > 0
        _assert_same_cache(jeng, teng)
        assert teng.leak_report() == {}
