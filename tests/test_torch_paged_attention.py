"""Port parity: paged KV cache, ragged paged attention and the allocator.

The port's plain versions (which CPU tensors take) of the packed and the
rectangular front-ends against the JAX package's ragged Pallas kernel in
interpret mode and its jnp gather oracle, through real ``PagedAllocator``
block tables -- the cases of ``tests/unit/test_ragged_paged_attention.py``
plus shared prefix pages.  fp32; the paths differ only in summation
order, hence rtol=atol=2e-5.  The allocator must produce the same tables
from the same call sequence in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.paged_attention import PagedAllocator as JaxAllocator
from deepspeed_tpu.ops.paged_attention import PagedKVCache as JaxPagedKVCache
from deepspeed_tpu.ops.paged_attention import init_paged_cache as jax_init
from deepspeed_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from deepspeed_tpu.ops.paged_attention import prefill_paged as jax_prefill
from deepspeed_tpu.ops.pallas.ragged_paged_attention import (
    _pack_metadata as jax_pack_metadata)
from deepspeed_tpu.ops.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged)
from deepspeed_tpu.ops.pallas.ragged_paged_attention import (
    ragged_paged_attention_rect as jax_ragged_rect)
from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
    _pack_metadata, ragged_paged_attention, ragged_paged_attention_rect)
from deepspeed_tpu_torch.ops.paged_attention import (PageAllocationError,
                                                     PagedAllocator,
                                                     PagedKVCache,
                                                     init_paged_cache,
                                                     paged_decode_attention,
                                                     prefill_paged,
                                                     resolve_attention_backend)

H, HKV, D, PAGE = 4, 2, 8, 4
NPAGES = 64
TOL = dict(rtol=2e-5, atol=2e-5)


def _build_state(ctx_lens, shared_pages=0, seed=0):
    """Pools + allocator-made block tables, as numpy (shared by both)."""
    rng = np.random.default_rng(seed)
    alloc = PagedAllocator(NPAGES, PAGE, max_pages_per_seq=8,
                           reserve_scratch=True)
    shared = []
    if shared_pages:
        shared = alloc.allocate("__prefix__",
                                shared_pages * PAGE)[:shared_pages]
    for s, c in enumerate(ctx_lens):
        n_shared = min(shared_pages, max(0, (c - 1) // PAGE))
        alloc.allocate(s, c, shared=shared[:n_shared])
    tables = alloc.block_table(list(range(len(ctx_lens))))
    kp = rng.standard_normal((NPAGES, HKV, PAGE, D)).astype(np.float32)
    vp = rng.standard_normal((NPAGES, HKV, PAGE, D)).astype(np.float32)
    return alloc, tables, kp, vp


def _jnp_oracle(q, q_lens, ctx_lens, kp, vp, tables):
    """The JAX test's oracle: one rectangular jnp gather call per seq."""
    cache = JaxPagedKVCache(jnp.asarray(kp), jnp.asarray(vp))
    outs, off = [], 0
    for s, (ql, c) in enumerate(zip(q_lens, ctx_lens)):
        o = jax_paged(jnp.asarray(q[off:off + ql])[None], cache,
                      jnp.asarray(tables[s:s + 1]),
                      jnp.asarray([c], jnp.int32), impl="jnp")
        outs.append(np.asarray(o[0]))
        off += ql
    return np.concatenate(outs, axis=0)


CASES = [
    ("decode_only", [1, 1, 1], [9, 4, 16]),
    ("prefill_only", [9, 5], [9, 5]),
    ("mixed", [6, 1, 3, 1], [6, 13, 7, 16]),
    ("length_one", [1], [1]),
    ("page_boundary", [4, 1], [8, 8]),
    ("partial_last_page", [5, 1], [5, 10]),
]


@pytest.mark.parametrize("name,q_lens,ctx_lens", CASES,
                         ids=[c[0] for c in CASES])
def test_packed_matches_pallas_and_oracle(name, q_lens, ctx_lens):
    _, tables, kp, vp = _build_state(ctx_lens)
    q = np.random.default_rng(1).standard_normal(
        (sum(q_lens), H, D)).astype(np.float32)
    got = ragged_paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(tables), ctx_lens,
                                 q_lens).numpy()
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    np.testing.assert_allclose(
        got, _jnp_oracle(q, q_lens, ctx_lens, kp, vp, tables), **TOL)


def test_shared_prefix_pages_read_in_place():
    q_lens, ctx_lens = [5, 1, 1], [13, 11, 9]
    alloc, tables, kp, vp = _build_state(ctx_lens, shared_pages=2)
    assert tables[0, 0] == tables[1, 0] and tables[0, 1] == tables[1, 1]
    assert alloc.audit() == {}
    q = np.random.default_rng(2).standard_normal(
        (sum(q_lens), H, D)).astype(np.float32)
    got = ragged_paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(tables), ctx_lens,
                                 q_lens).numpy()
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("T", [1, 5, 8, 12])
def test_rect_front_end(T):
    """Decode (T=1), in-tile prefill, exact tile, and T > q_tile."""
    ctx = [T + 3, T, T + 9]
    _, tables, kp, vp = _build_state(ctx)
    q = np.random.default_rng(3).standard_normal(
        (3, T, H, D)).astype(np.float32)
    lengths = np.asarray(ctx, np.int32)
    got = ragged_paged_attention_rect(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lengths)).numpy()
    kern = jax_ragged_rect(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(tables), jnp.asarray(lengths),
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    want = jax_paged(jnp.asarray(q), JaxPagedKVCache(jnp.asarray(kp),
                                                     jnp.asarray(vp)),
                     jnp.asarray(tables), jnp.asarray(lengths), impl="jnp")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("q_lens,q_tile", [([37, 1, 9, 1], 8), ([3], 8),
                                           ([8, 16, 1], 4)])
def test_pack_metadata_matches_jax(q_lens, q_tile):
    for a, b in zip(_pack_metadata(q_lens, q_tile),
                    jax_pack_metadata(q_lens, q_tile)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("T", [1, 6])
def test_prefill_paged_matches_jax(T):
    """Writes through the block table land on the same (page, offset)
    slots; inactive rows (table row 0, length 0) hit the scratch page."""
    ctx = [3, 0]
    alloc = PagedAllocator(16, PAGE, max_pages_per_seq=4,
                           reserve_scratch=True)
    alloc.allocate("a", 12)
    tables = np.zeros((2, 5), np.int32)
    tables[0, :3] = alloc.seq_pages["a"]
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((2, T, HKV, D)).astype(np.float32)
    v[1] = k[1] = 1.0   # inactive row: one value, so scatter order is moot
    lengths = np.asarray(ctx, np.int32)
    jc, jl = jax_prefill(jax_init(16, PAGE, HKV, D, jnp.float32),
                         jnp.asarray(tables), jnp.asarray(lengths),
                         jnp.asarray(k), jnp.asarray(v))
    tc = init_paged_cache(16, PAGE, HKV, D, torch.float32, device="cpu")
    tc2, tl = prefill_paged(tc, torch.from_numpy(tables),
                            torch.from_numpy(lengths), torch.from_numpy(k),
                            torch.from_numpy(v))
    assert tc2.k_pages is tc.k_pages            # in place
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))


def _drive_allocator(alloc_cls):
    """One fixed allocate / extend / shrink / free / fault sequence;
    returns every observable after each step."""
    a = alloc_cls(12, 4, max_pages_per_seq=5, reserve_scratch=True)
    trace = []

    def snap():
        ids = sorted(a.seq_pages, key=str)
        trace.append((ids, a.block_table(ids).tolist(), list(a.free),
                      dict(a.ref), a.audit()))

    a.allocate("x", 9)
    snap()
    a.allocate("y", 3)
    snap()
    a.extend("y", 10)
    snap()
    a.shrink("x", 4)
    snap()
    a.allocate("z", 17, shared=a.seq_pages["y"][:2])   # refcounted share
    snap()
    a.free_sequence("y")
    snap()
    a.extend("x", 13)
    snap()
    for bad in (lambda: a.allocate("w", 21),          # over the per-seq cap
                lambda: a.allocate("w", 20)):         # out of pages
        try:
            bad()
        except Exception as e:
            trace.append(type(e).__name__)
    snap()
    a.free_sequence("z")
    a.free_sequence("x")
    snap()
    return trace


def test_allocator_same_tables_as_jax():
    ours, theirs = (_drive_allocator(PagedAllocator),
                    _drive_allocator(JaxAllocator))
    assert ours == theirs
    assert ours[-1][4] == {} and "PageAllocationError" in ours


def test_allocator_audit_flags_refcount_drift():
    a = PagedAllocator(8, 4, max_pages_per_seq=4, reserve_scratch=True)
    a.allocate("x", 8)
    assert a.audit() == {}
    a.ref[a.seq_pages["x"][0]] += 1
    assert "refcounts" in a.audit()
    with pytest.raises(PageAllocationError):
        a.allocate("y", 100)


def test_backend_strings():
    assert resolve_attention_backend(None) == "auto"
    for name in ("auto", "cuda", "plain"):
        assert resolve_attention_backend(name) == name
    for jax_name in ("jnp", "pallas", "pallas-interpret"):
        with pytest.raises(ValueError, match="JAX"):
            resolve_attention_backend(jax_name)


def test_cuda_backend_refuses_cpu_tensors():
    _, tables, kp, vp = _build_state([5])
    q = torch.zeros(1, 1, H, D)
    cache = PagedKVCache(torch.from_numpy(kp), torch.from_numpy(vp))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q, cache, torch.from_numpy(tables),
                               torch.tensor([5], dtype=torch.int32),
                               backend="cuda")
