"""Port parity: paged KV cache, ragged paged attention and the allocator.

The port's plain versions (which CPU tensors take) of the packed and the
rectangular front-ends against the JAX package's ragged Pallas kernel in
interpret mode and its jnp gather oracle, through real ``PagedAllocator``
block tables -- the cases of ``tests/unit/test_ragged_paged_attention.py``
plus shared prefix pages.  fp32; the paths differ only in summation
order, hence rtol=atol=2e-5.  The allocator must produce the same tables
from the same call sequence in both packages.
"""

import math

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
from deepspeed_tpu_torch.ops.cuda.decode_attention import (DECODE_ROWS,
                                                           HEAD_DIMS,
                                                           decode_splits,
                                                           key_splits)
from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
    DEFAULT_Q_TILE, TC_ROWS, _pack_metadata, decode_rows_splits, plan_launch,
    ragged_paged_attention, ragged_paged_attention_rect, tensor_core_prefill)
from deepspeed_tpu_torch.ops.paged_attention import (PageAllocationError,
                                                     PagedAllocator,
                                                     PagedKVCache,
                                                     init_paged_cache,
                                                     paged_decode_attention,
                                                     prefill_paged,
                                                     resolve_attention_backend)
from torch_threads import _one_torch_thread  # noqa: F401

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


# ---- the CUDA wrapper's launch plan (host side, no card needed) ----------

PLAN_CASES = [  # (q_lens, group)
    ([37, 1, 9, 1], 1), ([1] * 8, 1), ([1024], 1), ([16], 1),
    ([16], 4), ([37, 1, 1, 128, 9, 1], 4), ([3, 1, 4, 2, 200], 1),
    ([2, 1, 1, 130], 2), ([5, 4], 1),
    # 5-8 rows a kv head: the verify window [8, 5], a group-8 decode step,
    # 8 and 9 tokens at group 1, 2 and 3 tokens at group 4
    ([5] * 8, 1), ([1] * 8, 8), ([8, 9, 1], 1), ([2, 3, 1, 40], 4)]


def _rows_and_keys(q_lens, ctx_lens, tiles, tokens, decode_seqs=()):
    """{(sequence, token): (first key not loaded)} of a tiling: a prefill
    tile (s, qt) loads keys below its causal frontier ctx - qlen +
    min(qlen, (qt + 1) * tokens), a decode sequence all of its keys.
    Fails on a row covered twice."""
    out = {}
    for s in decode_seqs:
        for t in range(q_lens[s]):
            assert (s, t) not in out
            out[s, t] = ctx_lens[s]
    for s, qt in tiles:
        ql, c = q_lens[s], ctx_lens[s]
        for t in range(qt * tokens, min(ql, (qt + 1) * tokens)):
            assert (s, t) not in out
            out[s, t] = c - ql + min(ql, (qt + 1) * tokens)
    return out


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("q_lens,group", PLAN_CASES)
def test_launch_plan_covers_the_jax_tiling(q_lens, group, tensor_cores):
    """The wrapper's tiles cover exactly the rows _pack_metadata and the
    JAX tiling give, each once; every row's tile loads all the keys the
    row sees (key <= its position) and none past the sequence; decode
    rows go whole to the decode form, at most DECODE_ROWS a kv head."""
    ctx = [ql + 7 * s for s, ql in enumerate(q_lens)]
    plan = plan_launch(q_lens, group, tensor_cores)
    got = _rows_and_keys(q_lens, ctx, zip(plan.seq_of_tile,
                                          plan.qtile_of_tile),
                         plan.q_tile, plan.decode_seqs)
    _, jsot, jqot, _ = jax_pack_metadata(q_lens, DEFAULT_Q_TILE)
    want = _rows_and_keys(q_lens, ctx, zip(jsot, jqot), DEFAULT_Q_TILE)
    assert set(got) == set(want)
    for (s, t), hi in got.items():
        qpos = ctx[s] - q_lens[s] + t
        assert qpos + 1 <= hi <= ctx[s]
    dec = set(plan.decode_seqs.tolist())
    assert dec == {s for s, ql in enumerate(q_lens)
                   if ql * group <= DECODE_ROWS}
    assert plan.decode_rows == max((q_lens[s] * group for s in dec),
                                   default=0)
    if tensor_cores:
        assert plan.q_tile * group == TC_ROWS
        qt = plan.qtile_of_tile.tolist()
        assert qt == sorted(qt, reverse=True)      # most keys first


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_decode_rows_split_like_b5(Dh, dtype):
    """B4's decode rows split their keys by B5's rule on the body the two
    share, at every head dim -- at 256 the staged body's 64-key chunks
    and up for 5-8 rows in bf16 / fp16: the serve run's 8 slots over a
    table of 17 pages of 128 (Gemma-2B: 8 rows over one kv head; Gemma-7B
    16 / 16 at 1-8 rows) on one wave of 132 or 264 slots."""
    S_max = 17 * 128
    for rows in range(1, DECODE_ROWS + 1):
        for Hkv in (1, 4, 16):
            for slots in (132, 264):
                got = decode_rows_splits(8, Hkv, S_max, slots, rows, dtype,
                                         Dh)
                assert got == decode_splits(8, 1, rows * Hkv, Hkv, S_max,
                                            slots, dtype, Dh)
                n, c = got
                assert n * c >= S_max > (n - 1) * c
    if Dh == 256 and dtype != torch.float32:
        assert decode_rows_splits(8, 1, S_max, 132, 8, dtype, 256) == \
            (12, 192)


@pytest.mark.parametrize("pairs,slots", [(8 * 32, 528), (8 * 8, 528),
                                         (1, 132), (256, 132), (8 * 4, 264)])
def test_decode_key_chunks_cover_each_key_once(pairs, slots):
    """The decode form's key chunks (key_splits over S_max = max_pages *
    page) cover [0, ctx) of every sequence exactly once, in chunks the
    kernel's active-chunk rule visits."""
    S_max = 17 * 128
    n, chunk = key_splits(pairs, S_max, slots)
    assert n * chunk >= S_max and pairs * n <= max(slots, pairs)
    for c in (0, 1, 127, 128, 129, 600, chunk, chunk + 1, S_max):
        c = min(c, S_max)            # the kernel clamps to the table
        active = max(1, -(-c // chunk))
        assert active <= n
        keys = [k for i in range(active)
                for k in range(i * chunk, min((i + 1) * chunk, c))]
        assert keys == list(range(c))


@pytest.mark.parametrize("dtype,D,group,page,want", [
    (torch.bfloat16, 128, 1, 128, True), (torch.bfloat16, 128, 4, 256, True),
    (torch.bfloat16, 128, 4, 64, True), (torch.bfloat16, 128, 1, 8, True),
    (torch.bfloat16, 128, 1, 48, False), (torch.bfloat16, 128, 1, 4, False),
    (torch.bfloat16, 128, 3, 128, False), (torch.float32, 128, 1, 128, False),
    (torch.bfloat16, 64, 1, 128, True), (torch.float16, 128, 1, 128, True),
    (torch.float16, 128, 8, 128, True), (torch.float16, 128, 1, 48, False),
    (torch.float16, 64, 8, 128, True),
    # head dim 64 (a row is one 128-byte swizzle row): the same pages and
    # groups as 128; fp32 and other head dims keep the CUDA-core tiles
    (torch.bfloat16, 64, 8, 8, True), (torch.float16, 64, 4, 16, True),
    (torch.bfloat16, 64, 1, 48, False), (torch.bfloat16, 64, 3, 128, False),
    (torch.float32, 64, 8, 128, False),
    # head dims 80 and 96 (two 64-column boxes, zero-filled past D): the
    # same pages and groups; fp32 and head dims no form takes do not
    (torch.bfloat16, 80, 1, 128, True), (torch.float16, 80, 4, 16, True),
    (torch.bfloat16, 96, 1, 128, True), (torch.float16, 96, 8, 128, True),
    (torch.bfloat16, 80, 1, 48, False), (torch.bfloat16, 96, 3, 128, False),
    (torch.float32, 96, 1, 128, False), (torch.bfloat16, 256, 1, 128, True),
    # head dim 256 (64-key K/V tiles): groups 1 and 8 (Gemma-7B's and
    # Gemma-2B's), pages 16 and 128, bf16 and fp16; a page of 192 tiles
    # the 64-key tile; fp32, a group not dividing 64, a page of 48 and a
    # head dim no form takes do not
    (torch.bfloat16, 256, 8, 128, True), (torch.float16, 256, 1, 16, True),
    (torch.float16, 256, 8, 16, True), (torch.bfloat16, 256, 1, 192, True),
    (torch.float32, 256, 8, 128, False), (torch.bfloat16, 256, 3, 128, False),
    (torch.bfloat16, 256, 1, 48, False), (torch.bfloat16, 48, 1, 128, False),
    # head dim 16 (the benches' tiny model): the CUDA-core tiles at every
    # dtype, group and page, the serving engine's page 128 and 16 among
    # them
    (torch.bfloat16, 16, 1, 128, False), (torch.float16, 16, 1, 16, False),
    (torch.bfloat16, 16, 4, 128, False), (torch.float32, 16, 1, 128, False)])
def test_tensor_core_prefill_selection(dtype, D, group, page, want):
    """The prefill tiles take the tensor-core kernel for bf16 and fp16 at
    head dims 64, 80, 96, 128 and 256, a group dividing 64 and pages that
    tile or divide the K/V tile (128 keys; 64 at head dim 256) in whole
    swizzle atoms; anything else -- head dim 16 always -- takes the
    CUDA-core one."""
    assert tensor_core_prefill(dtype, D, group, page) is want


@pytest.mark.parametrize("q_lens,group", [([1] * 8, 8), ([1, 1, 4], 1),
                                          ([256], 8), ([1, 37, 2], 4)])
def test_head_dim_64_plans_prefill_tiles_only(q_lens, group):
    """Head dim 64 (TinyLlama-1.1B as a draft) in bf16 and fp16 plans the
    tensor-core prefill tiles: its sequences of at most DECODE_ROWS rows a
    kv head (a group-8 decode step among them) take the decode form, every
    other one 128-row tiles of ``128 // group`` tokens, the tiles with the
    most keys first, that cover its rows once."""
    tc = [tensor_core_prefill(dt, 64, group, page)
          for dt in (torch.bfloat16, torch.float16) for page in (8, 128)]
    assert all(tc)
    plan = plan_launch(q_lens, group, True)
    assert plan.tensor_cores and plan.q_tile == TC_ROWS // group
    qt = plan.qtile_of_tile.tolist()
    assert qt == sorted(qt, reverse=True)
    dec = [s for s, ql in enumerate(q_lens) if ql * group <= DECODE_ROWS]
    assert plan.decode_seqs.tolist() == dec
    assert plan.decode_rows == max((q_lens[s] * group for s in dec),
                                   default=0)
    tiles = {}
    for s, t in zip(plan.seq_of_tile.tolist(), plan.qtile_of_tile.tolist()):
        tiles.setdefault(s, []).append(t)
    assert {s: sorted(t) for s, t in tiles.items()} == {
        s: list(range(-(-ql // plan.q_tile))) for s, ql in enumerate(q_lens)
        if s not in dec}


def _plan_emulated(q, kp, vp, tables, ctx, q_lens, plan, chunk):
    """The wrapper's plan executed as the kernels read it, in fp32 on the
    CPU: each decode sequence's keys in chunks merged by their (m, l),
    each prefill tile over the keys below its frontier, masked causally."""
    H, D = q.shape[1], q.shape[2]
    Hkv, page = kp.shape[1], kp.shape[2]
    group = H // Hkv
    offs = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    out = torch.zeros_like(q)

    def keys(s, lo, hi):
        k = torch.arange(lo, hi)
        pg = tables[s, (k // page).clamp(max=tables.shape[1] - 1)].long()
        return (kp[pg, :, k % page].repeat_interleave(group, 1),
                vp[pg, :, k % page].repeat_interleave(group, 1))

    def attend(s, toks, lo, hi):
        """(m, l, acc) of tokens ``toks`` of s over keys [lo, hi)."""
        qq = q[offs[s] + toks]                          # [n, H, D]
        k, v = keys(s, lo, hi)                          # [n_k, H, D]
        sc = torch.einsum("nhd,khd->hnk", qq, k) / math.sqrt(D)
        qpos = ctx[s] - q_lens[s] + toks
        sc = sc.masked_fill(torch.arange(lo, hi)[None, None] >
                            qpos[None, :, None], -1e30)
        m = sc.max(-1).values
        p = torch.exp(sc - m[..., None])
        return m, p.sum(-1), torch.einsum("hnk,khd->hnd", p, v)

    for s in plan.decode_seqs:
        toks = torch.arange(q_lens[s])
        parts = [attend(s, toks, i * chunk, min((i + 1) * chunk, ctx[s]))
                 for i in range(max(1, -(-ctx[s] // chunk)))]
        mm = torch.stack([m for m, _, _ in parts]).max(0).values
        ll = sum(l * torch.exp(m - mm) for m, l, _ in parts)
        aa = sum(a * torch.exp(m - mm)[..., None] for m, _, a in parts)
        out[offs[s] + toks] = (aa / ll[..., None]).transpose(0, 1)
    for s, qt in zip(plan.seq_of_tile, plan.qtile_of_tile):
        ql = q_lens[s]
        toks = torch.arange(qt * plan.q_tile, min(ql, (qt + 1) * plan.q_tile))
        hi = ctx[s] - ql + min(ql, (qt + 1) * plan.q_tile)
        _, l, a = attend(s, toks, 0, hi)
        out[offs[s] + toks] = (a / l[..., None]).transpose(0, 1)
    return out


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("name,q_lens,ctx_lens", CASES,
                         ids=[c[0] for c in CASES])
def test_launch_plan_computes_the_pallas_kernel(name, q_lens, ctx_lens,
                                                tensor_cores):
    """The plan, executed as the two forms read it (decode keys in chunks
    of 4 merged by their maxima; prefill tiles to their frontier), gives
    the JAX Pallas kernel's output."""
    _, tables, kp, vp = _build_state(ctx_lens, shared_pages=1)
    q = np.random.default_rng(5).standard_normal(
        (sum(q_lens), H, D)).astype(np.float32)
    plan = plan_launch(q_lens, H // HKV, tensor_cores)
    got = _plan_emulated(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         ctx_lens, q_lens, plan, chunk=4)
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


ROWS8_CASES = [  # (name, Hq, Hkv, q_lens, ctx_lens): head dim 64
    ("group8_decode", 8, 1, [1, 1, 1], [9, 30, 16]),
    ("group8_mixed", 8, 1, [6, 1, 3, 1], [6, 13, 7, 29]),
    ("verify_window", 4, 4, [5, 5, 5], [5, 21, 30]),
    ("rows_8_and_9", 4, 4, [8, 9, 1, 7], [8, 26, 13, 31]),
    ("group4_two_tokens", 8, 2, [2, 1, 3], [11, 30, 17]),
]


@pytest.mark.parametrize("name,Hq,Hkv,q_lens,ctx_lens", ROWS8_CASES,
                         ids=[c[0] for c in ROWS8_CASES])
def test_launch_plan_8_rows_head_dim_64(name, Hq, Hkv, q_lens, ctx_lens):
    """Decode rows of 5-8 a kv head at head dim 64 (group-8 decode steps,
    verify windows of 5 tokens, 8 tokens at group 1) beside prefills, the
    plan executed as the kernels read it -- decode keys in several chunks
    merged by their maxima -- against the JAX Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(6)
    alloc = PagedAllocator(NPAGES, PAGE, max_pages_per_seq=8,
                           reserve_scratch=True)
    for s, c in enumerate(ctx_lens):
        alloc.allocate(s, c)
    tables = alloc.block_table(list(range(len(ctx_lens))))
    kp = rng.standard_normal((NPAGES, Hkv, PAGE, 64)).astype(np.float32)
    vp = rng.standard_normal((NPAGES, Hkv, PAGE, 64)).astype(np.float32)
    q = rng.standard_normal((sum(q_lens), Hq, 64)).astype(np.float32)
    group = Hq // Hkv
    plan = plan_launch(q_lens, group, tensor_core_prefill(
        torch.bfloat16, 64, group, PAGE))
    assert plan.decode_rows == max(
        (ql * group for ql in q_lens if ql * group <= DECODE_ROWS), default=0)
    assert plan.decode_rows > 4 or name == "group4_two_tokens"
    got = _plan_emulated(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         ctx_lens, q_lens, plan, chunk=8)
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)
    rect = ragged_paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                  torch.from_numpy(vp),
                                  torch.from_numpy(tables), ctx_lens,
                                  q_lens).numpy()
    np.testing.assert_allclose(rect, np.asarray(kern), **TOL)


TC64_CASES = [  # (name, Hq, Hkv, page, q_lens, ctx_lens): head dim 64
    ("group1_page8_ragged_last_tile", 2, 2, 8, [200, 1, 9], [230, 40, 9]),
    ("group4_page128", 4, 1, 128, [37, 1, 70], [37, 300, 500]),
    ("group8_chunk_256_at_start_512", 8, 1, 128, [256], [768]),
    ("group8_page8_ragged_last_tile", 8, 1, 8, [19, 1, 3], [50, 33, 17]),
]


@pytest.mark.parametrize("name,Hq,Hkv,page,q_lens,ctx_lens", TC64_CASES,
                         ids=[c[0] for c in TC64_CASES])
def test_launch_plan_tensor_cores_head_dim_64(name, Hq, Hkv, page, q_lens,
                                              ctx_lens):
    """The tensor-core plan at head dim 64 -- prefill tiles of 128 // group
    tokens, most keys first, beside decode rows -- executed as the kernels
    read it, against the JAX Pallas kernel in interpret mode: groups 1, 4
    and 8, pages 8 and 128, a ragged last tile, a 256-token chunk after
    512 cached tokens."""
    group = Hq // Hkv
    assert tensor_core_prefill(torch.bfloat16, 64, group, page)
    rng = np.random.default_rng(7)
    n_pages = sum(-(-c // page) for c in ctx_lens) + 2
    alloc = PagedAllocator(n_pages, page,
                           max(-(-c // page) for c in ctx_lens),
                           reserve_scratch=True)
    for s, c in enumerate(ctx_lens):
        alloc.allocate(s, c)
    tables = alloc.block_table(list(range(len(ctx_lens))))
    kp = rng.standard_normal((n_pages, Hkv, page, 64)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, page, 64)).astype(np.float32)
    q = rng.standard_normal((sum(q_lens), Hq, 64)).astype(np.float32)
    plan = plan_launch(q_lens, group, True)
    assert plan.q_tile == TC_ROWS // group and len(plan.seq_of_tile)
    assert any(ql % plan.q_tile for ql in q_lens if ql * group >
               DECODE_ROWS) or name.startswith("group8_chunk")
    got = _plan_emulated(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         ctx_lens, q_lens, plan, chunk=64)
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


def _state_dh(ctx_lens, page, Hkv, Dh, seed, shared_pages=0):
    """Pools of head dim Dh and allocator-made block tables (numpy), with
    ``shared_pages`` prefix pages shared by the sequences that reach past
    them."""
    rng = np.random.default_rng(seed)
    n_pages = sum(-(-c // page) for c in ctx_lens) + shared_pages + 2
    alloc = PagedAllocator(n_pages, page,
                           max(-(-c // page) for c in ctx_lens),
                           reserve_scratch=True)
    shared = []
    if shared_pages:
        shared = alloc.allocate("__prefix__",
                                shared_pages * page)[:shared_pages]
    for s, c in enumerate(ctx_lens):
        alloc.allocate(s, c, shared=shared[:min(shared_pages,
                                                max(0, (c - 1) // page))])
    assert alloc.audit() == {}
    tables = alloc.block_table(list(range(len(ctx_lens))))
    kp = rng.standard_normal((n_pages, Hkv, page, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, Hkv, page, Dh)).astype(np.float32)
    return tables, kp, vp


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("Dh", [80, 96])
def test_head_dims_80_96_match_pallas_and_oracle(Dh, Hkv, T):
    """Head dims 80 (GPT-3 2.7B's) and 96 (Phi-3-mini's), MHA and GQA, a
    decode step and 5 tokens over ragged contexts: the rectangular
    front-end (the plain version on the CPU) against the JAX package's
    rect Pallas kernel in interpret mode and its jnp gather path, then the
    packed front-end on a mixed batch sharing a prefix page against the
    ragged Pallas kernel."""
    ctx = [T + 3, T, T + 9]
    tables, kp, vp = _state_dh(ctx, PAGE, Hkv, Dh, seed=Dh)
    q = np.random.default_rng(Dh + T).standard_normal(
        (3, T, H, Dh)).astype(np.float32)
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
    q_lens, ctx_lens = [T, 1, 9, 1], [T + 6, 13, 9, 11]
    tables, kp, vp = _state_dh(ctx_lens, PAGE, Hkv, Dh, seed=Dh + 1,
                               shared_pages=1)
    qp = np.random.default_rng(Dh + 2).standard_normal(
        (sum(q_lens), H, Dh)).astype(np.float32)
    got = ragged_paged_attention(torch.from_numpy(qp), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(tables), ctx_lens,
                                 q_lens).numpy()
    kern = jax_ragged(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("T", [1, 2, 8])
@pytest.mark.parametrize("Hkv", [4, 1], ids=["mha", "group4"])
def test_head_dim_16_matches_pallas_and_oracle(Hkv, T):
    """Head dim 16 (the benches' ``tiny`` model: 4 heads of 16), MHA and
    group 4, decode rows of 1, 2 and 8 tokens (1-8 rows a kv head at MHA,
    4 at group 4; 8 tokens at group 4 are 32 rows, the prefill tiles) over
    ragged contexts: the rectangular front-end (the plain version on the
    CPU) against the JAX package's rect Pallas kernel in interpret mode and
    its jnp gather path, then the packed front-end on a mixed batch
    sharing a prefix page against the ragged Pallas kernel."""
    Dh = 16
    ctx = [T + 3, T, T + 9]
    tables, kp, vp = _state_dh(ctx, PAGE, Hkv, Dh, seed=Dh + T)
    q = np.random.default_rng(Dh + T).standard_normal(
        (3, T, H, Dh)).astype(np.float32)
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
    q_lens, ctx_lens = [T, 1, 9, 1], [T + 6, 13, 9, 11]
    tables, kp, vp = _state_dh(ctx_lens, PAGE, Hkv, Dh, seed=Dh + 1,
                               shared_pages=1)
    qp = np.random.default_rng(Dh + 2).standard_normal(
        (sum(q_lens), H, Dh)).astype(np.float32)
    got = ragged_paged_attention(torch.from_numpy(qp), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(tables), ctx_lens,
                                 q_lens).numpy()
    kern = jax_ragged(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("page", [16, 128])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 1)], ids=["mha", "group4"])
def test_head_dim_16_plans_the_cuda_core_forms(Hq, Hkv, page):
    """At head dim 16 no dtype takes the tensor-core prefill tiles, so the
    wrapper plans the CUDA-core ones (``q_tile``-token tiles, the JAX
    tiling) beside the decode rows, which split their keys by B5's rule
    (DECODE_MIN_CHUNK at every row count).  The plan, executed as the
    kernels read it, against the JAX Pallas kernel in interpret mode: the
    serving bench's bucketed prefills, a ragged last tile, decode rows."""
    group = Hq // Hkv
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert not tensor_core_prefill(dtype, 16, group, page)
        for rows in (1, 2, 4, 8):
            assert decode_rows_splits(1, Hkv, 2048, 528, rows, dtype, 16) \
                == (4, 512)
    q_lens, ctx_lens = [64, 1, 37, 2, 128], [64, 90, 37, 41, 128]
    tables, kp, vp = _state_dh(ctx_lens, page, Hkv, 16, seed=page + group)
    q = np.random.default_rng(page).standard_normal(
        (sum(q_lens), Hq, 16)).astype(np.float32)
    plan = plan_launch(q_lens, group, False)
    assert not plan.tensor_cores and plan.q_tile == DEFAULT_Q_TILE
    assert plan.decode_seqs.tolist() == [
        s for s, ql in enumerate(q_lens) if ql * group <= DECODE_ROWS]
    got = _plan_emulated(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         ctx_lens, q_lens, plan, chunk=64)
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


TC80_96_CASES = [  # (name, Dh, Hq, Hkv, page, q_lens, ctx_lens)
    ("d80_group1_page128_ragged_last_tile", 80, 2, 2, 128, [200, 1, 5],
     [230, 300, 9]),
    ("d80_group4_page16_chunk_256_at_start_512", 80, 4, 1, 16, [256, 1],
     [768, 40]),
    ("d96_group1_page16_ragged_last_tile", 96, 2, 2, 16, [200, 1, 9],
     [230, 40, 9]),
    ("d96_group8_page128_chunk_256_at_start_512", 96, 8, 1, 128, [256, 1],
     [768, 300]),
    # a causal frontier on a K/V tile's edge (start 256) and a key before
    # it (start 255), the prefill tiles on the shared consumer
    ("d80_group1_page128_frontier_on_a_tile_edge", 80, 2, 2, 128, [128, 1],
     [384, 300]),
    ("d96_group1_page16_frontier_a_key_before_a_tile_edge", 96, 2, 2, 16,
     [130, 5], [385, 40]),
]


@pytest.mark.parametrize("name,Dh,Hq,Hkv,page,q_lens,ctx_lens",
                         TC80_96_CASES, ids=[c[0] for c in TC80_96_CASES])
def test_launch_plan_tensor_cores_head_dims_80_96(name, Dh, Hq, Hkv, page,
                                                  q_lens, ctx_lens):
    """The tensor-core plan at head dims 80 and 96 -- which bf16 and fp16
    now select -- executed as the kernels read it (prefill tiles of 128 //
    group tokens, most keys first, to their frontier; decode rows in key
    chunks merged by their maxima), against the JAX Pallas kernel in
    interpret mode: groups 1, 4 and 8, pages 16 and 128, a ragged last
    tile, a 256-token chunk after 512 cached tokens."""
    group = Hq // Hkv
    assert tensor_core_prefill(torch.bfloat16, Dh, group, page)
    assert tensor_core_prefill(torch.float16, Dh, group, page)
    tables, kp, vp = _state_dh(ctx_lens, page, Hkv, Dh, seed=len(name))
    q = np.random.default_rng(Dh).standard_normal(
        (sum(q_lens), Hq, Dh)).astype(np.float32)
    plan = plan_launch(q_lens, group, True)
    assert plan.q_tile == TC_ROWS // group and len(plan.seq_of_tile)
    assert len(plan.decode_seqs) == sum(ql * group <= DECODE_ROWS
                                        for ql in q_lens)
    got = _plan_emulated(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         ctx_lens, q_lens, plan, chunk=64)
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


@pytest.mark.parametrize("Hkv", [1, 2])
def test_head_dim_256_matches_pallas_and_oracle(Hkv):
    """Head dim 256 (Gemma's), MQA (Hkv 1: the group of 4 query heads over
    one kv head, as Gemma-2B's 8 over 1) and GQA (Hkv 2): decode rows over
    ragged contexts through the rectangular front-end (the plain version
    on the CPU) against the JAX package's rect Pallas kernel in interpret
    mode and its jnp gather path; then the packed front-end on a batch of
    decode rows, a prefill, and a chunk after a cached prefix, sharing a
    prefix page, against the ragged Pallas kernel and the jnp oracle."""
    Dh = 256
    ctx = [4, 1, 10]
    tables, kp, vp = _state_dh(ctx, PAGE, Hkv, Dh, seed=Hkv)
    q = np.random.default_rng(Hkv + 1).standard_normal(
        (3, 1, H, Dh)).astype(np.float32)
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
    # decode, a 9-token prefill, a 5-token chunk after 9 cached tokens
    q_lens, ctx_lens = [1, 9, 5, 1], [13, 9, 14, 6]
    tables, kp, vp = _state_dh(ctx_lens, PAGE, Hkv, Dh, seed=Hkv + 2,
                               shared_pages=1)
    qp = np.random.default_rng(Hkv + 3).standard_normal(
        (sum(q_lens), H, Dh)).astype(np.float32)
    got = ragged_paged_attention(torch.from_numpy(qp), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(tables), ctx_lens,
                                 q_lens).numpy()
    kern = jax_ragged(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    np.testing.assert_allclose(
        got, _jnp_oracle(qp, q_lens, ctx_lens, kp, vp, tables), **TOL)


TC256_CASES = [  # (name, Hq, Hkv, page, q_lens, ctx_lens): head dim 256
    ("group1_page128_ragged_last_tile", 2, 2, 128, [150, 1, 5],
     [170, 200, 9]),
    ("group8_page16_chunk_at_start_128", 8, 1, 16, [64, 1], [192, 40]),
    # frontiers on a 64-key tile's edge and a key past it, group 4
    ("group4_page16_frontier_on_a_tile_edge", 8, 2, 16, [64, 65],
     [192, 193]),
]


@pytest.mark.parametrize("name,Hq,Hkv,page,q_lens,ctx_lens", TC256_CASES,
                         ids=[c[0] for c in TC256_CASES])
def test_launch_plan_tensor_cores_head_dim_256(name, Hq, Hkv, page, q_lens,
                                               ctx_lens):
    """The tensor-core plan at head dim 256, which bf16 and fp16 select at
    groups 1 and 8 and pages 16 and 128 -- prefill tiles of 128 // group
    tokens, most keys first, to their frontier; decode rows in key chunks
    merged by their maxima -- executed as the kernels read it, against
    the JAX Pallas kernel in interpret mode: a ragged last tile at group
    1, and a chunk after cached tokens at group 8 (Gemma-2B's MQA)."""
    group = Hq // Hkv
    for dt in (torch.bfloat16, torch.float16):
        assert tensor_core_prefill(dt, 256, group, page)
    tables, kp, vp = _state_dh(ctx_lens, page, Hkv, 256, seed=len(name))
    q = np.random.default_rng(256).standard_normal(
        (sum(q_lens), Hq, 256)).astype(np.float32)
    plan = plan_launch(q_lens, group, True)
    assert plan.q_tile == TC_ROWS // group and len(plan.seq_of_tile)
    assert len(plan.decode_seqs) == sum(ql * group <= DECODE_ROWS
                                        for ql in q_lens)
    got = _plan_emulated(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         ctx_lens, q_lens, plan, chunk=64)
    kern = jax_ragged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(tables), jnp.asarray(ctx_lens, jnp.int32),
                      q_lens, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


@pytest.mark.parametrize("T,start,group,D", [
    (512, 0, 1, 80), (1024, 0, 1, 96), (256, 512, 1, 80), (512, 0, 1, 256),
    (1024, 0, 8, 256), (256, 512, 1, 256), (200, 511, 4, 256),
    (128, 1900, 8, 96)])
def test_prefill_items_cover_each_pair_once(T, start, group, D):
    """The serving phases' prefills (buckets 512 and 1024 from the first
    token, a 256-token chunk at start 512) and the smoke's frontier cases
    at head dims 80, 96 and 256 (bf16 and fp16: the tensor-core tiles, as
    before at pages 16 and 128): each tile of the plan is one block a kv
    head, walking its K/V tiles (128 keys; 64 at 256) to its causal
    frontier, so each (token, key) pair a row sees is read by exactly one
    block a kv head, no key past the frontier is loaded beyond the last
    tile's, and the tiles with the most keys come first."""
    for dt in (torch.bfloat16, torch.float16):
        for page in (16, 128):
            assert tensor_core_prefill(dt, D, group, page)
    assert not tensor_core_prefill(torch.float32, D, group, 128)
    plan = plan_launch([T], group, True)
    keys = 64 if D == 256 else 128
    walks, seen = [], {}
    for qt in plan.qtile_of_tile.tolist():
        toks = range(qt * plan.q_tile, min(T, (qt + 1) * plan.q_tile))
        frontier = start + min(T, (qt + 1) * plan.q_tile)
        walks.append(-(-frontier // keys))
        assert walks[-1] * keys - frontier < keys
        for t in toks:
            assert t not in seen
            seen[t] = frontier
            assert start + t + 1 <= frontier      # the row's keys loaded
    assert sorted(seen) == list(range(T))
    assert walks == sorted(walks, reverse=True)   # most keys first
