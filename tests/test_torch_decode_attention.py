"""Port parity: contiguous-cache decode attention.

``deepspeed_tpu_torch.ops.decode_attention`` (its plain PyTorch version,
which CPU tensors take) against the JAX package's jnp path and its Pallas
kernel in interpret mode, on the same numpy-seeded inputs.  fp32 on both
sides; the paths differ only in summation order, hence rtol=atol=2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.decode_attention import decode_attention as jax_decode
from deepspeed_tpu.ops.decode_attention import init_cache as jax_init_cache
from deepspeed_tpu.ops.decode_attention import update_cache as jax_update
from deepspeed_tpu.ops.pallas.decode_attention import decode_attention_pallas
from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    DECODE_MIN_CHUNK, DECODE_MIN_CHUNK_STAGED, DECODE_MIN_CHUNK_TC,
    DECODE_ROWS, HEAD_DIMS, STAGED_HEAD_DIMS, STAGED_ONE_ROW_KEYS,
    STAGED_ROWS_KEYS,
    decode_attention_cuda, decode_attention_plain, decode_splits, min_chunk,
    staged)
from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import \
    ragged_paged_attention_cuda
from deepspeed_tpu_torch.ops.decode_attention import (decode_attention,
                                                      init_cache,
                                                      resolve_backend,
                                                      update_cache)
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
B, S, D, H = 2, 16, 8, 4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _caches(Hkv, T, prefix=7, seed=0, Dh=D):
    """The same prefix + T new tokens appended to a JAX and a port cache
    of head dim Dh."""
    rng = np.random.default_rng(seed)
    k0, v0 = _rand(rng, B, prefix, Hkv, Dh), _rand(rng, B, prefix, Hkv, Dh)
    k1, v1 = _rand(rng, B, T, Hkv, Dh), _rand(rng, B, T, Hkv, Dh)
    jc = jax_init_cache(B, S, Hkv, Dh, jnp.float32)
    jc = jax_update(jc, jnp.asarray(k0), jnp.asarray(v0))
    jc = jax_update(jc, jnp.asarray(k1), jnp.asarray(v1))
    tc = init_cache(B, S, Hkv, Dh, torch.float32, device="cpu")
    tc = update_cache(tc, torch.from_numpy(k0), torch.from_numpy(v0))
    tc = update_cache(tc, torch.from_numpy(k1), torch.from_numpy(v1))
    q = _rand(rng, B, T, H, Dh)
    return jc, tc, q


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
def test_update_cache_matches_jax(Hkv, T):
    jc, tc, _ = _caches(Hkv, T)
    assert tc.length == int(jc.length)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
def test_decode_attention_matches_jnp_and_pallas(Hkv, T):
    jc, tc, q = _caches(Hkv, T)
    got = decode_attention(torch.from_numpy(q), tc).numpy()
    want = jax_decode(jnp.asarray(q), jc, impl="jnp")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    lengths = jnp.full((B,), jc.length, jnp.int32)
    kern = decode_attention_pallas(jnp.asarray(q), jc.k, jc.v, lengths,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
def test_ragged_lengths_match_pallas(Hkv, T):
    """Per-sequence lengths (the kernel's [B] operand): the plain version
    against the Pallas kernel, lengths >= T so every row sees a key."""
    rng = np.random.default_rng(3)
    q = _rand(rng, B, T, H, D)
    k, v = _rand(rng, B, Hkv, S, D), _rand(rng, B, Hkv, S, D)
    lengths = np.asarray([T + 2, S], np.int32)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(lengths)).numpy()
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
def test_chunk_edge_lengths_match_pallas(Hkv):
    """Lengths where key blocks meet a sequence's end over S_max 1024:
    64-key blocks (1, 63, 64, 65) and the card's shortest decode-form
    chunks (DECODE_MIN_CHUNK - 1, .., + 1), in one ragged
    batch with a long sequence.  The plain version, which the card holds
    the kernel to, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(11)
    S_max, c = 1024, DECODE_MIN_CHUNK
    lengths = np.asarray([1, 63, 64, 65, c - 1, c, c + 1, 1000], np.int32)
    Bn = len(lengths)
    q = _rand(rng, Bn, 1, H, D)
    k, v = _rand(rng, Bn, Hkv, S_max, D), _rand(rng, Bn, Hkv, S_max, D)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(lengths)).numpy()
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("T,Hkv", [(1, 1), (1, 2), (2, 1)],
                         ids=["decode", "decode_g4", "prefill_form"])
def test_head_dim_64_group_8_matches_pallas(T, Hkv):
    """Head dim 64 with a GQA group of 8 (TinyLlama-1.1B's shape, 32/4
    heads, cut to 8/1) and of 4, on ragged lengths: decode steps (8 and 4
    rows a kv head, the decode form on the card) and two tokens at group 8
    (16 rows, the prefill form).  The plain version, which the card holds
    the kernel to, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(13)
    Hq, Dh, Sm = 8, 64, 32
    q = _rand(rng, 3, T, Hq, Dh)
    k, v = _rand(rng, 3, Hkv, Sm, Dh), _rand(rng, 3, Hkv, Sm, Dh)
    lengths = np.asarray([T, 17, Sm], np.int32)
    assert (T * Hq // Hkv <= DECODE_ROWS) == (T == 1)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(lengths)).numpy()
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("Dh", [80, 96])
def test_head_dims_80_96_match_jnp_and_pallas(Dh, Hkv, T):
    """Head dims 80 (GPT-3 2.7B's) and 96 (Phi-3-mini's), MHA and GQA,
    a decode step and 5 tokens: the port's decode attention on a cache
    (the plain version on the CPU) against the JAX package's jnp path and
    its Pallas kernel in interpret mode, then ragged lengths (the kernel's
    [B] operand) against the Pallas kernel."""
    jc, tc, q = _caches(Hkv, T, seed=Dh, Dh=Dh)
    got = decode_attention(torch.from_numpy(q), tc).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_decode(jnp.asarray(q), jc, impl="jnp")), **TOL)
    lengths = jnp.full((B,), jc.length, jnp.int32)
    kern = decode_attention_pallas(jnp.asarray(q), jc.k, jc.v, lengths,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    rng = np.random.default_rng(Dh + T)
    k, v = _rand(rng, B, Hkv, S, Dh), _rand(rng, B, Hkv, S, Dh)
    ragged = np.asarray([T + 2, S], np.int32)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(ragged)).numpy()
    kern = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(ragged),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("T,Hkv", [(1, 4), (2, 4), (4, 4), (8, 4), (1, 1),
                                   (2, 1)])
def test_head_dim_16_matches_jnp_and_pallas(T, Hkv):
    """Head dim 16 (the benches' ``tiny`` model: 4 heads of 16), 1, 2, 4
    and 8 rows a kv head (MHA at T = 1, 2, 4, 8; 4 and 8 at group 4): the
    port's decode attention on a cache (the plain version on the CPU)
    against the JAX package's jnp path and its Pallas kernel in interpret
    mode, then ragged lengths against the Pallas kernel.  fp32, rtol =
    atol = 2e-5."""
    Dh = 16
    jc, tc, q = _caches(Hkv, T, seed=Dh + T, Dh=Dh)
    got = decode_attention(torch.from_numpy(q), tc).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_decode(jnp.asarray(q), jc, impl="jnp")), **TOL)
    lengths = jnp.full((B,), jc.length, jnp.int32)
    kern = decode_attention_pallas(jnp.asarray(q), jc.k, jc.v, lengths,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)
    rng = np.random.default_rng(Dh + 10 * T)
    k, v = _rand(rng, B, Hkv, S, Dh), _rand(rng, B, Hkv, S, Dh)
    ragged = np.asarray([T + 2, S], np.int32)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(ragged)).numpy()
    kern = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(ragged),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_head_dim_16_takes_the_cuda_core_body(dtype):
    """Head dim 16 runs the CUDA-core split body at every row count and
    dtype: never staged, the CUDA-core body's shortest chunk
    (DECODE_MIN_CHUNK) at 5-8 rows too, so a split plan's chunks are
    multiples of 64 keys of at least 512.  The inference bench's shapes
    (B=1, 4 heads, a 192-key cache) take one chunk; the same sequence over
    2048 keys splits."""
    for rows in range(1, DECODE_ROWS + 1):
        assert min_chunk(rows, dtype, 16) == DECODE_MIN_CHUNK
        for chunk in (192, 512, 2176):
            assert not staged(rows, dtype, 16, chunk)
    assert decode_splits(1, 1, 4, 4, 192, 528, dtype, 16) == (1, 192)
    assert decode_splits(1, 128, 4, 4, 192, 528, dtype, 16) == (1, 192)
    assert decode_splits(1, 2, 4, 1, 2048, 528, dtype, 16) == (4, 512)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 1)], ids=["group1", "group8"])
def test_head_dim_256_matches_jnp_and_pallas(Hq, Hkv, T):
    """Head dim 256 (Gemma's) at group 1 (Gemma-7B's MHA) and group 8 over
    one kv head (Gemma-2B's MQA), a decode step and 5 tokens (the verify
    window): the port's decode attention on a cache (the plain version on
    the CPU) against the JAX package's jnp path and its Pallas kernel in
    interpret mode, then ragged lengths against the Pallas kernel.  fp32,
    rtol = atol = 1e-5."""
    tol = dict(rtol=1e-5, atol=1e-5)
    Dh = 256
    rng = np.random.default_rng(Hq + T)
    k0, v0 = _rand(rng, B, 7, Hkv, Dh), _rand(rng, B, 7, Hkv, Dh)
    k1, v1 = _rand(rng, B, T, Hkv, Dh), _rand(rng, B, T, Hkv, Dh)
    jc = jax_init_cache(B, S, Hkv, Dh, jnp.float32)
    tc = init_cache(B, S, Hkv, Dh, torch.float32, device="cpu")
    for k, v in ((k0, v0), (k1, v1)):
        jc = jax_update(jc, jnp.asarray(k), jnp.asarray(v))
        tc = update_cache(tc, torch.from_numpy(k), torch.from_numpy(v))
    q = _rand(rng, B, T, Hq, Dh)
    got = decode_attention(torch.from_numpy(q), tc).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_decode(jnp.asarray(q), jc, impl="jnp")), **tol)
    lengths = jnp.full((B,), jc.length, jnp.int32)
    kern = decode_attention_pallas(jnp.asarray(q), jc.k, jc.v, lengths,
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **tol)
    k, v = _rand(rng, B, Hkv, S, Dh), _rand(rng, B, Hkv, S, Dh)
    ragged = np.asarray([T + 2, S], np.int32)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(ragged)).numpy()
    kern = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(ragged),
                                   interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **tol)


@pytest.mark.parametrize("Dh", [16, 64, 80, 96, 128, 48, 256])
def test_wrappers_check_the_head_dim_first(Dh):
    """B5's and B4's wrappers take head dims 16, 64, 80, 96, 128 and 256
    and refuse any other with ``NotImplementedError`` naming ROADMAP A16,
    before any other check: a head dim they take goes on to the device
    check, which CPU tensors fail with ``ValueError``."""
    assert HEAD_DIMS == (16, 64, 80, 96, 128, 256)
    q, kv = torch.zeros(1, 1, 2, Dh), torch.zeros(1, 2, 8, Dh)
    pages = torch.zeros(4, 2, 8, Dh)
    meta = torch.zeros(1, dtype=torch.int32)
    calls = [lambda: decode_attention_cuda(q, kv, kv, 1),
             lambda: ragged_paged_attention_cuda(
                 q[0], pages, pages, torch.zeros(1, 1, dtype=torch.int32),
                 meta, meta, meta, meta[:0], meta[:0], 8)]
    for call in calls:
        if Dh in HEAD_DIMS:
            with pytest.raises(ValueError, match="CUDA tensors"):
                call()
        else:
            with pytest.raises(NotImplementedError,
                               match=f"head_dim {Dh} .*ROADMAP A16"):
                call()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("B,T,H,Hkv,slots,want,want256", [
    # 128 blocks fill it
    (4, 1, 32, 32, 132, [(1, 192), (1, 4096)], None),
    # 32 blocks: split
    (1, 1, 32, 32, 132, [(1, 192), (4, 1024)], None),
    (4, 1, 32, 8, 264, [(1, 192), (8, 512)], None),         # GQA, 4 rows
    (4, 128, 32, 32, 132, [(1, 160), (1, 4096)], None),     # prefill form
    # 8 rows: decode form; at 256 the staged body's chunks of 128 and up
    (2, 2, 32, 8, 264, [(1, 192), (2, 2048)], [(1, 192), (16, 256)]),
    # group 8 (TinyLlama; at 256 Gemma-2B's 8 / 1)
    (4, 1, 32, 4, 132, [(1, 192), (2, 2048)], [(1, 192), (8, 512)]),
    (4, 1, 8, 1, 132, [(1, 192), (2, 2048)], [(1, 192), (32, 128)]),
    (8, 5, 32, 32, 132, [(1, 192), (1, 4096)], None),      # 5 rows, 256 pairs
    (1, 9, 32, 32, 132, [(1, 160), (1, 4096)], None),      # 9 rows: prefill
])
def test_decode_splits(B, T, H, Hkv, slots, want, want256, Dh, dtype):
    """The decode form (at most DECODE_ROWS rows a kv head) splits a
    sequence's keys only as far as one wave of the card's block slots, in
    chunks of at least min_chunk keys (a multiple of 64: DECODE_MIN_CHUNK
    on the CUDA-core body, DECODE_MIN_CHUNK_TC on the tensor-core body at
    5-8 rows in bf16 / fp16 at head dims up to 128, DECODE_MIN_CHUNK_STAGED
    on the staged body at 5-8 rows at 256) that cover S_max (the C entry
    refuses less); the prefill form takes one.  ``want256`` is the plan at
    head dim 256 where it differs (the 5-8-row forms)."""
    got = [decode_splits(B, T, H, Hkv, S, slots, dtype, Dh)
           for S in (160, 4096)]
    assert got == (want256 if Dh == 256 and want256 else want)
    least = min_chunk(T * H // Hkv, dtype, Dh)
    for S in (1, 144, 160, 511, 512, 513, 616, 2048, 4096):
        n, c = decode_splits(B, T, H, Hkv, S, slots, dtype, Dh)
        assert n * c >= S > (n - 1) * c
        assert n == 1 or (c % 64 == 0 and c >= least and
                          B * Hkv * n <= slots)


@pytest.mark.parametrize("rows,dtype,Dh,want", [
    (1, torch.bfloat16, 128, DECODE_MIN_CHUNK),
    (4, torch.float16, 128, DECODE_MIN_CHUNK),
    (5, torch.bfloat16, 128, DECODE_MIN_CHUNK_TC),
    (8, torch.float16, 128, DECODE_MIN_CHUNK_TC),
    (8, torch.float32, 128, DECODE_MIN_CHUNK),
    (8, torch.bfloat16, 64, DECODE_MIN_CHUNK_TC),
    (5, torch.bfloat16, 80, STAGED_ROWS_KEYS),
    (6, torch.float16, 80, STAGED_ROWS_KEYS),
    (7, torch.bfloat16, 96, STAGED_ROWS_KEYS),
    (8, torch.float16, 96, STAGED_ROWS_KEYS),
    (5, torch.float32, 96, DECODE_MIN_CHUNK),
    (1, torch.bfloat16, 256, DECODE_MIN_CHUNK),
    (1, torch.float16, 256, DECODE_MIN_CHUNK),
    (1, torch.bfloat16, 80, DECODE_MIN_CHUNK),
    (1, torch.float16, 96, DECODE_MIN_CHUNK),
    (1, torch.float32, 80, DECODE_MIN_CHUNK),
    (1, torch.float32, 256, DECODE_MIN_CHUNK),
    (2, torch.bfloat16, 80, DECODE_MIN_CHUNK),
    (1, torch.float16, 64, DECODE_MIN_CHUNK),
    (4, torch.float16, 256, DECODE_MIN_CHUNK),
    (5, torch.bfloat16, 256, DECODE_MIN_CHUNK_STAGED),
    (6, torch.float16, 256, DECODE_MIN_CHUNK_STAGED),
    (7, torch.bfloat16, 256, DECODE_MIN_CHUNK_STAGED),
    (8, torch.float16, 256, DECODE_MIN_CHUNK_STAGED),
    (8, torch.bfloat16, 256, DECODE_MIN_CHUNK_STAGED),
    (8, torch.float32, 256, DECODE_MIN_CHUNK)])
def test_min_chunk_by_form(rows, dtype, Dh, want):
    """The tensor-core body (5-8 rows in bf16 or fp16) splits only into
    chunks of DECODE_MIN_CHUNK_TC keys at head dims 64 and 128, of
    DECODE_MIN_CHUNK_STAGED at 256 (the staged body) and of
    STAGED_ROWS_KEYS at 80 and 96 (the staged body, which chunks that long
    take); 1-4 rows (the CUDA-core body, and one row's staged body at 80,
    96 and 256) and fp32 at any row count into chunks of
    DECODE_MIN_CHUNK, at every head dim."""
    assert min_chunk(rows, dtype, Dh) == want
    slots = 32 * max(16, 8192 // want)      # enough for the least chunk
    n, c = decode_splits(1, rows, 32, 32, 8192, slots, dtype, Dh)
    assert c == want and n == 8192 // want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("Dh", HEAD_DIMS)
def test_staged_body_rule(Dh, dtype):
    """The staged body takes 5-8 rows a kv head at head dim 256 and, over
    chunks of STAGED_ROWS_KEYS keys and up, at 80 and 96 (gpt_2_7b's
    verify window), and one row at 80, 96 and 256 (gpt_2_7b's,
    Phi-3-mini's and Gemma-7B's MHA decode steps) over chunks of
    STAGED_ONE_ROW_KEYS keys and up, in bf16 / fp16; shorter chunks (a
    generate step's 160-key cache), D=64, D=128, fp32 and 2-4 rows keep
    their bodies.  A plan that splits has chunks of at least that many
    keys, so it is staged."""
    for rows in range(1, DECODE_ROWS + 1):
        for chunk in (192, STAGED_ONE_ROW_KEYS - 64, STAGED_ONE_ROW_KEYS,
                      STAGED_ROWS_KEYS - 64, STAGED_ROWS_KEYS, 2176):
            want = dtype != torch.float32 and (
                (rows > 4 and (Dh == 256 or (Dh in (80, 96) and
                                             chunk >= STAGED_ROWS_KEYS))) or
                (rows == 1 and Dh in STAGED_HEAD_DIMS and
                 chunk >= STAGED_ONE_ROW_KEYS))
            assert staged(rows, dtype, Dh, chunk) == want
    assert STAGED_HEAD_DIMS == (80, 96, 256)
    assert min_chunk(1, dtype, Dh) >= STAGED_ONE_ROW_KEYS
    if Dh in (80, 96) and dtype != torch.float32:
        assert all(min_chunk(r, dtype, Dh) >= STAGED_ROWS_KEYS
                   for r in range(5, DECODE_ROWS + 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Dh,H,slots", [
    # two staged blocks an SM at 80 and 96 (~100 KB each), one at 256
    (80, 32, 264), (96, 32, 264), (256, 16, 132)])
def test_one_row_plans(Dh, H, slots, dtype):
    """The one-row steps' plans and bodies: the serve run's 8-slot step (8
    sequences over a table of 17 pages of 128) takes one wave of whole
    sequences on the staged body; one sequence alone over 2048 keys
    splits into 4 chunks of 512, staged; a generate step (B=4, 160 keys)
    takes one chunk on the CUDA-core body."""
    for B, S, want, body in ((8, 17 * 128, (1, 2176), True),
                             (1, 2048, (4, 512), True),
                             (4, 160, (1, 192), False)):
        n, c = decode_splits(B, 1, H, H, S, slots, dtype, Dh)
        assert (n, c) == want and staged(1, dtype, Dh, c) == body


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Dh", [80, 96])
@pytest.mark.parametrize("T", [5, 8])
def test_staged_rows_plans(T, Dh, dtype):
    """5-8 rows a kv head at head dims 80 and 96 (MHA, T tokens a
    sequence: gpt_2_7b's verify window of 5) on two staged blocks an SM:
    the serve run's 8 slots over a table of 17 pages of 128 take one wave
    of whole sequences, staged; one sequence alone over 2048 keys splits
    into 4 chunks of 512, staged; B=4 over a 160-key cache takes one
    chunk on the register tensor-core body."""
    for B, S, want, body in ((8, 17 * 128, (1, 2176), True),
                             (1, 2048, (4, 512), True),
                             (4, 160, (1, 192), False)):
        n, c = decode_splits(B, T, 32, 32, S, 264, dtype, Dh)
        assert (n, c) == want and staged(T, dtype, Dh, c) == body
        assert n == 1 or c >= min_chunk(T, dtype, Dh)


def test_update_cache_raises_past_the_buffer():
    """JAX's dynamic_update_slice clamps the start silently; the port
    refuses to write past max_seq."""
    tc = init_cache(1, 4, 1, D, torch.float32, device="cpu")
    tc = update_cache(tc, torch.zeros(1, 3, 1, D), torch.zeros(1, 3, 1, D))
    with pytest.raises(ValueError, match="overflow"):
        update_cache(tc, torch.zeros(1, 2, 1, D), torch.zeros(1, 2, 1, D))


def test_update_cache_writes_in_place():
    tc = init_cache(1, 4, 1, D, torch.float32, device="cpu")
    buf = tc.k
    out = update_cache(tc, torch.ones(1, 2, 1, D), torch.ones(1, 2, 1, D))
    assert out.k is buf and out.length == 2
    assert buf[:, :, :2].eq(1).all() and buf[:, :, 2:].eq(0).all()


def test_backend_vocabulary():
    cpu = torch.zeros(1)
    assert resolve_backend("auto", cpu) == "plain"
    assert resolve_backend(None, cpu) == "plain"
    assert resolve_backend("cuda", cpu) == "cuda"
    assert resolve_backend("plain", cpu) == "plain"
    for jax_name in ("jnp", "pallas", "pallas-interpret"):
        with pytest.raises(ValueError, match="JAX"):
            resolve_backend(jax_name, cpu)
    with pytest.raises(ValueError, match="unknown"):
        resolve_backend("triton", cpu)


def test_plain_counter_counts_cpu_calls():
    _, tc, q = _caches(2, 1)
    before = decode_attention_plain.calls
    decode_attention(torch.from_numpy(q), tc, backend="plain")
    assert decode_attention_plain.calls == before + 1
