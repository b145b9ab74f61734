"""Port parity: block-sparse attention.

* Every ``SparsityConfig`` of the port builds a layout ``np.array_equal``
  to the JAX package's (the random ones from the same seeds);
  ``layout_tables`` and ``sparse_flops`` return what the JAX ones do.
* The plain version (``sparse_attention_plain``, what CPU tensors take)
  against the JAX Pallas kernel ``sparse_attention_pallas`` in interpret
  mode -- causal, bidirectional, an empty layout row -- and against the JAX
  jnp path with a ``key_padding_mask``; head dims 16 and 64, blocks 16 and
  32.  fp32 inputs from numpy; rtol = atol = 2e-5 (the JAX package's own
  kernel-vs-oracle tolerance: the same sums in other orders).
* ``SparseSelfAttention`` (layout cache, causal from the config) and
  ``SparseAttentionUtils`` round-trip; the dispatch rule; the CUDA path
  refuses CPU tensors, dtypes it is not built for and inputs that need a
  gradient.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import sparse_attention as jpallas
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.cuda.sparse_attention import (
    EDGE_BIT, STEP_WIDTH, card_tables, layout_tables, sparse_attention_cuda,
    sparse_flops, step_overhead, step_tables)
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
H = 4

# (config class name, kwargs): every class, with the options that change
# its layout (directionality, per-head patterns, random blocks, globals)
LAYOUTS = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed_uni": ("FixedSparsityConfig", dict(attention="unidirectional")),
    "fixed_heads": ("FixedSparsityConfig", dict(
        different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=1, num_different_global_patterns=4,
        attention="unidirectional")),
    "fixed_horizontal": ("FixedSparsityConfig", dict(
        horizontal_global_attention=True, num_global_blocks=2)),
    "variable": ("VariableSparsityConfig", dict(
        num_random_blocks=2, local_window_blocks=[2, 4], seed=3)),
    "variable_uni_ranges": ("VariableSparsityConfig", dict(
        different_layout_per_head=True, num_random_blocks=1,
        global_block_indices=[0, 5], global_block_end_indices=[2, 7],
        attention="unidirectional", seed=1)),
    "bigbird": ("BigBirdSparsityConfig", dict(num_random_blocks=1, seed=2)),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(
        different_layout_per_head=True, num_random_blocks=2,
        attention="unidirectional", seed=5)),
    "longformer": ("BSLongformerSparsityConfig", dict(
        global_block_indices=[0, 3])),
    "longformer_uni": ("BSLongformerSparsityConfig", dict(
        global_block_indices=[1], global_block_end_indices=[3],
        attention="unidirectional")),
    "sliding": ("LocalSlidingWindowSparsityConfig",
                dict(num_sliding_window_blocks=3)),
    "sliding_bi": ("LocalSlidingWindowSparsityConfig", dict(
        num_sliding_window_blocks=2, attention="bidirectional")),
}


def _configs(name, block=16):
    cls, kw = LAYOUTS[name]
    return (getattr(jsa, cls)(num_heads=H, block=block, **kw),
            getattr(tsa, cls)(num_heads=H, block=block, **kw))


def _qkv(B=2, S=128, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layouts_bit_identical_to_jax(name):
    jcfg, tcfg = _configs(name)
    for seq_len in (128, 256):            # and the random draws go on alike
        want = jcfg.make_layout(seq_len)
        got = tcfg.make_layout(seq_len)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", ["bigbird", "fixed_heads", "variable"])
def test_layout_tables_and_flops_match_jax(name, causal):
    layout = _configs(name)[0].make_layout(256)
    for got, want in zip(layout_tables(layout, causal),
                         jpallas.layout_tables(layout, causal)):
        np.testing.assert_array_equal(got, want)
    # the kernel's tables as card_tables hands them over: counts, table
    counts, table, max_active = card_tables(layout, causal, "cpu")
    want_table, want_counts, want_max = jpallas.layout_tables(layout, causal)
    assert counts.dtype == table.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(table.numpy(), want_table)
    assert max_active == want_max
    assert sparse_flops(layout, 16, causal, 64) == \
        jpallas.sparse_flops(layout, 16, causal, 64)


# (layout, block, head dim, causal): causal configs run causal
PLAIN_CASES = {
    "fixed_uni_b16_d16": ("fixed_uni", 16, 16, True),
    "bigbird_b32_d64": ("bigbird", 32, 64, False),
    "longformer_b16_d16": ("longformer", 16, 16, False),
    "variable_uni_b16_d64": ("variable_uni_ranges", 16, 64, True),
    "sliding_b32_d16": ("sliding", 32, 16, True),
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_matches_pallas_kernel(case):
    name, block, D, causal = PLAIN_CASES[case]
    q, k, v = _qkv(S=256, D=D, seed=1)
    layout = _configs(name, block)[1].make_layout(256)
    want = jpallas.sparse_attention_pallas(
        *map(jnp.asarray, (q, k, v)), layout, block, causal=causal,
        interpret=True)
    got = tsa.sparse_attention(*map(torch.as_tensor, (q, k, v)), layout,
                               block, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_empty_rows_are_zero_as_the_kernel():
    q, k, v = _qkv(S=64, seed=2)
    block = 16
    layout = np.zeros((H, 4, 4), bool)
    layout[:, 0, 0] = True            # only the first q block sees anything
    layout[1, 2, 1] = True            # and one more block of head 1
    want = jpallas.sparse_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                           layout, block, interpret=True)
    got = tsa.sparse_attention(*map(torch.as_tensor, (q, k, v)), layout,
                               block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[:, block:2 * block].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [True, False])
def test_key_padding_mask_matches_jax_jnp_path(causal):
    q, k, v = _qkv(S=128, seed=3)
    layout = _configs("bigbird")[0].make_layout(128)
    keep = np.ones((2, 128), bool)
    keep[0, 100:] = False
    keep[1, 7] = False
    want = jsa.sparse_attention(*map(jnp.asarray, (q, k, v)), layout, 16,
                                causal=causal, key_padding_mask=keep)
    got = tsa.sparse_attention(*map(torch.as_tensor, (q, k, v)), layout, 16,
                               causal=causal,
                               key_padding_mask=torch.as_tensor(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_self_attention_and_utils_round_trip():
    q, k, v = _qkv(S=128, seed=4)
    jattn = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(
        H, 16, attention="unidirectional"))
    tattn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
        H, 16, attention="unidirectional"))
    got = tattn(*map(torch.as_tensor, (q, k, v)))     # causal from config
    want = jattn(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tattn.get_layout(128) is tattn.get_layout(128)
    np.testing.assert_array_equal(tattn.get_layout(128),
                                  jattn.get_layout(128))

    ids = np.ones((2, 100), np.int64)
    emb = np.random.default_rng(5).standard_normal((2, 100, 8)).astype(
        np.float32)
    pad, ids2, mask2, emb2 = tsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=torch.as_tensor(ids),
        attention_mask=torch.ones(2, 100), inputs_embeds=torch.as_tensor(emb),
        pad_token_id=7)
    jpad, jids2, jmask2, jemb2 = jsa.SparseAttentionUtils.pad_to_block_size(
        16, input_ids=ids, attention_mask=np.ones((2, 100)),
        inputs_embeds=emb, pad_token_id=7)
    assert pad == jpad == 12
    for a, b in ((ids2, jids2), (mask2, jmask2), (emb2, jemb2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = tsa.SparseAttentionUtils.unpad_sequence_output(pad, emb2)
    np.testing.assert_array_equal(out.numpy(), emb)


def test_dispatch_rule():
    q, k, v = map(torch.as_tensor, _qkv(S=100, seed=6))   # 100 % 16 != 0
    layout = tsa.DenseSparsityConfig(H, 16).make_layout(112)
    # a length that does not tile: no path takes it (JAX's dense path
    # fails to broadcast its mask too); the kernel path says why
    with pytest.raises(ValueError, match="does not tile"):
        tsa.sparse_attention(q, k, v, layout, 16)
    with pytest.raises(ValueError, match="tiles by the layout block"):
        tsa.sparse_attention(q, k, v, layout, 16, backend="cuda")
    # a key_padding_mask: the dense masked path on any device, as in JAX
    q, k, v = map(torch.as_tensor, _qkv(S=64, seed=6))
    keep = torch.ones(2, 64, dtype=torch.bool)
    base = tsa.sparse_attention_plain.calls
    out = tsa.sparse_attention(q, k, v, layout, 16, key_padding_mask=keep)
    assert out.shape == q.shape and tsa.sparse_attention_plain.calls == \
        base + 1
    with pytest.raises(ValueError, match="tiles by the layout block"):
        tsa.sparse_attention(q, k, v, layout, 16, backend="cuda",
                             key_padding_mask=keep)
    with pytest.raises(ValueError, match="JAX package's spelling"):
        tsa.sparse_attention(q, k, v, layout, 16, backend="pallas")


def test_cuda_path_refuses_cpu_tensors_and_gradients():
    q = torch.zeros(1, 64, H, 64)
    layout = np.ones((H, 4, 4), bool)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_attention_cuda(q, q, q, layout, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.sparse_attention(q, q, q, layout, 16, backend="cuda")
    # the gradient check comes first, so it is seen here too
    with pytest.raises(NotImplementedError, match="backward"):
        sparse_attention_cuda(q.requires_grad_(), q, q, layout, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_path_takes_its_own_dtypes_to_the_device_check(dtype):
    """The kernel's wrapper keeps its own dtype table (fp32 on the CUDA
    cores, bf16 and fp16 on the tensor cores), apart from the decode
    kernel's: fp16 passes the dtype check and is refused on the CPU only
    for its device; an int dtype is refused for its dtype, by a message
    that names the three the kernel takes."""
    from deepspeed_tpu_torch.ops.cuda import decode_attention
    from deepspeed_tpu_torch.ops.cuda import \
        sparse_attention as cuda_sparse
    assert cuda_sparse.SPARSE_DTYPES == {
        torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    assert cuda_sparse.SPARSE_DTYPES is not decode_attention._DTYPE_CODES
    layout = np.ones((H, 4, 4), bool)
    q = torch.zeros(1, 64, H, 64, dtype=dtype)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sparse_attention_cuda(q, q, q, layout, 16)
    bad = torch.zeros(1, 64, H, 64, dtype=torch.int32)
    with pytest.raises(ValueError,
                       match="takes float32, bfloat16 or float16 tensors"):
        sparse_attention_cuda(bad, bad, bad, layout, 16)
    with pytest.raises(ValueError, match="of one dtype"):
        sparse_attention_cuda(q, q, q.to(torch.int32), layout, 16)


def test_plain_path_takes_gradients_on_the_cpu():
    q, k, v = (t.requires_grad_() for t in map(torch.as_tensor,
                                                _qkv(S=64, seed=7)))
    layout = tsa.FixedSparsityConfig(H, 16).make_layout(64)
    tsa.sparse_attention(q, k, v, layout, 16).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# ---- the bf16 kernel's step tables (host side, no card needed) ----------

def _grid(block):
    """(rows per q group and key unit, slots per step, q blocks per
    tile) of the bf16 kernel at layout block ``block``."""
    unit = min(block, 64)
    return unit, 64 // unit, max(1, 64 // block)


def _coverage(layout, block, causal):
    """How often the step tables leave each (q group, key unit) pair
    unmasked, at the resolution of one unit (a block up to 64 rows, a
    64-row half of a block of 128), and what they should: the layout at
    that resolution, less what lies above the diagonal when causal."""
    counts, starts, steps = step_tables(layout, block, causal)
    H, nb, _ = layout.shape
    unit, slots, qpt = _grid(block)
    n = nb * block // unit
    cov = np.zeros((H, n, n), int)
    for h in range(H):
        for t in range(counts.shape[1]):
            for st in steps[starts[h, t]:starts[h, t] + counts[h, t]]:
                for i in range(qpt):
                    for j in range(slots):
                        if st[0] >> (i * slots + j) & 1:
                            cov[h, t * qpt + i, st[1 + j] // unit] += 1
    rep = block // unit
    want = np.repeat(np.repeat(np.asarray(layout, bool), rep, 1), rep, 2)
    if causal:
        want &= np.tril(np.ones((n, n), bool))
    return cov, want.astype(int)


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step_tables_cover_each_set_pair_once(name, block):
    """Every layout the JAX package makes, causal and not: each set (q
    block, k block) pair of ``layout_tables`` is unmasked in exactly one
    step, and no unset or above-diagonal pair in any."""
    layout = _configs(name, block)[1].make_layout(512)
    for causal in (True, False):
        cov, want = _coverage(layout, block, causal)
        np.testing.assert_array_equal(cov, want)
        # the same pairs at block resolution as layout_tables lists them
        table, counts, _ = layout_tables(layout, causal)
        rep = block // min(block, 64)
        seen = cov.reshape(H, -1, rep, cov.shape[2] // rep, rep).any((2, 4))
        listed = np.zeros_like(seen)
        for h in range(H):
            for qb in range(seen.shape[1]):
                listed[h, qb, table[h, qb, :counts[h, qb]]] = True
        np.testing.assert_array_equal(seen, listed)


def test_step_tables_edge_bit_and_padding():
    """A step without the edge bit has every pair set and none on the
    diagonal; a padded slot repeats the step's first unit, unset."""
    layout = _configs("fixed_uni", 16)[1].make_layout(1024)
    counts, starts, steps = step_tables(layout, 16, True)
    assert steps.shape[1] == STEP_WIDTH and steps.dtype == np.int32
    full = (1 << 16) - 1
    n_full = 0
    for st in steps[:int(counts.sum())]:
        if not st[0] & EDGE_BIT:
            n_full += 1
            assert st[0] == full
    assert n_full > 0
    # Dense at block 16: four q blocks see 4 k blocks per step; the last
    # q tile's diagonal step is on the edge
    dense = np.ones((1, 8, 8), bool)
    c, s, st = step_tables(dense, 16, True)
    assert c.tolist() == [[1, 2]]
    assert st[s[0, 1] + 1, 0] & EDGE_BIT and not st[s[0, 1], 0] & EDGE_BIT
    # three set blocks in a step of four slots: the fourth repeats the first
    lay = np.zeros((1, 4, 4), bool)
    lay[0, :, :3] = True
    c, s, st = step_tables(lay, 16, False)
    assert c.tolist() == [[1]] and st[0, 1:5].tolist() == [0, 16, 32, 0]
    assert st[0, 0] & EDGE_BIT and st[0, 0] & 0xFFFF == 0x7777


def _steps_emulated(q, k, v, layout, block, causal, scale):
    """The bf16 kernel's arithmetic in fp32 on the CPU, over the step
    tables: per tile and step, the gathered keys' scores, masked by the
    pair mask (and causally) only on edge steps, an online softmax, rows
    that see no key 0."""
    counts, starts, steps = step_tables(layout, block, causal)
    B, S, Hh, D = q.shape
    unit, slots, qpt = _grid(block)
    out = torch.zeros_like(q)
    for b in range(B):
        for h in range(Hh):
            for t in range(counts.shape[1]):
                r0 = t * 64
                qt = q[b, r0:r0 + 64, h]
                rows = torch.arange(r0, r0 + qt.shape[0])
                m = torch.full((qt.shape[0],), -1e30)
                l = torch.zeros(qt.shape[0])
                acc = torch.zeros(qt.shape[0], D)
                for st in steps[starts[h, t]:starts[h, t] + counts[h, t]]:
                    keys = torch.cat([torch.arange(int(st[1 + j]),
                                                   int(st[1 + j]) + unit)
                                      for j in range(slots)])
                    s = qt @ k[b, keys, h].T * scale
                    if st[0] & EDGE_BIT:
                        qi = (rows - r0) // block if block < 64 else \
                            torch.zeros_like(rows)
                        slot = torch.arange(64) // unit
                        ok = (int(st[0]) >> (qi[:, None] * slots +
                                             slot[None, :])) & 1 == 1
                        if causal:
                            ok &= keys[None, :] <= rows[:, None]
                        s = s.masked_fill(~ok, -1e30)
                    m_new = torch.maximum(m, s.max(1).values)
                    base = torch.where(m_new <= -5e29, 0.0, m_new)
                    p = torch.exp(s - base[:, None])
                    corr = torch.exp(m - base)
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ v[b, keys, h]
                    m = m_new
                out[b, r0:r0 + 64, h] = acc / l.clamp_min(1e-30)[:, None]
    return out


@pytest.mark.parametrize("name,block,causal", [
    ("fixed_uni", 16, True), ("bigbird", 32, False),
    ("longformer_uni", 64, True), ("variable", 128, False),
    ("sliding", 128, True), ("fixed_heads", 16, True)])
def test_step_tables_compute_the_plain_function(name, block, causal):
    """The step tables, read as the bf16 kernel reads them, give the plain
    version's attention (fp32, the same sums in another order)."""
    q, k, v = map(torch.as_tensor, _qkv(B=1, S=256, D=16, seed=8))
    layout = _configs(name, block)[1].make_layout(256)
    got = _steps_emulated(q, k, v, layout, block, causal, 0.25)
    want = tsa.sparse_attention_plain(q, k, v, layout, block, causal=causal,
                                      softmax_scale=0.25)
    torch.testing.assert_close(got, want, **TOL)


def test_step_overhead_of_the_path_layouts():
    """The union's cost at the smoke's Fixed-16 and BigBird-64 layouts
    (S=4096, 16 heads): at most 2x the set pairs' work."""
    for cls, kw, block, causal in (
            (tsa.FixedSparsityConfig, dict(attention="unidirectional"), 16,
             True),
            (tsa.BigBirdSparsityConfig, dict(seed=1), 64, False)):
        layout = cls(16, block, **kw).make_layout(4096)
        assert 1.0 <= step_overhead(layout, block, causal) <= 2.0
