"""Port parity: the flash backward's row term ``delta`` and the host side
around the backward kernels.

``flash_attention_bwd_delta_plain`` (the plain version of the delta
kernel, ``ops/csrc/flash_attention_bwd.cu``) against the expression
``_flash_bwd_pallas`` forms on the TPU host side, ``sum(dO * O)`` in fp32,
on the same numpy inputs in fp32, bf16 and fp16 at the flash kernels' head
dims: both are fp32 sums of the same products, so rtol = atol = 1e-5
covers their order.  Then ``flash_attention_bwd_cuda``'s glue with its
three kernels replaced by CPU stand-ins that keep the kernels' contracts:
at a GQA group of 1, and at every group where the dK/dV kernel sums the
group on the card (``dkv_sums_group``: bf16 / fp16 at head dim 256), it
returns the dK/dV kernel's own outputs (k's dtype, no sum, no cast);
elsewhere at a larger group it sums the fp32 per-query-head outputs over
the group and casts -- all equal to the plain backward.
The kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import flash_attention as flash_cuda
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_delta_plain, flash_attention_bwd_plain,
    flash_attention_fwd_plain)
from torch_threads import _one_torch_thread  # noqa: F401

DELTA_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("head_dim", flash_cuda.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_delta_matches_the_jax_expression(dtype, head_dim):
    """delta [B, H, S] from O and dO [B, S, H, D] in their own dtype equals
    ``_flash_bwd_pallas``'s ``sum(dO.astype(f32) * O.astype(f32))`` over
    the same rows."""
    B, S, H = 2, 24, 3
    o, g = _rows((B, S, H, head_dim), seed=head_dim)
    t_dt, j_dt = DTYPES[dtype]
    got = flash_attention_bwd_delta_plain(torch.from_numpy(o).to(t_dt),
                                          torch.from_numpy(g).to(t_dt))
    jo, jg = (jnp.swapaxes(jnp.asarray(x).astype(j_dt), 1, 2).reshape(
        B * H, S, head_dim) for x in (o, g))
    want = jnp.sum(jg.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1,
                   keepdims=True).reshape(B, H, S)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DELTA_TOL)


def test_delta_wrapper_refuses_cpu_tensors_and_other_head_dims():
    """The delta kernel's wrapper takes the flash kernels' head dims on the
    card only: head dim 48 is refused naming ROADMAP A16, a CPU tensor for
    its device; neither launches."""
    fn = flash_cuda.flash_attention_bwd_delta_cuda
    before = fn.launches
    with pytest.raises(NotImplementedError, match="head_dim 48 not in"):
        fn(torch.zeros(1, 8, 2, 48), torch.zeros(1, 8, 2, 48))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64))
    assert fn.launches == before


def _stand_ins(monkeypatch, made, out):
    """CPU stand-ins for the three backward kernels, with their contracts:
    delta fp32 [B, H, S]; dQ in q's dtype; dK/dV (the plain backward over
    the kv heads repeated, from the forward's ``out``) in k's dtype at Hkv
    heads when the group is 1 or ``dkv_sums_group`` holds (the group summed
    in fp32 first, as the cluster sums it), else fp32 per query head.  Each
    dK/dV pair goes to ``made``."""

    def delta(out, dout):
        return flash_attention_bwd_delta_plain(out, dout)

    def dq(q, k, v, dout, lse, delta_, scale, causal=True):
        return torch.zeros_like(q)

    def dkv(q, k, v, dout, lse, delta_, scale, causal=True):
        H = q.shape[2]
        g = H // k.shape[2]
        kx, vx = (x.float().repeat_interleave(g, dim=2) for x in (k, v))
        _, dk, dv = flash_attention_bwd_plain(q.float(), kx, vx, out.float(),
                                              lse, dout.float(), scale,
                                              causal)
        if flash_cuda.dkv_sums_group(q.shape[3], q.dtype):
            B, S, _, D = q.shape
            dk, dv = (x.view(B, S, -1, g, D).sum(3) for x in (dk, dv))
            g = 1
        if g == 1:
            dk, dv = dk.to(k.dtype), dv.to(v.dtype)
        made.append((dk, dv))
        return dk, dv

    monkeypatch.setattr(flash_cuda, "flash_attention_bwd_delta_cuda", delta)
    monkeypatch.setattr(flash_cuda, "flash_attention_bwd_dq_cuda", dq)
    monkeypatch.setattr(flash_cuda, "flash_attention_bwd_dkv_cuda", dkv)


@pytest.mark.parametrize("head_dim, heads", [
    (64, (4, 4)), (64, (4, 2)), (64, (8, 1)),
    (256, (4, 4)), (256, (4, 2)), (256, (8, 1)), (256, (16, 1))])
def test_backward_glue_sums_and_casts_only_a_group(head_dim, heads,
                                                   monkeypatch):
    """``flash_attention_bwd_cuda`` around the kernels, in bf16: at group 1
    its dK and dV are the dK/dV kernel's own tensors, in k's dtype; at head
    dim 64 and groups 2 and 8 the group sum of the fp32 per-query-head
    outputs, cast to k's dtype; at head dim 256 the kernel's own tensors at
    every group (1, 2, 8, 16: it sums the group on the card), neither
    summed nor cast again.  Every way dK and dV equal the plain backward's,
    which sums and rounds the same fp32 values."""
    H, Hkv = heads
    made = []
    rng = np.random.default_rng(H * 10 + Hkv + head_dim)
    B, S, D = 2, 16, head_dim
    scale = 1.0 / math.sqrt(D)
    q, dout = (torch.from_numpy(rng.standard_normal(
        (B, S, H, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, S, Hkv, D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    out, lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                         scale)
    out = out.to(torch.bfloat16)
    _stand_ins(monkeypatch, made, out)
    _, dk, dv = flash_cuda.flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                    scale)
    kdk, kdv = made[0]
    assert (dk.dtype, dv.dtype) == (k.dtype, v.dtype)
    assert dk.shape == k.shape and dv.shape == v.shape
    assert flash_cuda.dkv_sums_group(D, q.dtype) == (D == 256)
    if H == Hkv or D == 256:
        assert dk is kdk and dv is kdv
    else:
        assert kdk.dtype == torch.float32 and kdk.shape == q.shape
        torch.testing.assert_close(
            dk, kdk.view(B, S, Hkv, H // Hkv, D).sum(3).to(k.dtype))
    _, want_dk, want_dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                    scale)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("head_dim", flash_cuda.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dkv_sums_group_only_on_the_tensor_cores_at_head_dim_256(dtype,
                                                                 head_dim):
    """The dK/dV kernel sums a GQA group on the card (and returns k's dtype
    at the kv heads) in its bf16 and fp16 forms at head dim 256 only: fp32
    and the other head dims keep the fp32 per-query-head convention."""
    t_dt, _ = DTYPES[dtype]
    want = head_dim == 256 and t_dt in (torch.bfloat16, torch.float16)
    assert flash_cuda.dkv_sums_group(head_dim, t_dt) is want
