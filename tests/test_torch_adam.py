"""Port parity: fused Adam's plain version and the optimizer builder.

The port's ``reference_impl`` and ``fused_adam`` (CPU tensors: the plain
version) against the JAX package's ``ops/adam.reference_impl`` and
``fused_adam_pallas(..., interpret=True)`` over three steps, AdamW and L2
modes, bias correction on and off, with n not a multiple of 128.  fp32;
rtol 1e-6 + atol 1e-7: the same operations on fp32 scalars that agree to
an ulp (the port computes 1 - beta**count in torch from its device count,
the JAX code in float32 from its step), so only that ulp and XLA's
contraction or reassociation can move a last bit.  The skip flag leaves
params, m, v and the count bit for bit.  The CUDA kernel is held against
the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam import init_state as jax_init_state
from deepspeed_tpu.ops.adam import reference_impl as jax_reference
from deepspeed_tpu.ops.pallas.fused_adam import fused_adam_pallas
from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper, fused_adam,
                                          init_state, reference_impl)
from deepspeed_tpu_torch.runtime.optimizers import FusedAdam, build_optimizer
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-7)
N = 70001          # not a multiple of 128 (nor of the TPU kernel's tile)


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adamw_mode", [True, False])
def test_three_steps_match_jax(adamw_mode, bias_correction):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(N).astype(np.float32)
    grads = [rng.standard_normal(N).astype(np.float32) for _ in range(3)]
    kw = dict(lr=1e-3, weight_decay=0.01, adamw_mode=adamw_mode,
              bias_correction=bias_correction)
    tkw = dict(weight_decay=0.01, adamw_mode=adamw_mode)

    def hyper(st):
        return adam_hyper(st.count, 1e-3, 0.9, 0.999, bias_correction)

    jp, jst = jnp.asarray(p0), jax_init_state(jnp.asarray(p0))
    pp, pst = jnp.asarray(p0), jax_init_state(jnp.asarray(p0))
    tp = torch.as_tensor(p0.copy())
    tst = init_state(tp)
    fp = torch.as_tensor(p0.copy())
    fst = init_state(fp)
    for g in grads:
        jp, jst = jax_reference(jp, jnp.asarray(g), jst, **kw)
        pp, pst = fused_adam_pallas(pp, jnp.asarray(g), pst, interpret=True,
                                    **kw)
        tp, tst = reference_impl(tp, torch.as_tensor(g), tst, hyper(tst),
                                 **tkw)
        fp, fst = fused_adam(fp, torch.as_tensor(g), fst, hyper(fst), **tkw)
    assert int(tst.count) == int(fst.count) == int(jst.step) == 3
    for got, st in ((tp, tst), (fp, fst)):
        for a, b in ((got, jp), (st.m, jst.m), (st.v, jst.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        for a, b in ((got, pp), (st.m, pst.m), (st.v, pst.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the dispatch's CPU path is the plain version, bit for bit
    assert torch.equal(tp, fp) and torch.equal(tst.v, fst.v)


def test_bf16_grads_and_updates_in_place():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal(1000).astype(np.float32)
    g = torch.as_tensor(rng.standard_normal(1000)).to(torch.bfloat16)
    p = torch.as_tensor(p0.copy())
    st = init_state(p)
    ptrs = (p.data_ptr(), st.m.data_ptr(), st.v.data_ptr())
    out, st2 = fused_adam(p, g, st, adam_hyper(st.count, 1e-3, 0.9, 0.999))
    assert out is p
    assert (p.data_ptr(), st2.m.data_ptr(), st2.v.data_ptr()) == ptrs
    want = torch.as_tensor(p0.copy())
    wst = init_state(want)
    reference_impl(want, g.float(), wst,
                   adam_hyper(wst.count, 1e-3, 0.9, 0.999))
    assert torch.equal(p, want)


def test_cuda_backend_refuses_cpu_tensors():
    p = torch.zeros(8)
    st = init_state(p)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam(p, p.clone(), st, adam_hyper(st.count, 1e-3, 0.9, 0.999),
                   backend="cuda")


@pytest.mark.parametrize("name,params,adamw,wd", [
    ("AdamW", {}, True, 0.01),
    ("Adam", {}, True, 0.01),
    ("Adam", {"adam_w_mode": False}, False, 0.0),
    ("FusedAdam", {"adam_w_mode": False, "weight_decay": 0.1}, False, 0.1),
])
def test_build_optimizer_defaults(name, params, adamw, wd):
    opt = build_optimizer(name, params)
    assert isinstance(opt, FusedAdam)
    assert (opt.adamw_mode, opt.weight_decay, opt.lr, opt.betas,
            opt.eps) == (adamw, wd, 1e-3, (0.9, 0.999), 1e-8)
    p = torch.ones(4)
    st = opt.step(p, torch.ones(4), opt.init_state(p))
    assert isinstance(st, AdamState) and int(st.count) == 1


# every other rule of the JAX registry is ported (tests/test_torch_
# optimizers.py; bf16 moments: tests/test_torch_moment_dtype.py); cpuadam,
# once refused naming ROADMAP A12 (``item``), is the device Adam as in the
# JAX registry (its ``adamw_mode`` key, default on), the host Adam being
# ZeRO-Offload's (tests/test_torch_offload.py)
@pytest.mark.parametrize("name,params,item", [
    ("CPUAdam", {}, "A12"), ("cpuadam", {"lr": 1e-3}, "A12"),
])
def test_unported_optimizers_raise(name, params, item):
    opt = build_optimizer(name, params)
    assert isinstance(opt, FusedAdam)
    assert (opt.adamw_mode, opt.weight_decay, opt.lr) == (True, 0.01, 1e-3)
    assert not build_optimizer(name, {"adamw_mode": False}).adamw_mode


def test_unknown_optimizer_is_a_value_error():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        build_optimizer("Adafactor", {})
