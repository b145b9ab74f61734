"""Port parity: the flash-attention training path's plain versions.

The port's plain forward ``(O, LSE)`` and plain backward against the JAX
package's ``_flash_fwd`` and ``_flash_bwd_pallas`` run in the Pallas
interpreter (blocks of 64, so S=128 takes two tiles) and against the jnp
``_flash_bwd``; ``FlashAttentionFunction`` gradients against ``jax.grad``
through ``flash_attention(..., interpret=True)``; a sequence length that
does not tile against ``reference_attention``.  fp32 inputs from numpy;
rtol = atol = 1e-5 (forward) and 1e-4 (gradients): the same arithmetic,
summed in other orders.  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import reference_attention as jax_reference
from deepspeed_tpu.ops.pallas.flash_attention import (_flash_bwd,
                                                      _flash_bwd_pallas,
                                                      _flash_fwd)
from deepspeed_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.attention import attention, reference_attention
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, D, BLOCK = 2, 128, 32, 64
HEADS = {"mha": (4, 4), "gqa": (4, 2)}


def _inputs(H, Hkv, S=S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", list(HEADS))
def test_plain_forward_and_backward_match_pallas(heads, causal):
    H, Hkv = HEADS[heads]
    q, k, v, g = _inputs(H, Hkv)
    scale = 1.0 / math.sqrt(D)
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale, causal, BLOCK, BLOCK, interpret=True)
    to, tlse = flash_attention_fwd_plain(*_t(q, k, v), scale, causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)

    # backward from the same saved (q, k, v, O, LSE) and cotangent
    res = tuple(jnp.asarray(x) for x in (q, k, v, np.asarray(jo),
                                         np.asarray(jlse)))
    pallas = _flash_bwd_pallas(scale, causal, res, jnp.asarray(g), BLOCK,
                               BLOCK, interpret=True)
    dense = _flash_bwd(scale, causal, res, jnp.asarray(g))
    got = flash_attention_bwd_plain(*_t(q, k, v, np.asarray(jo),
                                        np.asarray(jlse), g), scale, causal)
    for name, a, b, c in zip("qkv", got, pallas, dense):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name} vs pallas", **BWD_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c),
                                   err_msg=f"d{name} vs _flash_bwd",
                                   **BWD_TOL)


@pytest.mark.parametrize("heads", list(HEADS))
def test_autograd_function_matches_jax_grad(heads):
    H, Hkv = HEADS[heads]
    q, k, v, g = _inputs(H, Hkv, seed=1)

    def jloss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=True, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = flash_attention(tq, tk, tv, causal=True)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g))
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name}", **BWD_TOL)


def test_non_tiling_length_matches_reference():
    """S=100 does not tile 64-row blocks: the JAX entry sends it to the
    reference; the port's flash path takes it itself."""
    q, k, v, g = _inputs(4, 2, S=100, seed=2)

    def jloss(q, k, v):
        return jnp.sum(jax_reference(q, k, v, causal=True) * jnp.asarray(g))

    jout = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **FWD_TOL)
    with torch.no_grad():
        ref = reference_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jout), **FWD_TOL)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g))
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name}", **BWD_TOL)


@pytest.mark.parametrize("kw", [{"alibi_slopes": [0.5] * 4},
                                {"window": 16}, {"logit_softcap": 30.0}])
def test_biased_attention_raises(kw):
    q, k, v, _ = _t(*_inputs(4, 4, S=16))
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        attention(q, k, v, **kw)
    if "logit_softcap" not in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP A16"):
            flash_attention(q, k, v, **kw)


def test_backend_names():
    q, k, v, _ = _t(*_inputs(4, 4, S=16))
    with pytest.raises(ValueError, match="JAX package's spelling"):
        attention(q, k, v, backend="pallas")
    # "plain" is the CPU path "auto" takes
    torch.testing.assert_close(attention(q, k, v, backend="plain"),
                               attention(q, k, v))
