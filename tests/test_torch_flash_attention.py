"""Port parity: the flash-attention training path's plain versions.

The port's plain forward ``(O, LSE)`` and plain backward against the JAX
package's ``_flash_fwd`` and ``_flash_bwd_pallas`` run in the Pallas
interpreter (blocks of 64, so S=128 takes two tiles) and against the jnp
``_flash_bwd``; ``FlashAttentionFunction`` gradients against ``jax.grad``
through ``flash_attention(..., interpret=True)``; a sequence length that
does not tile against ``reference_attention``.  The biased variants (ALiBi
slopes, sliding windows 32 / 100 / 0, both together, with GQA) the same
way, at S = 128 and 256, plus ``alibi_window_bias`` against the JAX one.
The plain forward and backward, biased or not, run at head dims 32, 64,
80, 96 and 256 (the flash kernels' D=64, D=80, D=96 and D=256 forms
compute what these do; 80 and 96 are gpt_2_7b's and gpt_760m's, 256
Gemma's), and at 256 with Gemma-2B's 8 query heads over one kv head, whose
dK and dV sum a group of 8.  fp32 inputs
from numpy; rtol = atol = 1e-5 (forward) and 1e-4
(gradients): the same arithmetic, summed in other orders.  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes as jax_slopes
from deepspeed_tpu.ops.attention import alibi_window_bias as jax_bias
from deepspeed_tpu.ops.attention import reference_attention as jax_reference
from deepspeed_tpu.ops.pallas.flash_attention import (_flash_bwd,
                                                      _flash_bwd_pallas,
                                                      _flash_fwd)
from deepspeed_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops.attention import (alibi_window_bias, attention,
                                               reference_attention)
from deepspeed_tpu_torch.ops.cuda import flash_attention as flash_cuda
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_fwd_plain)
from torch_threads import _one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, D, BLOCK = 2, 128, 32, 64
HEADS = {"mha": (4, 4), "gqa": (4, 2)}
HEAD_DIMS = (32, 64, 80, 96, 256)


def _inputs(H, Hkv, S=S, seed=0, D=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", list(HEADS))
def test_plain_forward_and_backward_match_pallas(heads, causal, head_dim):
    H, Hkv = HEADS[heads]
    q, k, v, g = _inputs(H, Hkv, D=head_dim)
    scale = 1.0 / math.sqrt(head_dim)
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


@pytest.mark.parametrize("H", [8, 16])
def test_plain_mqa_group_of_8_at_head_dim_256_matches_pallas(H):
    """Gemma-2B's heads: 8 query heads of 256 over one kv head (MQA), and
    a group of 16 (two query heads a block of the dK/dV kernel's cluster
    of 8).  The plain backward's dK and dV, summed over the group, against
    ``_flash_bwd_pallas`` in interpret mode, which sums the same group."""
    Hkv, D = 1, 256
    q, k, v, g = _inputs(H, Hkv, D=D, seed=6 if H == 8 else 16)
    scale = 1.0 / math.sqrt(D)
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale, True, BLOCK, BLOCK, interpret=True)
    to, tlse = flash_attention_fwd_plain(*_t(q, k, v), scale, True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)
    res = tuple(jnp.asarray(x) for x in (q, k, v, np.asarray(jo),
                                         np.asarray(jlse)))
    pallas = _flash_bwd_pallas(scale, True, res, jnp.asarray(g), BLOCK,
                               BLOCK, interpret=True)
    got = flash_attention_bwd_plain(*_t(q, k, v, np.asarray(jo),
                                        np.asarray(jlse), g), scale, True)
    assert got[1].shape == (B, S, Hkv, D) == np.asarray(pallas[1]).shape
    for name, a, b in zip("qkv", got, pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name} vs pallas", **BWD_TOL)


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


# biased cases: (heads, S, ALiBi, window); window 0 is "unlimited" (the
# port then takes the unbiased path, the JAX entry its biased kernel)
BIASED = {
    "alibi": ("mha", 128, True, None),
    "window32": ("mha", 128, False, 32),
    "window100_s256": ("mha", 256, False, 100),
    "window0": ("mha", 128, False, 0),
    "alibi_window100_s256": ("mha", 256, True, 100),
    "gqa_alibi_window32": ("gqa", 128, True, 32),
}


def _bias(heads, alibi, window):
    H = HEADS[heads][0]
    slopes = np.array(jax_slopes(H)) if alibi else None
    return slopes, window


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("case", list(BIASED))
def test_plain_biased_forward_and_backward_match_pallas(case, head_dim):
    heads, S_, alibi, window = BIASED[case]
    H, Hkv = HEADS[heads]
    q, k, v, g = _inputs(H, Hkv, S=S_, seed=3, D=head_dim)
    slopes, window = _bias(heads, alibi, window)
    scale = 1.0 / math.sqrt(head_dim)
    jkw = dict(alibi_slopes=None if slopes is None else jnp.asarray(slopes),
               window=None if window is None else jnp.int32(window))
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale, True, BLOCK, BLOCK, interpret=True, **jkw)
    tkw = dict(alibi_slopes=None if slopes is None
               else torch.as_tensor(slopes), window=window)
    to, tlse = flash_attention_fwd_plain(*_t(q, k, v), scale, True, **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)

    res = tuple(jnp.asarray(x) for x in (q, k, v, np.asarray(jo),
                                         np.asarray(jlse)))
    pallas = _flash_bwd_pallas(scale, True, res, jnp.asarray(g), BLOCK,
                               BLOCK, interpret=True, **jkw)
    got = flash_attention_bwd_plain(*_t(q, k, v, np.asarray(jo),
                                        np.asarray(jlse), g), scale, True,
                                    **tkw)
    for name, a, b in zip("qkv", got, pallas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name} vs pallas", **BWD_TOL)


@pytest.mark.parametrize("case", ["alibi", "window100_s256",
                                  "gqa_alibi_window32"])
def test_biased_autograd_function_matches_jax_grad(case):
    """The JAX entry's gradient (custom VJP over the biased Pallas kernels,
    slopes constant) against ``FlashAttentionFunction``'s; the forward
    against ``reference_attention`` with ``alibi_window_bias`` in both
    packages."""
    heads, S_, alibi, window = BIASED[case]
    H, Hkv = HEADS[heads]
    q, k, v, g = _inputs(H, Hkv, S=S_, seed=4)
    slopes, window = _bias(heads, alibi, window)

    def jloss(q, k, v):
        out = jax_flash_attention(
            q, k, v, causal=True, block_q=BLOCK, block_k=BLOCK,
            interpret=True, window=window,
            alibi_slopes=None if slopes is None else jnp.asarray(slopes))
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = attention(tq, tk, tv, causal=True, window=window,
                    alibi_slopes=None if slopes is None else slopes.tolist())
    tgrads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g))
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name}", **BWD_TOL)
    jref = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, bias=jax_bias(S_, S_, slopes, window))
    with torch.no_grad():
        tref = reference_attention(
            *_t(q, k, v), causal=True,
            bias=alibi_window_bias(S_, S_, slopes, window))
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), **FWD_TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jref),
                               **FWD_TOL)


@pytest.mark.parametrize("Sq,window", [(16, 5), (1, 0), (4, None)])
def test_alibi_window_bias_matches_jax(Sq, window):
    """The bias the JAX reference path materialises, decode-aligned when
    the query rows are fewer than the keys."""
    slopes = np.array(jax_slopes(6))
    got = alibi_window_bias(Sq, 16, slopes, window)
    want = jax_bias(Sq, 16, slopes, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert alibi_window_bias(Sq, 16) is None


@pytest.mark.parametrize("n_heads", [16, 12, 1])
def test_alibi_slopes_match_jax(n_heads):
    np.testing.assert_array_equal(alibi_slopes(n_heads).numpy(),
                                  np.asarray(jax_slopes(n_heads)))
    if n_heads == 16:     # BLOOM's 16 heads: 2^-0.5 ... 2^-8
        np.testing.assert_array_equal(alibi_slopes(16).numpy(),
                                      (2.0 ** -(0.5 * np.arange(1, 17)))
                                      .astype(np.float32))


def test_biased_attention_raises():
    """Logit softcaps are the one attention switch still unported; ALiBi
    and windows now run (tests above)."""
    q, k, v, _ = _t(*_inputs(4, 4, S=16))
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        attention(q, k, v, logit_softcap=30.0)


def test_backend_names():
    q, k, v, _ = _t(*_inputs(4, 4, S=16))
    with pytest.raises(ValueError, match="JAX package's spelling"):
        attention(q, k, v, backend="pallas")
    # "plain" is the CPU path "auto" takes
    torch.testing.assert_close(attention(q, k, v, backend="plain"),
                               attention(q, k, v))


@pytest.mark.parametrize("wrapper", [
    "flash_attention_fwd_cuda", "flash_attention_fwd_biased_cuda",
    "flash_attention_bwd_dq_cuda", "flash_attention_bwd_dq_biased_cuda",
    "flash_attention_bwd_dkv_cuda", "flash_attention_bwd_dkv_biased_cuda"])
def test_flash_wrappers_refuse_head_dim_64(wrapper):
    """The flash kernels are built for head dims 64, 80, 96, 128 and 256
    (64, then 80 and 96, then Gemma's 256, were the ones this test saw
    refused before their forms were ported); every other head dim -- an
    odd 48 -- is refused before anything else, naming ROADMAP A16, and
    launches nothing."""
    assert flash_cuda.FLASH_HEAD_DIMS == (64, 80, 96, 128, 256)
    fn = getattr(flash_cuda, wrapper)
    before = fn.launches
    for head_dim in (48,):
        q = torch.zeros(1, 64, 4, head_dim)
        k = torch.zeros(1, 64, 2, head_dim)
        lse = torch.zeros(1, 4, 64)
        fwd = "fwd" in wrapper
        args = (q, k, k, 0.125) if fwd else (q, k, k, q, lse, lse, 0.125)
        with pytest.raises(NotImplementedError,
                           match=f"head_dim {head_dim} not in .*ROADMAP A16"):
            fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("head_dim", [64, 80, 96, 256])
@pytest.mark.parametrize("wrapper", [
    "flash_attention_fwd_cuda", "flash_attention_bwd_dq_cuda",
    "flash_attention_bwd_dkv_cuda"])
def test_flash_wrappers_take_head_dim_64_to_the_device_check(wrapper,
                                                             head_dim):
    """Head dims 64, 80, 96 and 256 pass the head-dim check: a CPU tensor
    is then refused only for its device (the kernels run on the card)."""
    q = torch.zeros(1, 64, 4, head_dim)
    k = torch.zeros(1, 64, 2, head_dim)
    lse = torch.zeros(1, 4, 64)
    args = ((q, k, k, 0.125) if "fwd" in wrapper
            else (q, k, k, q, lse, lse, 0.125))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        getattr(flash_cuda, wrapper)(*args)
