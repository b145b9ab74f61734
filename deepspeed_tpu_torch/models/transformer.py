"""Causal transformer LM -- the serving and training paths' model, in
PyTorch.

Counterpart of ``deepspeed_tpu/models/transformer.py`` (dense subset).
``TransformerConfig`` is a copy of the JAX package's, every field and
preset included, so ``llama2_7b()`` and ``tiny()`` mean the same thing in
both packages.  ``CausalTransformerLM`` is an ``nn.Module`` whose
parameters carry the JAX param-tree names (``tok_embed``,
``layers.<i>.wq``, ...) and keep its ``[in, out]`` weight orientation, so
``h @ w`` is the same product in both packages.

Ported: RoPE (full, partial ``rope_dim``, or a scaled ``rope_inv_freq``
table) or learned positions; RMSNorm or LayerNorm (with or without bias);
SwiGLU / GLU or plain MLPs over the activation table (GeGLU: Gemma); linear
biases; GQA; an explicit head dim (``head_dim_override``, H * dh != d);
the embedding scale (``embed_scale``, Gemma's sqrt(d) on the input side);
tied or untied heads with an optional head bias; ``attn_scale``; and, on
the training path only, ALiBi (BLOOM: no position table), per-layer
sliding windows (``local_attn_pattern``, GPT-Neo) and the LayerNorm after
the embedding (``embed_norm``).  The serving paths raise for those three
(ROADMAP A18: the JAX package decodes them with a materialised bias).  The
other architecture switches (softcaps, qk-norm, clip_qkv, parallel blocks,
sandwich / post norms, residual scale, logit scale, MoE)
raise ``NotImplementedError`` naming ROADMAP A16 / A14.

Two paths use it: serving (``apply_with_cache``, ``apply_with_paged_cache``,
under ``torch.no_grad``) and training (``apply``, ``loss``: causal flash
attention through ``ops/attention.attention`` -- with ALiBi slopes and the
layer's window, the biased kernels -- per-layer remat with
``torch.utils.checkpoint`` under ``remat_policy``, the next-token cross-entropy chunked so no
[B, S, V] fp32 logits tensor is kept).

Numerics follow the JAX model: norms compute in fp32 and cast back, RoPE
promotes a bf16 input to fp32 before casting back, and the logits are a
matmul in the activation dtype cast to fp32.
"""

import math
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.ops.attention import attention
from deepspeed_tpu_torch.ops.cuda.decode_attention import \
    HEAD_DIMS as SERVE_HEAD_DIMS
from deepspeed_tpu_torch.ops.cuda.flash_attention import (FLASH_HEAD_DIMS,
                                                          check_head_dim)
from deepspeed_tpu_torch.ops.decode_attention import (KVCache,
                                                      decode_attention,
                                                      update_cache)
from deepspeed_tpu_torch.ops.paged_attention import (PagedKVCache,
                                                     paged_decode_attention,
                                                     prefill_paged)
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import POLICIES, SAVE_NOTHING, matmul, remat


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None        # None → MHA
    ffn_hidden_size: Optional[int] = None   # None → 4x (gelu) or 8/3x (swiglu)
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    activation: str = "silu"    # "silu" (SwiGLU) | "gelu" (tanh approx)
                                # | "gelu_exact" (erf, MPT) | "relu"
    gated_mlp: Optional[bool] = None   # None → gated iff silu; True forces
                                       # a GLU (Gemma GeGLU)
    head_dim_override: Optional[int] = None  # H*dh != d (Gemma-7b)
    embed_scale: Optional[float] = None      # input embeds × scale (Gemma
                                             # sqrt(d); tied head unscaled)
    use_rmsnorm: bool = True
    use_rope: bool = True                   # False → learned positions (GPT-2)
    rope_dim: Optional[int] = None          # partial rotary (GPT-NeoX); None → full
    rope_inv_freq: Optional[Tuple[float, ...]] = None  # scaled inverse
    #   frequencies (Llama-3 / linear rope scaling), length rotary_dim//2
    #   (= the ROTATED slice's half-dim when rope_dim is set)
    use_bias: bool = False                  # linear biases (GPT-2/OPT families)
    norm_bias: bool = False                 # LayerNorm beta (GPT-2/OPT)
    use_alibi: bool = False                 # ALiBi slopes, no positions (Bloom)
    embed_norm: bool = False                # LayerNorm after embedding (Bloom)
    parallel_block: bool = False            # x + attn(ln(x)) + mlp(ln'(x))
    #                                         (GPT-J / parallel-residual NeoX)
    lm_head_bias: bool = False              # bias on the LM head (GPT-J)
    attn_scale: Optional[float] = None      # softmax scale override (GPT-Neo
    #                                         uses 1.0 instead of 1/sqrt(dh))
    local_attn_pattern: Optional[Tuple[int, ...]] = None  # per-layer sliding
    #                window (0 = global); GPT-Neo alternates (0, 256, 0, ...)
    residual_scale: Optional[float] = None  # x + scale*delta on every
    #   sub-block residual add (Granite residual_multiplier)
    post_norm_only: bool = False            # OLMo2: no pre-norms; blocks
    #   are x + post_norm(sublayer(x)) (sandwich keys only)
    qk_norm: Optional[str] = None           # "rms" | "layernorm": per-head
    #   q/k normalization over head_dim before rope (Qwen3 / qk-norm
    #   lineages); "rms_flat": RMS over the whole flat projection
    #   (OLMo2).  Weights ride presence-based layer keys q_norm/k_norm
    clip_qkv: Optional[float] = None        # clamp q/k/v projections to
    #   [-clip, clip] pre-rope (OLMo / MPT-30b / DBRX lineage)
    attn_logit_softcap: Optional[float] = None   # tanh-cap raw attention
    #                scores (Gemma-2); runs the XLA attention path
    final_logit_softcap: Optional[float] = None  # tanh-cap LM-head logits
    final_logit_scale: Optional[float] = None    # multiply LM-head logits
    #   (Cohere logit_scale); applied before any softcap
    tie_embeddings: bool = False
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    attn_impl: str = "auto"
    # ring attention token layout: "zigzag" balances the causal triangle
    # across sp devices (~2x step time at large sp); needs S % (2*sp) == 0
    ring_layout: str = "contiguous"
    # Pallas flash-attention tile sizes (tunable per chip generation)
    attn_block_q: int = 512
    attn_block_k: int = 512
    # training loss: stream logits in chunks of this many tokens under a
    # remat'd scan so the full fp32 [B,S,V] tensor never hits HBM (the
    # logits buffer, not the model states, caps the trainable micro-batch
    # at large vocab).  0 = materialize full logits.  Per-token softmax is
    # independent of the chunking, so numerics match the dense path up to
    # fp reassociation of the final mean.
    loss_chunk_size: int = 4096
    # MoE (0 experts = dense; reference deepspeed/moe):
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.0
    moe_min_capacity: int = 4
    moe_layer_freq: int = 1        # every Nth layer is MoE
    moe_aux_loss_coef: float = 0.01
    moe_noisy_gate_policy: Optional[str] = None
    moe_norm_topk_prob: bool = True  # renormalize the k gate values
    #   (Mixtral / Qwen2-MoE norm_topk_prob); False keeps softmax mass
    moe_eval_capacity_factor: Optional[float] = None  # None → capacity_factor

    @property
    def is_moe(self):
        return self.moe_num_experts > 1

    @property
    def kv_heads(self):
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self):
        return self.head_dim_override or self.hidden_size // self.n_heads

    @property
    def gated(self):
        """Gated (GLU) MLP: explicit flag, else implied by SwiGLU."""
        if self.gated_mlp is not None:
            return self.gated_mlp
        return self.activation == "silu"

    @property
    def ffn_dim(self):
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        if self.activation == "silu":
            d = int(8 * self.hidden_size / 3)
            return 256 * ((d + 255) // 256)
        return 4 * self.hidden_size

    @property
    def rotary_dim(self):
        return self.rope_dim or self.head_dim

    # ---- presets -----------------------------------------------------
    @staticmethod
    def tiny(**kw):
        base = TransformerConfig(
            vocab_size=256, hidden_size=64, n_layers=2, n_heads=4,
            max_seq_len=128, remat=False)
        return replace(base, **kw)

    @staticmethod
    def gpt2_125m(**kw):
        base = TransformerConfig(
            vocab_size=50304, hidden_size=768, n_layers=12, n_heads=12,
            max_seq_len=1024, activation="gelu", use_rmsnorm=False,
            use_rope=False, tie_embeddings=True)
        return replace(base, **kw)

    @staticmethod
    def gpt2_1_5b(**kw):
        base = TransformerConfig(
            vocab_size=50304, hidden_size=1600, n_layers=48, n_heads=25,
            max_seq_len=1024, activation="gelu", use_rmsnorm=False,
            use_rope=False, tie_embeddings=True)
        return replace(base, **kw)

    @staticmethod
    def moe_tiny(**kw):
        base = TransformerConfig.tiny(moe_num_experts=4, moe_top_k=1)
        return replace(base, **kw)

    @staticmethod
    def llama2_7b(**kw):
        base = TransformerConfig(
            vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32,
            max_seq_len=4096, ffn_hidden_size=11008)
        return replace(base, **kw)

    @staticmethod
    def llama2_70b(**kw):
        base = TransformerConfig(
            vocab_size=32000, hidden_size=8192, n_layers=80, n_heads=64,
            n_kv_heads=8, max_seq_len=4096, ffn_hidden_size=28672)
        return replace(base, **kw)

    def num_params(self) -> int:
        d, f, v = self.hidden_size, self.ffn_dim, self.vocab_size
        dh = self.head_dim
        per_layer = (d * self.n_heads * dh + 2 * d * self.kv_heads * dh +
                     self.n_heads * dh * d)
        per_layer += (3 if self.gated else 2) * d * f
        per_layer += 2 * d  # norms
        total = self.n_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            total += v * d
            if self.lm_head_bias:
                total += v
        if not self.use_rope and not self.use_alibi:
            total += self.max_seq_len * d
        if self.embed_norm:
            total += d
        return total



# "gelu" is the tanh approximation (GPT-2 gelu_new); "gelu_exact" the erf
# form -- the JAX package's table, entry for entry.
_ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
}

# switches the port does not take, with the ROADMAP item that ports them
_UNSUPPORTED = (
    ("attn_logit_softcap", "attention logit softcap", "A16"),
    ("final_logit_softcap", "final logit softcap", "A16"),
    ("final_logit_scale", "final logit scale", "A16"),
    ("qk_norm", "qk-norm", "A16"),
    ("clip_qkv", "clip_qkv", "A16"),
    ("parallel_block", "parallel blocks", "A16"),
    ("post_norm_only", "post-norm blocks", "A16"),
    ("residual_scale", "residual scale", "A16"),
    ("is_moe", "MoE layers", "A14"),
)
# switches the training path takes and the serving paths do not
_NOT_SERVED = (
    ("use_alibi", "ALiBi"),
    ("local_attn_pattern", "local attention windows"),
    ("embed_norm", "embedding norm"),
)


def check_supported(c: TransformerConfig):
    """Raise ``NotImplementedError`` for a configuration the port does not
    take, naming the ROADMAP item that ports it."""
    for attr, what, item in _UNSUPPORTED:
        if getattr(c, attr):
            raise NotImplementedError(
                f"{what} ({attr}) is not ported yet (ROADMAP {item})")
    if c.activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {c.activation!r}")
    if c.local_attn_pattern and len(c.local_attn_pattern) != c.n_layers:
        raise ValueError(f"local_attn_pattern has "
                         f"{len(c.local_attn_pattern)} windows for "
                         f"{c.n_layers} layers")


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def check_servable(c: TransformerConfig, device=None):
    """Raise ``NotImplementedError`` for a configuration the serving paths
    (contiguous and paged KV caches) do not decode: ALiBi, local windows
    and the embedding norm train, but decoding them waits for ROADMAP
    A18.  On the card (``device`` a CUDA device) the head dim must be one
    the serving kernels (B4, B5) take -- 16, 64, 80, 96, 128 or 256 --
    else it raises naming A16; on the CPU the plain versions take every
    head dim."""
    for attr, what in _NOT_SERVED:
        if getattr(c, attr):
            raise NotImplementedError(
                f"decoding a model with {what} ({attr}) is not ported yet "
                f"(ROADMAP A18); the training path takes it")
    if _on_card(device):
        check_head_dim("serving on the card", c.head_dim, SERVE_HEAD_DIMS)


def check_trainable(c: TransformerConfig, device=None):
    """On the card, raise ``NotImplementedError`` naming A16 for a head dim
    the flash kernels (B1, B2) do not take -- they take 64, 80, 96, 128 and
    256; serving takes 16 too (:func:`check_servable`), training at 16
    waits for A16 -- on the CPU the plain versions train every head
    dim."""
    if _on_card(device):
        check_head_dim("training on the card", c.head_dim, FLASH_HEAD_DIMS)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes, fp32 [n_heads] on the CPU -- the JAX
    package's ``alibi_slopes`` (HF ``build_alibi_tensor``): geometric
    slopes for the largest power-of-two head count, interleaved extras
    beyond.  16 heads: 2^-0.5 ... 2^-8."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    n = 2 ** math.floor(math.log2(n_heads))
    slopes = pow2_slopes(n)
    if n < n_heads:
        slopes += pow2_slopes(2 * n)[0::2][: n_heads - n]
    return torch.tensor(slopes, dtype=torch.float32)


def _norm(x, weight, eps, use_rms, bias=None):
    xf = x.float()
    if use_rms:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _unpack_batch(batch):
    """(input_ids, labels, loss_mask) of a dict batch or a raw [B, S]
    tensor."""
    if isinstance(batch, dict):
        return batch["input_ids"], batch.get("labels"), batch.get("loss_mask")
    return batch, None, None


def next_token_xent(logits, batch):
    """Next-token cross-entropy.  ``batch``: dict with ``input_ids`` [B, S]
    (+ optional ``labels``, ``loss_mask``) or a raw [B, S] tensor.  When
    ``labels`` is absent the labels are the inputs shifted left and the
    last logit is dropped."""
    input_ids, labels, loss_mask = _unpack_batch(batch)
    if labels is None:
        labels = input_ids[:, 1:]
        logits = logits[:, :-1]
        if loss_mask is not None:
            loss_mask = loss_mask[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if loss_mask is not None:
        mask = loss_mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def _chunk_nll(xc, yc, mc, head, bias):
    """Masked NLL sum of one chunk of tokens: [n, d] hidden x [d, V] head
    -> fp32 logits, alive only inside this call."""
    logits = (xc @ head).float()
    if bias is not None:
        logits = logits + bias
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yc[:, None])[:, 0]
    return torch.sum((lse - ll) * mc)


def chunked_next_token_xent(x, head, head_b, batch, chunk_size: int):
    """Next-token cross-entropy WITHOUT keeping the full fp32 [B, S, V]
    logits: the flattened tokens go through ``chunk_size``-token chunks,
    each under ``torch.utils.checkpoint``, so a chunk's [chunk, V] logits
    exist only while it is computed (and again in the backward).  Equal
    to :func:`next_token_xent` up to fp reassociation of the mean.

    ``x``: final-normed hidden [B, S, d]; ``head``: [d, V]; ``head_b``:
    [V] or None; ``batch`` as in :func:`next_token_xent`."""
    input_ids, labels, loss_mask = _unpack_batch(batch)
    if labels is None:
        labels = input_ids[:, 1:]
        x = x[:, :-1]
        if loss_mask is not None:
            loss_mask = loss_mask[:, 1:]
    B, S, d = x.shape
    n = B * S
    xt = x.reshape(n, d)
    yt = labels.reshape(n).long()
    mt = (torch.ones(n, dtype=torch.float32, device=x.device)
          if loss_mask is None else loss_mask.reshape(n).float())
    chunk = max(1, min(int(chunk_size), n))
    head_c = head.to(x.dtype)
    bias32 = None if head_b is None else head_b.float()
    nll_sum = 0.0
    for lo in range(0, n, chunk):
        sl = slice(lo, lo + chunk)
        nll_sum = nll_sum + checkpoint(_chunk_nll, xt[sl], yt[sl], mt[sl],
                                       head_c, bias32, use_reentrant=False)
    return nll_sum / torch.clamp(torch.sum(mt), min=1.0)


def _rope(x, positions, theta, rope_dim=None, inv_freq=None):
    """Rotary embedding; x: [B, S, H, D], positions: [B, S].  ``rope_dim``
    < D rotates only the leading dims; ``inv_freq`` overrides the theta
    power law.  A bf16 x meets fp32 cos/sin, so the rotation runs in fp32
    before the cast back, as in the JAX model."""
    if rope_dim is not None and rope_dim < x.shape[-1]:
        rot, rest = x[..., :rope_dim], x[..., rope_dim:]
        return torch.cat([_rope(rot, positions, theta, inv_freq=inv_freq),
                          rest], dim=-1)
    half = x.shape[-1] // 2
    if inv_freq is not None:
        freqs = torch.as_tensor(inv_freq, dtype=torch.float32,
                                device=x.device)
        if freqs.shape != (half,):
            raise ValueError(f"rope_inv_freq must cover the rotated slice: "
                             f"expected length {half}, got "
                             f"{tuple(freqs.shape)}")
    else:
        freqs = torch.exp(-math.log(theta) * torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _proj(h, layer, name):
    out = matmul(h, getattr(layer, name))
    bias = getattr(layer, f"{name}_b", None)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


class TransformerBlock(nn.Module):
    """One layer's parameters, named as the JAX layer dict's keys."""

    def __init__(self, c: TransformerConfig, device, dtype):
        super().__init__()
        d, f, dh = c.hidden_size, c.ffn_dim, c.head_dim
        H, Hkv = c.n_heads, c.kv_heads

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        self.attn_norm = p(d)
        self.wq = p(d, H * dh)
        self.wk = p(d, Hkv * dh)
        self.wv = p(d, Hkv * dh)
        self.wo = p(H * dh, d)
        self.mlp_norm = p(d)
        self.w_up = p(d, f)
        self.w_down = p(f, d)
        if c.gated:
            self.w_gate = p(d, f)
        if c.use_bias:
            for name, width in (("wq_b", H * dh), ("wk_b", Hkv * dh),
                                ("wv_b", Hkv * dh), ("wo_b", d),
                                ("w_up_b", f), ("w_down_b", d)):
                setattr(self, name, p(width))
        if c.norm_bias:
            self.attn_norm_b = p(d)
            self.mlp_norm_b = p(d)


class CausalTransformerLM(nn.Module):
    """Decoder-only LM: ``init`` fills the parameters; ``apply`` and
    ``loss`` are the training forward; ``apply_with_cache`` (contiguous KV
    cache) and ``apply_with_paged_cache`` (paged KV cache) run prefill or
    decode and update their caches IN PLACE.

    ``device``: where the parameters live -- the card unless the caller
    names another device (``"cpu"`` in the tests, ``"meta"`` to count
    parameters without memory); with no card and no device it raises."""

    def __init__(self, config: TransformerConfig, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(config)
        self.config = c = config
        device = get_accelerator().resolve_device(device)
        d, v = c.hidden_size, c.vocab_size

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        self.tok_embed = p(v, d)
        self.final_norm = p(d)
        if c.norm_bias:
            self.final_norm_b = p(d)
        if c.embed_norm:
            self.embed_norm = p(d)
            if c.norm_bias:
                self.embed_norm_b = p(d)
        if not c.use_rope and not c.use_alibi:
            self.pos_embed = p(c.max_seq_len, d)
        if not c.tie_embeddings:
            self.lm_head = p(d, v)
            if c.lm_head_bias:
                self.lm_head_b = p(v)
        self.layers = nn.ModuleList(
            [TransformerBlock(c, device, dtype) for _ in range(c.n_layers)])
        self._slopes = {}       # device -> ALiBi slopes, made once

    @property
    def device(self):
        return self.tok_embed.device

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0):
        """Random weights from a seeded ``torch.Generator`` on the
        parameters' device, with the JAX model's distributions (matrices
        normal / sqrt(fan_in) drawn in fp32, norm weights 1, biases 0) --
        not its bits.  Returns self."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for name, prm in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_b"):
                prm.zero_()
            elif "norm" in leaf:
                prm.fill_(1.0)
            else:
                fan_in = prm.shape[1] if leaf in ("tok_embed",
                                                  "pos_embed") \
                    else prm.shape[0]
                prm.copy_(torch.randn(prm.shape, generator=g,
                                      device=self.device,
                                      dtype=torch.float32)
                          / math.sqrt(fan_in))
        return self

    # ------------------------------------------------------------------
    def _qkv(self, h, layer, B, S, positions):
        c = self.config
        H, Hkv, dh = c.n_heads, c.kv_heads, c.head_dim
        q = _proj(h, layer, "wq").reshape(B, S, H, dh)
        k = _proj(h, layer, "wk").reshape(B, S, Hkv, dh)
        v = _proj(h, layer, "wv").reshape(B, S, Hkv, dh)
        if c.use_rope:
            q = _rope(q, positions, c.rope_theta, c.rope_dim,
                      inv_freq=c.rope_inv_freq)
            k = _rope(k, positions, c.rope_theta, c.rope_dim,
                      inv_freq=c.rope_inv_freq)
        return q.contiguous(), k, v

    def _mlp(self, x, layer):
        c = self.config
        h = _norm(x, layer.mlp_norm, c.norm_eps, c.use_rmsnorm,
                  getattr(layer, "mlp_norm_b", None))
        act = _ACTIVATIONS[c.activation]
        if c.gated:
            inner = act(matmul(h, layer.w_gate)) * _proj(h, layer, "w_up")
        else:
            inner = act(_proj(h, layer, "w_up"))
        return x + _proj(inner, layer, "w_down")

    def _embed(self, input_ids, positions):
        c = self.config
        x = self.tok_embed[input_ids]
        if c.embed_scale is not None:
            # Gemma: sqrt(d) rounded to the activation dtype first (55.5 in
            # bf16 at d = 3072), on the input side only -- the tied head
            # reads the unscaled table
            x = x * torch.tensor(c.embed_scale, dtype=x.dtype)
        if not c.use_rope and not c.use_alibi:
            x = x + self.pos_embed[positions].to(x.dtype)
        if c.embed_norm:
            x = _norm(x, self.embed_norm, c.norm_eps, c.use_rmsnorm,
                      getattr(self, "embed_norm_b", None))
        return x

    def _alibi_slopes(self, device):
        """The model's ALiBi slopes on ``device`` (None without ALiBi)."""
        if not self.config.use_alibi:
            return None
        if device not in self._slopes:
            self._slopes[device] = alibi_slopes(self.config.n_heads).to(
                device)
        return self._slopes[device]

    def _final_norm(self, x):
        c = self.config
        return _norm(x, self.final_norm, c.norm_eps, c.use_rmsnorm,
                     getattr(self, "final_norm_b", None))

    def _head(self):
        return self.tok_embed.T if self.config.tie_embeddings \
            else self.lm_head

    def _logits(self, x):
        x = self._final_norm(x)
        logits = (x @ self._head().to(x.dtype)).float()
        bias = getattr(self, "lm_head_b", None)
        if bias is not None:
            logits = logits + bias.float()
        return logits

    def _layer(self, x, layer, positions, attend):
        """One block: ``attend(q, k, v)`` appends k/v to the layer's cache
        and returns the attention output [B, T, H, D]."""
        c = self.config
        B, T, _ = x.shape
        h = _norm(x, layer.attn_norm, c.norm_eps, c.use_rmsnorm,
                  getattr(layer, "attn_norm_b", None))
        q, k, v = self._qkv(h, layer, B, T, positions)
        attn = attend(q, k, v)
        x = x + _proj(attn.reshape(B, T, c.n_heads * c.head_dim), layer,
                      "wo")
        return self._mlp(x, layer)

    # ------------------------------------------------------------------
    # training forward (DeepSpeedEngine)
    # ------------------------------------------------------------------
    def _train_layer(self, x, layer, positions, attn_backend, window):
        """One training block.  ``window``: the layer's sliding window from
        ``local_attn_pattern`` (0 = global) or None; with ALiBi slopes or a
        window > 0 the attention is the biased flash kernels'."""
        c = self.config
        slopes = self._alibi_slopes(x.device)
        return self._layer(x, layer, positions, lambda q, k, v: attention(
            q, k, v, causal=True, softmax_scale=c.attn_scale,
            backend=attn_backend, alibi_slopes=slopes, window=window))

    def apply(self, input_ids, positions=None, return_hidden=False,
              attn_backend="auto"):
        """Full-sequence causal forward.  Returns fp32 logits [B, S, V], or
        with ``return_hidden`` the final-normed hidden state [B, S, d]
        (the JAX ``apply`` returns ``(x, aux)`` there; aux is the MoE loss,
        0 for the dense model).  With ``config.remat`` and grad enabled,
        each layer runs under the non-reentrant ``torch.utils.checkpoint``
        with ``config.remat_policy``, as the JAX model hands it to
        ``jax.checkpoint`` (``runtime/activation_checkpointing``'s
        :func:`remat`): ``nothing_saveable`` keeps the layer's input
        alone and recomputes the rest in the backward; ``dots_saveable``
        also keeps the projections' outputs (the flash kernels are
        recomputed, as a Pallas call is under ``jax.checkpoint``);
        ``everything_saveable`` recomputes nothing.  A policy changes what
        is kept, never a value."""
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, device=input_ids.device).expand(B, S)
        x = self._embed(input_ids, positions)
        checkpointed = self.config.remat and torch.is_grad_enabled()
        # a name the JAX model does not find in jax.checkpoint_policies
        # gives policy=None there, which saves nothing: the same here
        policy = POLICIES.get(self.config.remat_policy, SAVE_NOTHING)
        windows = self.config.local_attn_pattern or (None,) * len(
            self.layers)
        for layer, window in zip(self.layers, windows):
            if checkpointed:
                x = remat(self._train_layer, x, layer, positions,
                          attn_backend, window, policy=policy)
            else:
                x = self._train_layer(x, layer, positions, attn_backend,
                                      window)
        if return_hidden:
            return self._final_norm(x)
        return self._logits(x)

    def loss(self, batch, attn_backend="auto"):
        """Next-token cross-entropy (fp32 scalar).  ``batch``: dict with
        ``input_ids`` [B, S] (+ optional ``labels``, ``loss_mask``) or a
        raw [B, S] tensor.  ``loss_chunk_size`` > 0 takes the chunked
        loss, as in the JAX model."""
        c = self.config
        input_ids = _unpack_batch(batch)[0]
        if c.loss_chunk_size and c.loss_chunk_size > 0:
            x = self.apply(input_ids, return_hidden=True,
                           attn_backend=attn_backend)
            return chunked_next_token_xent(
                x, self._head(), getattr(self, "lm_head_b", None), batch,
                c.loss_chunk_size)
        return next_token_xent(self.apply(input_ids,
                                          attn_backend=attn_backend), batch)

    # ------------------------------------------------------------------
    # contiguous KV cache (InferenceEngine.generate)
    # ------------------------------------------------------------------
    def init_caches(self, batch, max_seq, dtype=torch.bfloat16) -> KVCache:
        """Stacked per-layer caches: k/v [n_layers, B, Hkv, max_seq, D].
        Raises for a model the serving paths do not decode
        (:func:`check_servable`)."""
        c = self.config
        check_servable(c)
        shape = (c.n_layers, batch, c.kv_heads, max_seq, c.head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=self.device),
                       v=torch.zeros(shape, dtype=dtype, device=self.device),
                       length=0)

    @torch.no_grad()
    def apply_with_cache(self, input_ids, caches: KVCache,
                         attn_backend="auto"):
        """Prefill (T = prompt) or decode (T = 1) over ``caches``, written
        in place.  Returns (logits [B, T, V] fp32, caches at length + T)."""
        c = self.config
        check_servable(c)
        B, T = input_ids.shape
        start = int(caches.length)
        positions = (start + torch.arange(T, device=input_ids.device)
                     ).expand(B, T)
        x = self._embed(input_ids, positions)
        for i, layer in enumerate(self.layers):
            cache_i = KVCache(caches.k[i], caches.v[i], start)

            def attend(q, k, v, cache_i=cache_i):
                cache = update_cache(cache_i, k, v)
                return decode_attention(q, cache, softmax_scale=c.attn_scale,
                                        backend=attn_backend)

            x = self._layer(x, layer, positions, attend)
        return self._logits(x), KVCache(caches.k, caches.v, start + T)

    # ------------------------------------------------------------------
    # paged KV cache (continuous-batching serving engine)
    # ------------------------------------------------------------------
    def init_paged_caches(self, num_pages, page_size,
                          dtype=torch.bfloat16) -> PagedKVCache:
        """Stacked per-layer page pools: [n_layers, P, Hkv, page, D].
        Raises for a model the serving paths do not decode (where the JAX
        model asserts no ALiBi and no window)."""
        c = self.config
        check_servable(c)
        shape = (c.n_layers, num_pages, c.kv_heads, page_size, c.head_dim)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=self.device),
            v_pages=torch.zeros(shape, dtype=dtype, device=self.device))

    @torch.no_grad()
    def apply_with_paged_cache(self, input_ids, caches: PagedKVCache,
                               block_tables, lengths, attn_backend="auto"):
        """Append the T new tokens of every sequence at ``lengths`` (the
        tables must already map their pages; pools written in place) and
        attend over each sequence's ragged prefix.  ``block_tables``:
        [B, max_pages] int32; ``lengths``: [B] int32, both on the model's
        device.  Returns (logits [B, T, V] fp32, caches, lengths + T)."""
        c = self.config
        check_servable(c)
        B, T = input_ids.shape
        positions = lengths.long()[:, None] + torch.arange(
            T, device=lengths.device)[None, :]
        total = lengths + T
        x = self._embed(input_ids, positions)
        for i, layer in enumerate(self.layers):
            pool = PagedKVCache(caches.k_pages[i], caches.v_pages[i])

            def attend(q, k, v, pool=pool):
                prefill_paged(pool, block_tables, lengths, k, v)
                return paged_decode_attention(
                    q, pool, block_tables, total,
                    softmax_scale=c.attn_scale, backend=attn_backend)

            x = self._layer(x, layer, positions, attend)
        return self._logits(x), caches, total
