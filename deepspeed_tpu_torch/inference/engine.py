"""Inference engine.

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceEngine``:
``set_params``, ``forward``, ``generate``, ``create_serving_engine``).
The weights live in the model's ``nn.Module`` parameters on the engine's
device (the card unless the caller names another); ``generate`` prefills
once over a contiguous KV cache and then decodes one token per model call,
each call's attention being the decode-attention CUDA kernel on the card.
Greedy decoding is bit-identical to the JAX engine at equal logits;
temperature / top-k sampling draws from a seeded ``torch.Generator`` on
the engine's device, so its streams are not the JAX engine's.

``config["checkpoint"]`` loads the weights from a universal checkpoint
dir (``universal_meta.json``, either package's) or a port training
checkpoint (``load_model_with_checkpoint``).

Not ported in this slice: tensor parallelism (ROADMAP A14), ZeRO-Inference
weight streaming and int8 weight-only quantization (A12c), decoding ALiBi /
sliding-window / embedding-norm models (A18).
"""

import os
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.serving import to_torch_dtype
from deepspeed_tpu_torch.models.transformer import check_servable
from deepspeed_tpu_torch.utils.logging import log_dist


class InferenceEngine:
    """Wraps a ``CausalTransformerLM`` for generation on one device."""

    def __init__(self, model, config: DeepSpeedInferenceConfig, params=None,
                 device=None):
        if config.tp_size > 1 or int(config.ep_size) > 1:
            raise NotImplementedError("tensor/expert-parallel inference is "
                                      "not ported yet (ROADMAP A14)")
        if config.quant.enabled or str(config.dtype) == "int8":
            raise NotImplementedError("int8 weight-only quantization is not "
                                      "ported yet (ROADMAP A12c)")
        if dict(config.zero or {}).get("offload_param"):
            raise NotImplementedError("ZeRO-Inference weight streaming is "
                                      "not ported yet (ROADMAP A12c)")
        self.module = model
        self._config = config
        self.dtype = to_torch_dtype(config.dtype)
        self.device = get_accelerator().resolve_device(device)
        # ALiBi / window / embedding-norm models, and on the card a head
        # dim no kernel takes, raise here, not at the first token
        check_servable(model.config, self.device)
        if params is None and config.checkpoint:
            params = self.load_model_with_checkpoint(config.checkpoint)
        if params is not None:
            self.set_params(params)
        else:
            model.to(device=self.device, dtype=self.dtype)
        log_dist(f"InferenceEngine ready: dtype={self.dtype} "
                 f"device={self.device}", ranks=[0])

    # ------------------------------------------------------------------
    def set_params(self, params):
        """Load a state dict (name -> tensor or numpy array, e.g. from
        ``models.convert.from_jax_params``) into the model: floating
        leaves are cast to the engine dtype, every leaf moves to the
        engine device.  Names and shapes must match the model exactly."""
        own = dict(self.module.named_parameters())
        missing, unexpected = set(own) - set(params), set(params) - set(own)
        if missing or unexpected:
            raise KeyError(f"params do not match the model: missing "
                           f"{sorted(missing)}, unexpected "
                           f"{sorted(unexpected)}")
        with torch.no_grad():
            for name, value in params.items():
                t = torch.as_tensor(np.asarray(value)
                                    if not torch.is_tensor(value) else value)
                if tuple(t.shape) != tuple(own[name].shape):
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                     f"model {tuple(own[name].shape)}")
                if t.is_floating_point():
                    t = t.to(self.dtype)
                own[name].data = t.to(self.device)

    # ------------------------------------------------------------------
    def load_model_with_checkpoint(self, checkpoint: str):
        """The state dict (numpy, by parameter name) of a universal
        checkpoint dir or a port training checkpoint dir (its ``latest``
        tag's fp32 master)."""
        from deepspeed_tpu_torch.checkpoint import (load_checkpoint_tree,
                                                    load_universal_checkpoint,
                                                    universal_to_state_dict)
        from deepspeed_tpu_torch.checkpoint.universal_checkpoint import \
            META_NAME
        if os.path.exists(os.path.join(checkpoint, META_NAME)):
            flat = load_universal_checkpoint(checkpoint)
            log_dist(f"loaded universal checkpoint: {len(flat)} tensors",
                     ranks=[0])
            return universal_to_state_dict(flat, self.module)
        from deepspeed_tpu_torch.models.convert import from_jax_params
        params = load_checkpoint_tree(checkpoint,
                                      load_optimizer_states=False)["params"]
        log_dist(f"loaded checkpoint params from {checkpoint}", ranks=[0])
        return from_jax_params(params, self.module.config)

    # ------------------------------------------------------------------
    def forward(self, input_ids, caches=None):
        """Single forward (prefill when ``caches`` is None).  Returns
        (logits [B, T, V] fp32, caches)."""
        input_ids = torch.as_tensor(input_ids, dtype=torch.long,
                                    device=self.device)
        if caches is None:
            caches = self.module.init_caches(input_ids.shape[0],
                                             self._config.max_out_tokens,
                                             self.dtype)
        return self.module.apply_with_cache(input_ids, caches)

    __call__ = forward

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k: Optional[int] = None, seed=0, eos_token_id=None):
        """Greedy or temperature/top-k sampling: one prefill over the
        prompt, then one model call per new token.  Returns the prompt
        followed by ``max_new_tokens`` tokens, [B, S + max_new_tokens]
        int64 on the engine device (tokens after an EOS become EOS)."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        B, S = ids.shape
        caches = self.module.init_caches(B, S + max_new_tokens, self.dtype)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def sample(logits):
            if temperature and temperature > 0:
                lg = logits / temperature
                if top_k:
                    kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
                    lg = torch.where(lg < kth, torch.full_like(lg, -1e30),
                                     lg)
                probs = torch.softmax(lg, dim=-1)
                return torch.multinomial(probs, 1, generator=gen)[:, 0]
            return torch.argmax(logits, dim=-1)

        logits, caches = self.module.apply_with_cache(ids, caches)
        toks = [sample(logits[:, -1])]
        for _ in range(max_new_tokens - 1):
            logits, caches = self.module.apply_with_cache(toks[-1][:, None],
                                                          caches)
            toks.append(sample(logits[:, -1]))
        out = torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
        if eos_token_id is not None:
            host = out.cpu().numpy()
            for b in range(B):
                hits = np.where(host[b, S:] == eos_token_id)[0]
                if hits.size:
                    host[b, S + hits[0] + 1:] = eos_token_id
            out = torch.as_tensor(host, device=self.device)
        return out

    # ------------------------------------------------------------------
    def create_serving_engine(self, max_batch: int = 8,
                              page_size: int = 128,
                              num_pages: Optional[int] = None,
                              max_seq: int = 2048,
                              eos_token_id: Optional[Any] = None,
                              decode_chunk: int = 1, **kwargs):
        """A continuous-batching ``ServingEngine`` over this engine's model
        and weights, wired with the config's ``serving`` block."""
        from deepspeed_tpu_torch.inference.serving import ServingEngine
        kwargs.setdefault("serving", getattr(self._config, "serving", None))
        return ServingEngine(self.module, max_batch=max_batch,
                             page_size=page_size, num_pages=num_pages,
                             max_seq=max_seq, dtype=self.dtype,
                             eos_token_id=eos_token_id,
                             tp_size=max(1, self._config.tp_size),
                             ep_size=max(1, int(self._config.ep_size)),
                             decode_chunk=decode_chunk, **kwargs)
