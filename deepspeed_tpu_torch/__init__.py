"""deepspeed_tpu_torch -- the PyTorch / CUDA port of ``deepspeed_tpu``
for one NVIDIA H100.

The port mirrors the JAX package's layout and names, imports neither
``jax`` nor anything of ``deepspeed_tpu``, and writes every TPU kernel on
its path as a hand-written Hopper kernel (``ops/csrc``) beside a plain
PyTorch version.  This slice serves: ``init_inference(...).generate`` and
``create_serving_engine``.  Entry points run on the card unless the caller
passes ``device="cpu"``; with no card they raise.
"""

__version__ = "0.1.0"

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig  # noqa: F401
from deepspeed_tpu_torch.inference.engine import InferenceEngine  # noqa: F401
from deepspeed_tpu_torch.inference.serving import ServingEngine  # noqa: F401
from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    CausalTransformerLM, TransformerConfig)
from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401


def init_inference(model=None, config=None, params=None, device=None,
                   **kwargs):
    """Counterpart of ``deepspeed_tpu.init_inference``: config kwargs
    (``dtype="bf16"`` etc.) merge into ``config``; ``params`` is an
    optional state dict to load (see ``models.convert.from_jax_params``).
    ``device`` defaults to the card and raises without one.  The HF
    ``module_inject`` path is not ported (ROADMAP A16)."""
    if model is None or not isinstance(model, CausalTransformerLM):
        raise NotImplementedError(
            "init_inference takes a deepspeed_tpu_torch CausalTransformerLM; "
            "HF model injection is not ported yet (ROADMAP A16)")
    cfg_dict = dict(config or {})
    cfg_dict.update(kwargs)
    return InferenceEngine(model, DeepSpeedInferenceConfig(cfg_dict),
                           params=params, device=device)


def create_serving_engine(model, config=None, **kwargs):
    """Build a paged-KV ``ServingEngine`` from a ds-style config dict."""
    from deepspeed_tpu_torch.inference.serving import \
        create_serving_engine as _f
    return _f(model, config=config, **kwargs)
