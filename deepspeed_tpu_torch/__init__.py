"""deepspeed_tpu_torch -- the PyTorch / CUDA port of ``deepspeed_tpu``
for one NVIDIA H100.

The port mirrors the JAX package's layout and names, imports neither
``jax`` nor anything of ``deepspeed_tpu``, and writes every TPU kernel on
its path as a hand-written Hopper kernel (``ops/csrc``) beside a plain
PyTorch version.  Ported so far: serving (``init_inference(...).generate``
and ``create_serving_engine``) and training on one card
(``initialize(...)`` -> ``DeepSpeedEngine.train_batch`` or
``forward``/``backward``/``step``; fp32, bf16, or fp16 with loss scaling;
LR schedules).  Entry points run on the card unless
the caller passes ``device="cpu"``; with no card they raise.
"""

__version__ = "0.1.0"

from deepspeed_tpu_torch.accelerator import get_accelerator  # noqa: F401
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig  # noqa: F401
from deepspeed_tpu_torch.inference.engine import InferenceEngine  # noqa: F401
from deepspeed_tpu_torch.inference.serving import ServingEngine  # noqa: F401
from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    CausalTransformerLM, TransformerConfig)
from deepspeed_tpu_torch.runtime.config import (  # noqa: F401
    DeepSpeedConfig, DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine  # noqa: F401
from deepspeed_tpu_torch.utils.logging import log_dist, logger  # noqa: F401


def initialize(args=None, model=None, model_parameters=None, config=None,
               optimizer=None, lr_scheduler=None, device=None):
    """Counterpart of ``deepspeed_tpu.initialize``: returns ``(engine,
    optimizer, None, lr_scheduler)``.  ``model``: a ``CausalTransformerLM``;
    ``model_parameters``: None (the module's own weights) or the JAX
    package's param dict with numpy leaves (loaded through
    ``models.convert.from_jax_params``); ``config``: a dict, a JSON path,
    ``args.deepspeed_config`` or a ``DeepSpeedConfig``.  ``lr_scheduler``:
    an ``LRScheduler`` or a callable on the 0-dim fp32 step (the config's
    ``scheduler`` block takes precedence, as in the JAX engine).
    ``device`` defaults to the card and raises without one.  A client
    optimizer is not ported (ROADMAP A7)."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if optimizer is not None:
        raise NotImplementedError("client optimizers are not ported yet "
                                  "(ROADMAP A7); name the optimizer in the "
                                  "config")
    if config is None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config or the "
                         "config= argument")
    if not isinstance(config, DeepSpeedConfig):
        config = DeepSpeedConfig(config)
    if model_parameters is not None:
        from deepspeed_tpu_torch.models.convert import from_jax_params
        model.load_state_dict(from_jax_params(model_parameters,
                                              model.config), strict=True)
    engine = DeepSpeedEngine(model, config, device=device,
                             lr_scheduler=lr_scheduler)
    return engine, engine.optimizer, None, engine.lr_scheduler


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
