"""deepspeed_tpu_torch -- the PyTorch / CUDA port of ``deepspeed_tpu``
for one NVIDIA H100.

The port mirrors the JAX package's layout and names, imports neither
``jax`` nor anything of ``deepspeed_tpu``, and writes every TPU kernel on
its path as a hand-written Hopper kernel (``ops/csrc``) beside a plain
PyTorch version.  Ported so far: serving (``init_inference(...).generate``
and ``create_serving_engine``) and training on one card
(``initialize(...)`` -> ``DeepSpeedEngine.train_batch`` or
``forward``/``backward``/``step``; fp32, bf16, or fp16 with loss scaling;
every built-in optimizer, or a client ``torch.optim`` one; bf16 moments
and gradients; LR schedules; activation checkpointing, ``cpu_checkpointing``
too; ZeRO-Offload's optimizer on the host, its moments in RAM or swapped to
NVMe; ZeRO-Infinity's parameter stream, the parameters on the host or
NVMe and a window of layers on the card; durable checkpoints, the data loader and the fault-tolerance layer),
the host benches (``benchmarks``: ``cpu_adam``, ``aio``, ``offload``), serving from a checkpoint
(``init_inference(config={"checkpoint": dir})``) and the checkpoint tools
(``checkpoint/``).  Entry points run on the card unless
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
               optimizer=None, lr_scheduler=None, device=None,
               training_data=None, collate_fn=None):
    """Counterpart of ``deepspeed_tpu.initialize``: returns ``(engine,
    optimizer, training_dataloader, lr_scheduler)``; the loader is the
    engine's ``deepspeed_io(training_data, collate_fn=collate_fn)``, or
    None without ``training_data``.  ``model``: a ``CausalTransformerLM``;
    ``model_parameters``: None (the module's own weights) or the JAX
    package's param dict with numpy leaves (loaded through
    ``models.convert.from_jax_params``); ``config``: a dict, a JSON path,
    ``args.deepspeed_config`` or a ``DeepSpeedConfig``.  ``lr_scheduler``:
    an ``LRScheduler`` or a callable on the 0-dim fp32 step (the config's
    ``scheduler`` block takes precedence, as in the JAX engine).
    ``optimizer``: a client optimizer -- where the JAX package takes an
    optax transform, a ``torch.optim`` Optimizer class or a callable
    returning one, which the engine builds over its fp32 master weights
    (the config's ``optimizer`` block takes precedence).  ``device``
    defaults to the card and raises without one.  The optimizer returned
    is the engine's (``runtime/optimizers``; a client one's
    ``torch.optim`` instance is its ``.optimizer``; under
    ``offload_optimizer`` the host one of ``runtime/zero/offload``; under
    ``offload_param`` the stream's host store).  Under
    ``zero_optimization.offload_param`` the parameters go straight into
    the stream's host store -- ``model_parameters`` as host tensors, else
    the module's own, which may be built with ``device="cpu"`` (or
    ``"meta"`` beside ``model_parameters``) so the whole model never
    lives on the card."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if config is None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("DeepSpeed requires --deepspeed_config or the "
                         "config= argument")
    if not isinstance(config, DeepSpeedConfig):
        config = DeepSpeedConfig(config)
    host_params = None
    if model_parameters is not None:
        from deepspeed_tpu_torch.models.convert import from_jax_params
        named = from_jax_params(model_parameters, model.config)
        if config.zero_config.offload_param_device != "none":
            host_params = named
        else:
            model.load_state_dict(named, strict=True)
    engine = DeepSpeedEngine(model, config, device=device,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data,
                             collate_fn=collate_fn, optimizer=optimizer,
                             host_params=host_params)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def init_inference(model=None, config=None, params=None, device=None,
                   **kwargs):
    """Counterpart of ``deepspeed_tpu.init_inference``: config kwargs
    (``dtype="bf16"`` etc.) merge into ``config``; ``params`` is an
    optional state dict to load (see ``models.convert.from_jax_params``);
    without it, ``config["checkpoint"]`` names a universal checkpoint dir
    or a training checkpoint dir to load.
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
