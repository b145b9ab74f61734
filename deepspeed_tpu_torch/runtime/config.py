"""Training config: a ``DeepSpeedConfig`` subset.

Counterpart of ``deepspeed_tpu/runtime/config.py``, reading the same JSON
keys: the batch triangle ``train_batch_size = micro * gas * world`` (world
is 1 here), ``optimizer`` {type, params}, ``scheduler`` {type, params},
``fp16`` (loss scaling; ``loss_scale`` 0 means dynamic), ``bf16.enabled``,
``gradient_clipping``, ``seed``, ``steps_per_print``,
``wall_clock_breakdown``, ``zero_optimization``, ``checkpoint``,
``resilience``, ``activation_checkpointing`` and
``data_types.grad_accum_dtype``.  Every block the JAX engine acts on and the port does not
run yet raises ``NotImplementedError`` naming its ROADMAP item,
when it is enabled or non-empty; the keys the JAX config accepts and
leaves inert pass silently; any other top-level key logs a warning with
a "did you mean" hint, as the JAX config's ``_warn_unknown_keys`` does.
"""

import difflib
import json
import math
import os
from typing import Any, Dict, Union

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger

# every top-level key the JAX config understands
# (deepspeed_tpu/runtime/config.py _KNOWN_TOP_LEVEL_KEYS): the port reads
# some, refuses others in _refuse_unported, and accepts the rest as inert
KNOWN_TOP_LEVEL_KEYS = frozenset({
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.GRADIENT_ACCUMULATION_STEPS, C.OPTIMIZER, C.SCHEDULER, C.FP16,
    C.BFLOAT16, C.BFLOAT16_OLD, C.AMP, C.GRADIENT_CLIPPING,
    C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR, C.STEPS_PER_PRINT,
    C.WALL_CLOCK_BREAKDOWN, C.DUMP_STATE, C.SPARSE_GRADIENTS,
    C.ZERO_OPTIMIZATION, C.COMMS_LOGGER, C.COMM, C.MESH,
    C.ACTIVATION_CHECKPOINTING, C.FLOPS_PROFILER, C.MONITOR_TENSORBOARD,
    C.MONITOR_WANDB, C.MONITOR_CSV, C.TELEMETRY, C.ASYNC_PIPELINE,
    C.RESILIENCE, C.DATA_EFFICIENCY, C.CURRICULUM_LEARNING_LEGACY,
    C.CHECKPOINT, C.ELASTICITY, C.COMPRESSION_TRAINING, C.PIPELINE, C.SEED,
    C.ZERO_ALLOW_UNTESTED_OPTIMIZER, C.EIGENVALUE, C.PROGRESSIVE_LAYER_DROP,
    C.AUTOTUNING, "serving", C.MEMORY, "gradient_accumulation_dtype",
    "communication_data_type", "memory_breakdown", C.DATA_TYPES, "nebula",
    "disable_allgather", "zero_force_ds_cpu_optimizer", "sparse_attention",
    "autotuning_model_overrides",
})

# mesh axes wider than one rank -> the ROADMAP item that ports them
_MESH_ITEMS = {"dp": "A8", "fsdp": "A8", "tp": "A14", "ep": "A14",
               "pp": "A14", "sp": "A15"}


class DeepSpeedConfigError(Exception):
    pass


class FP16Config(DeepSpeedConfigModel):
    enabled = C.FP16_ENABLED_DEFAULT
    loss_scale = C.FP16_LOSS_SCALE_DEFAULT
    initial_scale_power = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis = C.FP16_HYSTERESIS_DEFAULT
    min_loss_scale = C.FP16_MIN_LOSS_SCALE_DEFAULT
    fp16_master_weights_and_grads = C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT
    auto_cast = False          # accepted and inert, as in the JAX config


class ResilienceConfig(DeepSpeedConfigModel):
    """``"resilience"`` block (``runtime/resilience.py``): durable
    checkpoints with validation and fallback, the retry policy of
    checkpoint and filesystem I/O, preemption handling, the divergence
    sentinel and the fault injector -- the JAX config's fields and
    checks.  The ``dataloader_*`` retries belong to the prefetcher: they
    parse, and act once ``async_pipeline`` is ported (ROADMAP A17)."""
    enabled = True                  # durable ckpt protocol + retries
    max_retries = 3                 # checkpoint/fs I/O retry budget
    retry_backoff_secs = 0.5        # first-retry backoff
    retry_backoff_max_secs = 30.0   # backoff cap
    retry_jitter = 0.25             # jitter fraction on each delay
    keep_last = 0                   # committed tags retained (0 = all)
    checksum = False                # per-leaf crc32 in the manifest
    preemption_handler = False      # hook SIGTERM/SIGINT
    ckpt_dir = ""                   # emergency-save / auto-restore dir
    divergence_sentinel = False     # watch loss / overflow streaks
    max_consecutive_skips = 8       # fp16 skip streak that counts as divergence
    sentinel_interval = 1           # steps between sentinel host readbacks
    on_divergence = "halt"          # "halt" | "restore"
    dataloader_max_retries = 2      # prefetch-worker transient retry budget
    dataloader_retry_backoff_secs = 0.05
    fault_injection = {}            # deterministic FaultInjector spec

    def _validate(self):
        if int(self.max_retries) < 0:
            raise ValueError("resilience.max_retries must be >= 0")
        if int(self.keep_last) < 0:
            raise ValueError("resilience.keep_last must be >= 0")
        if self.on_divergence not in ("halt", "restore"):
            raise ValueError("resilience.on_divergence must be 'halt' or "
                             "'restore'")
        if int(self.sentinel_interval) < 1:
            raise ValueError("resilience.sentinel_interval must be >= 1")
        if int(self.dataloader_max_retries) < 0:
            raise ValueError("resilience.dataloader_max_retries must be >= 0")


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """``"activation_checkpointing"`` block: the knobs of
    ``runtime/activation_checkpointing/checkpointing.configure``, which the
    engine calls with this config.  ``policy`` names what a checkpointed
    block keeps (its ``POLICIES``); the model's own per-layer remat follows
    ``TransformerConfig.remat_policy``, as in the JAX package."""
    partition_activations = False
    contiguous_memory_optimization = False
    cpu_checkpointing = False
    number_checkpoints = None
    synchronize_checkpoint_boundary = False
    profile = False
    policy = "nothing_saveable"


class CheckpointConfig(DeepSpeedConfigModel):
    """``"checkpoint"`` block.  ``engine`` picks the checkpoint engine
    (``runtime/checkpoint_engine.py``): "sync" (also "orbax" and "torch",
    the JAX names) or "async" / "nebula".  ``load_universal`` and the other
    keys parse and, as in the JAX engine, change nothing."""
    tag_validation = "Warn"
    load_universal = False
    use_node_local_storage = False
    parallel_write = {}
    engine = "sync"

    def _validate(self):
        if str(self.engine).lower() not in ("sync", "async", "nebula",
                                            "torch", "orbax"):
            raise ValueError(
                "checkpoint.engine must be one of sync|async|nebula "
                f"(got {self.engine!r})")


class OptimizerConfig:
    def __init__(self, param_dict):
        self.type = param_dict.get(C.TYPE)
        self.params = dict(param_dict.get(C.OPTIMIZER_PARAMS, {}))


class SchedulerConfig:
    def __init__(self, param_dict):
        self.type = param_dict.get(C.TYPE)
        self.params = dict(param_dict.get(C.SCHEDULER_PARAMS, {}))


def _enabled(block) -> bool:
    return bool(isinstance(block, dict) and block.get("enabled", False))


def _set(block) -> bool:
    """A block asks for something: enabled, or a non-empty block without
    an ``enabled`` switch."""
    if isinstance(block, dict) and "enabled" in block:
        return bool(block["enabled"])
    return bool(block)


def _refuse_mesh(mesh):
    if not isinstance(mesh, dict):
        return
    wide = {k: v for k, v in mesh.items() if isinstance(v, int) and v > 1}
    if math.prod(wide.values()) > 1:
        items = sorted({_MESH_ITEMS.get(k, "A14") for k in wide})
        raise NotImplementedError(
            f"mesh {wide}: a mesh wider than one rank is not ported yet "
            f"(ROADMAP {', '.join(items)})")


def _refuse_unported(pd):
    """Raise for every block that asks for behaviour this slice lacks."""
    blocks = [
        (bool(pd.get(C.COMPRESSION_TRAINING)),
         "compression_training / MoQ", "A17"),
        (bool(pd.get(C.PIPELINE)), "pipeline parallelism", "A14"),
        (_enabled(pd.get(C.ASYNC_PIPELINE)), "async_pipeline", "A17"),
        (_enabled(pd.get(C.TELEMETRY)), "telemetry", "A17"),
        (_set(pd.get(C.CURRICULUM_LEARNING_LEGACY)), "curriculum_learning",
         "A17"),
        (_set(pd.get(C.DATA_EFFICIENCY)), "data_efficiency", "A17"),
        (_set(pd.get(C.PROGRESSIVE_LAYER_DROP)), "progressive_layer_drop",
         "A17"),
        (_set(pd.get(C.EIGENVALUE)), "eigenvalue", "A17"),
        (_set(pd.get(C.FLOPS_PROFILER)), "flops_profiler", "A17"),
        (any(_set(pd.get(k)) for k in (C.MONITOR_TENSORBOARD,
                                       C.MONITOR_WANDB, C.MONITOR_CSV)),
         "monitors (tensorboard, wandb, csv_monitor)", "A17"),
        (_set(pd.get(C.COMMS_LOGGER)), "comms_logger", "A17"),
        (_set(pd.get(C.ELASTICITY)), "elasticity", "A17"),
        (bool((pd.get(C.AUTOTUNING) or {}).get("overlay_path")),
         "autotuning.overlay_path (the tuned overlay)", "A17"),
        (_set(pd.get(C.MEMORY)), "the tiered memory block (memory)",
         "A12b"),
    ]
    for on, what, item in blocks:
        if on:
            raise NotImplementedError(f"{what} is not ported yet "
                                      f"(ROADMAP {item})")
    _refuse_mesh(pd.get(C.MESH))


# data_types.grad_accum_dtype: the JAX config's names
_GRAD_ACCUM_DTYPES = {"fp32": "float32", "float32": "float32",
                      "bf16": "bfloat16", "bfloat16": "bfloat16",
                      "fp16": "float16", "float16": "float16"}


def _parse_grad_accum_dtype(name):
    """The JAX config's ``_parse_grad_accum_dtype``: None, "float32",
    "bfloat16" (or "float16", which raises: B3 takes fp32 or bf16
    gradients)."""
    if name is None:
        return None
    key = str(name).lower()
    if key not in _GRAD_ACCUM_DTYPES:
        raise DeepSpeedConfigError(
            "data_types.grad_accum_dtype must be one of "
            f"{sorted(set(_GRAD_ACCUM_DTYPES))}, got {name!r}")
    if _GRAD_ACCUM_DTYPES[key] == "float16":
        raise NotImplementedError(
            "data_types.grad_accum_dtype float16: fp16 gradients into the "
            "fused Adam kernel are not ported yet (ROADMAP B, item 3)")
    return _GRAD_ACCUM_DTYPES[key]


def _warn_unknown_keys(pd):
    """One warning per top-level key no config of either package reads,
    with the nearest known key as a hint."""
    for k in sorted(k for k in pd if k not in KNOWN_TOP_LEVEL_KEYS):
        close = difflib.get_close_matches(k, KNOWN_TOP_LEVEL_KEYS, n=1)
        hint = f" (did you mean '{close[0]}'?)" if close else ""
        logger.warning(f"config key '{k}' is not recognized and will be "
                       f"ignored{hint}")


class DeepSpeedConfig:

    def __init__(self, config: Union[str, Dict[str, Any]], world_size=1):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"Config file {config} not found")
            with open(config) as f:
                pd = json.load(f)
        elif isinstance(config, dict):
            pd = dict(config)
        else:
            raise DeepSpeedConfigError(
                f"Expected a dict or json path, got {type(config)}")
        _refuse_unported(pd)
        _warn_unknown_keys(pd)
        self.world_size = int(world_size)

        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(
            C.GRADIENT_ACCUMULATION_STEPS)
        self._configure_train_batch_size()

        self.steps_per_print = pd.get(C.STEPS_PER_PRINT,
                                      C.STEPS_PER_PRINT_DEFAULT)
        # the engine logs fwd / bwd / step times every steps_per_print
        # steps of the three-call path (utils/timer.py)
        self.wall_clock_breakdown = bool(pd.get(
            C.WALL_CLOCK_BREAKDOWN, C.WALL_CLOCK_BREAKDOWN_DEFAULT))
        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING,
                                        C.GRADIENT_CLIPPING_DEFAULT)
        self.seed = pd.get(C.SEED, C.SEED_DEFAULT)
        self.zero_config = DeepSpeedZeroConfig(pd.get(C.ZERO_OPTIMIZATION,
                                                      {}))
        self.bfloat16_enabled = _enabled(pd.get(C.BFLOAT16,
                                                pd.get(C.BFLOAT16_OLD)))
        self.fp16_config = FP16Config(pd.get(C.FP16) or {})
        if self.fp16_config.enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        opt = pd.get(C.OPTIMIZER)
        self.optimizer_config = OptimizerConfig(opt) if opt else None
        sched = pd.get(C.SCHEDULER)
        self.scheduler_config = SchedulerConfig(sched) if sched else None
        self.checkpoint_config = CheckpointConfig(pd.get(C.CHECKPOINT) or {})
        self.resilience_config = ResilienceConfig(pd.get(C.RESILIENCE) or {})
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            pd.get(C.ACTIVATION_CHECKPOINTING) or {})
        # the flat gradient buffer's dtype (None: fp32)
        self.grad_accum_dtype = _parse_grad_accum_dtype(
            (pd.get(C.DATA_TYPES) or {}).get(C.GRAD_ACCUM_DTYPE))
        # the JAX config's _do_sanity_check; otherwise the flag changes
        # nothing, as in the JAX engine, which never reads it
        if self.zero_config.stage > 0 and self.fp16_config.enabled and \
                self.fp16_config.fp16_master_weights_and_grads and \
                self.zero_config.stage != 2:
            raise DeepSpeedConfigError(
                "fp16_master_weights_and_grads only supported with ZeRO-2")

    @property
    def fp16_enabled(self):
        return bool(self.fp16_config.enabled)

    @property
    def loss_scale(self):
        return self.fp16_config.loss_scale

    @property
    def dynamic_loss_scale(self):
        return self.fp16_config.loss_scale == 0

    # Batch-size triangle: train = micro x gas x dp_world (the JAX
    # package's _configure_train_batch_size / _batch_assertion)
    def _configure_train_batch_size(self):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = max(1, self.world_size)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
        elif train is not None and gas is not None:
            micro = train // (gas * dp)
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas = 1
            micro = train // dp
        elif micro is not None:
            gas = 1
            train = micro * dp
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size / "
                "train_micro_batch_size_per_gpu must be set")
        if train <= 0:
            raise DeepSpeedConfigError(
                f"train_batch_size: {train} must be positive")
        if micro <= 0:
            raise DeepSpeedConfigError(
                f"micro_batch_size: {micro} must be positive")
        if gas <= 0:
            raise DeepSpeedConfigError(
                f"gradient_accumulation_steps: {gas} must be positive")
        if train != micro * gas * dp:
            raise DeepSpeedConfigError(
                f"Check batch-size settings: train_batch_size={train} must "
                f"equal micro_batch={micro} * gradient_accumulation={gas} "
                f"* dp_world={dp}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
