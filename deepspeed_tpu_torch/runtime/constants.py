"""Config keys + defaults.

Counterpart of ``deepspeed_tpu/runtime/constants.py`` (the subset the
training slice reads): the same JSON key spellings, so a DeepSpeed config
file reads the same in both packages ("per_gpu" keys mean per card).
"""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"

SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

FP16 = "fp16"
FP16_ENABLED_DEFAULT = False
# loss_scale 0 means dynamic loss scaling
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

ZERO_OPTIMIZATION = "zero_optimization"

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"

COMPRESSION_TRAINING = "compression_training"
PIPELINE = "pipeline"
ASYNC_PIPELINE = "async_pipeline"
RESILIENCE = "resilience"
TELEMETRY = "telemetry"

SEED = "seed"
SEED_DEFAULT = 42

# blocks the JAX engine acts on and the port refuses (runtime/config.py)
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
DATA_EFFICIENCY = "data_efficiency"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
EIGENVALUE = "eigenvalue"
FLOPS_PROFILER = "flops_profiler"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
COMMS_LOGGER = "comms_logger"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
MEMORY = "memory"
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
MESH = "mesh"

# top-level keys the JAX config accepts and leaves inert (or that only a
# serving engine reads): accepted silently here too
AMP = "amp"
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
DUMP_STATE = "dump_state"
SPARSE_GRADIENTS = "sparse_gradients"
COMM = "comm"
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
