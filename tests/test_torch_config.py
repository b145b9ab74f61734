"""The port's training config refuses what its engine would ignore.

* Every block the JAX engine acts on and the port does not run raises
  ``NotImplementedError`` naming its ROADMAP item, when it is enabled or
  non-empty -- and passes when it is disabled or empty.
* The keys the JAX config lists as known but inert pass silently.
* An unknown top-level key logs one warning with a "did you mean" hint,
  as the JAX config's ``_warn_unknown_keys`` does.
* A config of ported keys builds the same engine as before.
"""

import logging

import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import \
    DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.runtime.config import (KNOWN_TOP_LEVEL_KEYS,
                                                DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.utils.logging import logger
from torch_threads import _one_torch_thread  # noqa: F401

BASE = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}

# (block, ROADMAP item): each block of the JAX engine that the port refuses
REFUSED = [
    ({"curriculum_learning": {"enabled": True, "curriculum_type": "seqlen",
                              "min_difficulty": 8, "max_difficulty": 64}},
     "A17"),
    ({"data_efficiency": {"enabled": True}}, "A17"),
    ({"progressive_layer_drop": {"enabled": True, "theta": 0.5}}, "A17"),
    ({"eigenvalue": {"enabled": True}}, "A17"),
    ({"flops_profiler": {"enabled": True, "profile_step": 1}}, "A17"),
    ({"tensorboard": {"enabled": True, "output_path": "tb"}}, "A17"),
    ({"wandb": {"enabled": True}}, "A17"),
    ({"csv_monitor": {"enabled": True}}, "A17"),
    ({"comms_logger": {"enabled": True}}, "A17"),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 8}}, "A17"),
    ({"autotuning": {"overlay_path": "overlay.json"}}, "A17"),
    ({"memory": {"placement_policy": "nvme", "nvme_dir": "d"}}, "A12"),
    ({"zero_optimization": {"offload_param": {"device": "cpu"}}}, "A12"),
    ({"mesh": {"dp": 2}}, "A8"),
    ({"mesh": {"fsdp": 4}}, "A8"),
    ({"mesh": {"tp": 2}}, "A14"),
    ({"mesh": {"ep": 2, "dp": 1}}, "A14"),
    ({"mesh": {"pp": 2}}, "A14"),
    ({"mesh": {"sp": 2}}, "A15"),
]


def _id(case):
    block, item = case
    (key, val), = block.items()
    return f"{key}-{'-'.join(map(str, val))}-{item}"


@pytest.mark.parametrize("block,item", REFUSED, ids=map(_id, REFUSED))
def test_refused_block_names_its_item(block, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP .*{item}"):
        DeepSpeedConfig({**BASE, **block})


# the same blocks switched off, empty, or one rank wide: nothing to refuse
ACCEPTED_OFF = [
    {"curriculum_learning": {"enabled": False}},
    {"progressive_layer_drop": {"enabled": False, "theta": 0.5}},
    {"flops_profiler": {"enabled": False}},
    {"tensorboard": {}},
    {"activation_checkpointing": {}},
    {"memory": {}},
    {"checkpoint": {"load_universal": False}},
    {"autotuning": {"enabled": False}},
    {"mesh": {"dp": 1, "fsdp": 1, "tp": 1}},
]


@pytest.mark.parametrize("block", ACCEPTED_OFF,
                         ids=[next(iter(b)) for b in ACCEPTED_OFF])
def test_switched_off_block_passes(block):
    DeepSpeedConfig({**BASE, **block})


# blocks once refused that the engine now runs, or that the JAX engine
# parses and never reads (checkpoint.load_universal)
PORTED = {
    "activation_checkpointing": {"activation_checkpointing": {
        "partition_activations": True, "contiguous_memory_optimization": True,
        "number_checkpoints": 2, "policy": "dots_saveable"}},
    "grad_accum_dtype": {"data_types": {"grad_accum_dtype": "bf16"}},
    "load_universal": {"checkpoint": {"load_universal": True}},
    "cpu_checkpointing": {"activation_checkpointing": {
        "cpu_checkpointing": True}},
    "offload_optimizer": {"zero_optimization": {"stage": 2,
                                                "offload_optimizer": {
        "device": "nvme", "nvme_path": "swap", "buffer_count": 3}}},
    "cpu_offload": {"zero_optimization": {"stage": 2, "cpu_offload": True}},
    "checkpoint_engine": {"checkpoint": {"engine": "nebula"}},
    "resilience": {"resilience": {
        "preemption_handler": True, "ckpt_dir": "ckpt",
        "divergence_sentinel": True, "on_divergence": "restore",
        "keep_last": 2, "checksum": True,
        "fault_injection": {"ckpt_save": {"fail_times": 1}}}},
}


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_block_passes_as_in_jax(name):
    block = PORTED[name]
    cfg = DeepSpeedConfig({**BASE, **block})
    want = JaxConfig({**BASE, **block})
    for attr in ("checkpoint_config", "resilience_config",
                 "activation_checkpointing_config"):
        assert getattr(cfg, attr).to_dict() == \
            getattr(want, attr).to_dict(), attr
    assert cfg.grad_accum_dtype == want.grad_accum_dtype
    zc, jzc = cfg.zero_config, want.zero_config
    assert zc.offload_optimizer_device == jzc.offload_optimizer_device
    if jzc.offload_optimizer is not None:
        assert zc.offload_optimizer.to_dict() == \
            jzc.offload_optimizer.to_dict()


@pytest.mark.parametrize("stage,raises", [(0, False), (1, True), (2, False),
                                          (3, True)])
def test_fp16_master_weights_and_grads_as_in_jax(stage, raises):
    """The JAX config's check: with fp16 and ZeRO stage > 0 the flag is
    refused unless the stage is 2; otherwise it changes nothing (the JAX
    engine never reads it)."""
    block = {**BASE, "fp16": {"enabled": True,
                              "fp16_master_weights_and_grads": True},
             "zero_optimization": {"stage": stage}}
    if raises:
        with pytest.raises(DeepSpeedConfigError, match="ZeRO-2"):
            DeepSpeedConfig(block)
        with pytest.raises(JaxConfigError, match="ZeRO-2"):
            JaxConfig(block)
    else:
        assert DeepSpeedConfig(block).fp16_config.\
            fp16_master_weights_and_grads
        JaxConfig(block)


@pytest.mark.parametrize("block", [
    {"resilience": {"max_retries": -1}}, {"resilience": {"keep_last": -1}},
    {"resilience": {"on_divergence": "rewind"}},
    {"resilience": {"sentinel_interval": 0}},
    {"resilience": {"dataloader_max_retries": -1}},
    {"checkpoint": {"engine": "tensorstore"}}])
def test_bad_resilience_and_checkpoint_values_raise_as_in_jax(block):
    with pytest.raises(ValueError):
        JaxConfig({**BASE, **block})
    with pytest.raises(ValueError):
        DeepSpeedConfig({**BASE, **block})


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def warnings_logged():
    h = _Records()
    logger.addHandler(h)
    yield h.messages
    logger.removeHandler(h)


# keys the JAX config knows and leaves inert, or that another engine reads
INERT = {"amp": {"enabled": True}, "prescale_gradients": False,
         "gradient_predivide_factor": 1.0, "wall_clock_breakdown": False,
         "dump_state": False, "sparse_gradients": False,
         "zero_allow_untested_optimizer": True,
         "gradient_accumulation_dtype": "fp32",
         "communication_data_type": "fp32", "memory_breakdown": False,
         "nebula": {}, "disable_allgather": False,
         "zero_force_ds_cpu_optimizer": False, "comm": {},
         "sparse_attention": {"mode": "fixed"},
         "serving": {"page_size": 16}, "autotuning_model_overrides": {},
         "steps_per_print": 5, "seed": 3}


@pytest.mark.parametrize("key", sorted(INERT))
def test_inert_key_passes_silently(key, warnings_logged):
    DeepSpeedConfig({**BASE, key: INERT[key]})
    assert warnings_logged == []


def test_known_keys_are_the_jax_configs():
    assert KNOWN_TOP_LEVEL_KEYS == JaxConfig._KNOWN_TOP_LEVEL_KEYS


@pytest.mark.parametrize("key,hint", [("zero_optimisation",
                                       "zero_optimization"),
                                      ("gradient_clip", "gradient_clipping"),
                                      ("xyzzy", None)])
def test_unknown_key_warns_with_hint(key, hint, warnings_logged):
    DeepSpeedConfig({**BASE, key: {}})
    assert len(warnings_logged) == 1 and f"'{key}'" in warnings_logged[0]
    if hint:
        assert f"did you mean '{hint}'" in warnings_logged[0]
    else:
        assert "did you mean" not in warnings_logged[0]


def test_ported_config_builds_the_same_engine(warnings_logged):
    """The same engine from the ported keys alone and with every inert key
    beside them: same batch triangle, optimizer, clipping, and the same
    first two steps."""
    ported = {**BASE, "gradient_clipping": 0.5, "bf16": {"enabled": False},
              "zero_optimization": {"stage": 1}}
    ids = np.random.default_rng(0).integers(0, 256, (2, 2, 16))
    runs = []
    for cfg in (ported, {**ported, **INERT}):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=CausalTransformerLM(TransformerConfig.tiny(),
                                      device="cpu").init(0),
            config=cfg, device="cpu")
        c = eng._config
        runs.append(((c.train_batch_size, c.train_micro_batch_size_per_gpu,
                      c.gradient_accumulation_steps, c.gradient_clipping,
                      c.bfloat16_enabled, c.optimizer_config.type,
                      c.optimizer_config.params, c.zero_config.stage),
                     [float(eng.train_batch(batch={"input_ids": ids}))
                      for _ in range(2)]))
    assert runs[0] == runs[1]
    assert warnings_logged == []
