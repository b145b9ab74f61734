"""Training engine: a ``DeepSpeedEngine`` subset for one card.

Counterpart of ``deepspeed_tpu/runtime/engine.py``.  State, as the JAX
engine keeps it but laid out for eager PyTorch:

* fp32 master parameters, the gradients (fp32, or bf16 with
  ``data_types.grad_accum_dtype``) and the optimizer's state (Adam's m and
  v, fp32 or bf16 with ``moment_dtype``; the other rules' buffers:
  ``runtime/optimizers.py``), each ONE flat buffer on the card (16 bytes
  per parameter with AdamW in fp32, 10 with bf16 gradients and moments);
* the module's parameters are views into one flat buffer of the compute
  dtype (bf16 with ``bf16.enabled``, fp16 with ``fp16.enabled``, else
  fp32), refreshed from the master by one copy after each step -- the
  counterpart of ``_transformed_compute_params``, which casts the fp32
  master to the compute dtype every step;
* scalars on the card: the loss-scale state (``runtime/loss_scaler``),
  the count of applied steps (inside the Adam state: it drives the bias
  correction and the LR / momentum schedules, as optax's count does) and
  the count of skipped steps.

``train_batch`` runs the module's ``loss`` (times the loss scale under
fp16) and its backward once per micro-batch, adds each parameter's
gradient, unscaled in fp32, into the flat gradient buffer
(``_forward_grads``: the sum in the buffer's dtype -- a bf16 buffer takes
each micro-batch's gradient cast to bf16 first, ``_loss_and_grads`` --
then divided by gas), then the update of ``_apply_update``: overflow = inf
or nan in the flat gradients (fp16 only), the global norm in fp32,
clipping when ``gradient_clipping`` > 0 (``clip_f32``: the coefficient cast
to the gradients' dtype), then the optimizer's step, which writes nothing
when the step overflowed -- for Adam the schedules at the applied count
into its scalar buffer and ONE ``fused_adam`` launch over the flat buffer
-- the loss-scale automaton, and the master copied into the module.
``forward``/``backward``/``step`` share that accumulation and update;
``backward`` divides each micro-batch by gas before adding it, in the
order of the JAX ``backward``.  Nothing on the step path reads a value
back to the host: the loss, the grad norm, the overflow flag, the scale
and the counts stay device tensors until a caller asks.  The host's
``global_steps`` and its ``LRScheduler`` (``get_lr``) advance every batch,
skipped or not, as the JAX engine's do; so after a skipped step
``get_lr`` runs ahead of the lr the update used, which follows the applied
count (the JAX engine behaves the same way).

Checkpoints (``save_checkpoint`` / ``load_checkpoint``) keep the JAX
engine's durable protocol (``runtime/resilience.py``: tmp tag, manifest,
commit marker, retries, fallback to the newest valid tag, keep-last
retention, checksums) around the port's payload
(``runtime/checkpoint_engine.py``): master, the optimizer's buffers (Adam's
m and v under their old names) and the device scalars, restored bit for
bit, each in its own dtype; a client optimizer's ``state_dict()`` rides
``client_state``; the compute-dtype weights are rebuilt from the
master, the host ``global_steps``, ``micro_steps`` and LR scheduler come
back from ``client_state``.  The state is flat at every ZeRO stage, so a
tag saved at one stage loads at another.  ``train_batch`` polls the
preemption handler before and after each step (an emergency checkpoint,
then ``TrainingPreempted``), pushes the loss and overflow flag to the
divergence sentinel (halt, or restore the last good tag) and poisons the
step's weights when the fault injector says so.  ``deepspeed_io`` /
``training_data`` build the numpy loader of ``runtime/dataloader.py``.

Timers (``utils/timer.py``), as the JAX engine keeps them:
``train_batch`` logs ``RunningAvgSamplesPerSec`` every ``steps_per_print``
calls (``tput_timer``), and with ``wall_clock_breakdown`` the three-call
path logs ``time (ms) | fwd | bwd | step`` every ``steps_per_print``
steps (``timers``).  On the card both read CUDA events on the current
stream, resolved only on a step that logs, so a step that does not log
gains no host sync; the breakdown's timers run only when it is on.

The engine calls ``activation_checkpointing.checkpointing.configure``
with its config at init, as the JAX engine does; the model's own
per-layer remat follows its ``TransformerConfig.remat_policy``.

ZeRO-Offload (``zero_optimization.offload_optimizer``, device cpu or
nvme; the JAX engine's ``_init_offload_state`` / ``_offload_host_apply``):
the fp32 master is a pageable host tensor and the optimizer -- adam,
adamw, fusedadam, cpuadam or adagrad -- is the host one of
``runtime/zero/offload.py``, its moments in host RAM or swapped to NVMe;
the card keeps the compute weights and the gradients.  The step is the
same up to the update, which becomes the JAX offload path's host tail:
under fp16 the overflow flag read to the host (and a skipped step writes
nothing); the lr of the schedule at ``global_steps``, skipped steps
counted (the device path's follows the applied count); the clip
coefficient ``clip / (norm + 1e-6)`` when the fp32 norm exceeds ``clip``,
applied to the fp32 gradients on the host; the pipelined host step, which
writes the new weights into the compute buffer.  A checkpoint's payload
then holds the host master, and its tag the optimizer's sidecar
(``zero_offload_rank0.npz``), listed in the manifest; loading it with
``load_optimizer_states=False`` restores the master alone.

The parameter stream (``zero_optimization.offload_param``, device cpu or
nvme; the JAX engine's ``_init_param_stream_state``): the parameters, the
fp32 master and the optimizer's state live on the host in the planes of
``runtime/zero/param_stream.HostParamStore``, and the engine builds no
master, compute or gradient buffer on the card; the module's own
parameters are released once the store holds them.  ``train_batch`` is
``ParamStreamRunner.train_step`` at the lr of the schedule at
``global_steps`` and the loss scale of a host mirror of the automaton
(``loss_scaler.HostLossScale``; the device state is stepped in lockstep);
the optimizer -- adam, adamw, fusedadam, cpuadam or adagrad -- is the host
one.  ``forward`` / ``backward`` / ``step`` raise (the stream runs whole
optimizer steps), ``eval_batch`` and ``module_state_dict`` go through the
stream, and a checkpoint's tag holds the stream's sidecar
(``zero_param_stream_rank0.npz`` and its ``.meta.json``), listed in the
manifest.

Not ported yet (each raises naming its ROADMAP item): multi-rank ZeRO
(A8), the async input pipeline (A17).
"""

import json
import os
import time

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.models.transformer import check_trainable
from deepspeed_tpu_torch.ops.decode_attention import validate_backend
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    LAYOUT_NAME, get_checkpoint_engine, unflatten)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.loss_scaler import (HostLossScale,
                                                     dynamic_loss_scale_state,
                                                     has_inf_or_nan,
                                                     static_loss_scale_state,
                                                     update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (ONE_CYCLE,
                                                      LRScheduler,
                                                      build_schedule,
                                                      one_cycle_mom)
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing
from deepspeed_tpu_torch.runtime.optimizers import (ADAM_FAMILY,
                                                    ADAMW_OPTIMIZER,
                                                    ClientOptimizer,
                                                    FlatLayout,
                                                    build_optimizer,
                                                    state_tensors)
from deepspeed_tpu_torch.runtime.resilience import (
    COMMITTED, LEGACY, CheckpointCorruptError, CheckpointTransaction,
    DivergenceError, DivergenceSentinel, FaultInjector, PreemptionHandler,
    RetryPolicy, TrainingPreempted, atomic_write_text, build_manifest,
    fault_event, flatten_with_keystr, gc_tags, meta_event, poison_tree,
    retry_io, scan_tags, validate_tag, verify_restored)
from deepspeed_tpu_torch.runtime.zero.offload import (OFFLOAD_OPTIMIZERS,
                                                      PIPELINE_CHUNK,
                                                      HostOffloadOptimizer)
from deepspeed_tpu_torch.runtime.zero.param_stream import ParamStreamRunner
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)


def _world_size():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeepSpeedEngine:
    """``model``: a module with ``loss(batch, attn_backend=...)`` (the
    port's ``CausalTransformerLM``).  ``device``: the card unless the
    caller names another (the tests: ``"cpu"``); with no card it raises.
    ``backend``: "auto" (the kernels for CUDA tensors), "cuda" or "plain"
    (the plain versions of attention and Adam: the smoke test's
    comparison).  ``lr_scheduler``: a client schedule, an
    :class:`LRScheduler` or a callable on the 0-dim fp32 step (the config's
    ``scheduler`` block wins, as in the JAX engine).  ``optimizer``: a
    client optimizer, a ``torch.optim`` Optimizer class or a callable
    returning one, built over the fp32 master weights (the config's
    ``optimizer`` block wins).  ``training_data``: a dataset for
    :meth:`deepspeed_io` (``collate_fn`` for its batches).
    ``host_params``: under ``offload_param``, the parameters by module
    name as host tensors, which the stream's store takes instead of the
    module's own (a model built on ``"meta"`` needs them)."""

    _STREAM_ONLY = ("offload_param streaming runs whole optimizer steps; use "
                    "train_batch() (the 3-call API would re-stream the model "
                    "per call)")

    def __init__(self, model, config: DeepSpeedConfig, device=None,
                 backend="auto", lr_scheduler=None, training_data=None,
                 collate_fn=None, optimizer=None, host_params=None):
        if not callable(getattr(model, "loss", None)):
            raise TypeError("model must expose .loss(batch)")
        if _world_size() > 1:
            raise NotImplementedError("multi-rank data parallelism / ZeRO "
                                      "sharding is not ported yet (ROADMAP "
                                      "A8)")
        self.module = model
        self._config = config
        self.device = get_accelerator().resolve_device(device)
        self.backend = validate_backend(backend)
        # on the card a head dim the flash kernels do not take raises
        # here, before anything is allocated there
        if self.backend != "plain" and hasattr(model, "config"):
            check_trainable(model.config, self.device)
        if config.bfloat16_enabled:
            self.compute_dtype = torch.bfloat16
        elif config.fp16_enabled:
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.zero_stage = config.zero_config.stage

        # ---- flat state ---------------------------------------------
        self._names, self._params, spans = [], [], []
        off = 0
        for name, p in model.named_parameters():
            self._names.append(name)
            self._params.append(p)
            spans.append((off, p.numel(), p.shape))
            off += p.numel()
        self.num_params = off
        self._spans = spans
        self.grad_accum_dtype = (torch.bfloat16
                                 if config.grad_accum_dtype == "bfloat16"
                                 else torch.float32)
        self._param_stream = None
        if config.zero_config.offload_param_device != "none":
            self._init_param_stream_state(host_params, lr_scheduler)
            self._init_common(lr_scheduler, training_data, collate_fn)
            return
        if host_params is not None:
            raise ValueError("host_params are the parameter stream's "
                             "(zero_optimization.offload_param)")
        # ZeRO-Offload: the fp32 master (and the optimizer's state) on the
        # host, pageable; the card keeps the compute weights and gradients
        offload = config.zero_config.offload_optimizer_device != "none"
        self.master = torch.empty(off, dtype=torch.float32,
                                  device="cpu" if offload else self.device)
        self._compute = torch.empty(off, dtype=self.compute_dtype,
                                    device=self.device)
        self._master_views = []
        # from the card into pageable host memory through a pinned buffer:
        # a straight copy into pageable memory crawls
        bounce = (torch.empty(min(off, PIPELINE_CHUNK), pin_memory=True)
                  if offload and self.device.type == "cuda" else None)
        with torch.no_grad():
            for p, (o, n, shape) in zip(self._params, spans):
                mv = self.master[o:o + n].view(shape)
                if bounce is None:
                    mv.copy_(p.detach())
                else:
                    _copy_to_host(mv.view(-1), p.detach().reshape(-1),
                                  bounce)
                self._master_views.append(mv)
                # the compute weights are a cast of the master; repointing
                # the parameter frees the module's own weights one by one
                self._compute[o:o + n].copy_(p.detach().reshape(-1))
                p.data = self._compute[o:o + n].view(shape)
                p.grad = None
        self.grads = torch.zeros(off, dtype=self.grad_accum_dtype,
                                 device=self.device)
        self._grad_views = [self.grads[o:o + n].view(shape)
                            for o, n, shape in spans]

        # ---- optimizer and schedules --------------------------------
        self.optimizer, base_lr, schedule_fn = self._configure_optimizer(
            optimizer, lr_scheduler)
        # the JAX engine has no scheduler (None in client_state) without a
        # schedule; the port's host scheduler then reports the base lr
        self._has_schedule = schedule_fn is not None
        self._lr_at = schedule_fn or (lambda step: base_lr)
        self._offload = None
        if offload:
            # the host optimizer is the engine's (initialize returns it)
            self.optimizer = self._offload = self._init_offload()
            self.opt_state = None
        else:
            self.optimizer.bind(self._flat_layout())
            if isinstance(self.optimizer, ClientOptimizer):
                self.optimizer.build(self._master_views)
            self.opt_state = self.optimizer.init_state(self.master)
        self._init_common(lr_scheduler, training_data, collate_fn)

    def _init_common(self, lr_scheduler, training_data, collate_fn):
        """The rest of ``__init__``, shared with the parameter stream's:
        the host scheduler, the loss scale, the bookkeeping, the timers
        and the fault-tolerance layer."""
        config = self._config
        # the host-side scheduler get_lr reads (the JAX engine's: a client
        # LRScheduler as given, else one over the schedule or the base lr)
        self.lr_scheduler = (
            lr_scheduler if isinstance(lr_scheduler, LRScheduler) else
            LRScheduler(self._lr_at))

        # ---- loss scaling and overflow (device scalars) -------------
        fc = config.fp16_config
        if config.fp16_enabled and config.dynamic_loss_scale:
            self.loss_scale_state = dynamic_loss_scale_state(
                fc.initial_scale_power, hysteresis=fc.hysteresis,
                device=self.device)
        else:
            self.loss_scale_state = static_loss_scale_state(
                config.loss_scale if config.fp16_enabled else 1.0,
                device=self.device)
        self._no_overflow = torch.zeros((), dtype=torch.bool,
                                        device=self.device)
        self._overflow = self._no_overflow
        self.skipped_steps = torch.zeros((), dtype=torch.int32,
                                         device=self.device)

        # ---- host bookkeeping ---------------------------------------
        self.global_steps = 0
        self.micro_steps = 0     # three-call backward()s, as in JAX
        self._accum_count = 0
        self._step_applied = False
        self._global_grad_norm = None
        # gas as a device tensor, made once: dividing by it is an IEEE
        # division (PyTorch may turn a division by a host scalar into a
        # multiply by its reciprocal) and needs no copy to the card per step
        self._gas = torch.tensor(float(config.gradient_accumulation_steps),
                                 dtype=torch.float32, device=self.device)
        # the JAX engine's timers, on the card's clock there
        self.timers = SynchronizedWallClockTimer(device=self.device)
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print, device=self.device)
        self._breakdown = config.wall_clock_breakdown

        # ---- fault tolerance (runtime/resilience.py) -----------------
        rc = config.resilience_config
        self._resilience = rc
        self._injector = FaultInjector.from_config(rc.fault_injection)
        self._retry_policy = RetryPolicy.from_config(rc)
        self._last_good_ckpt = None   # (dir, tag) of last committed/loaded
        self.last_checkpoint_timing = {}
        self._preempt = None
        if rc.preemption_handler:
            self._preempt = PreemptionHandler().install()
        self._sentinel = None
        if rc.divergence_sentinel:
            self._sentinel = DivergenceSentinel(
                max_consecutive_skips=rc.max_consecutive_skips,
                interval=rc.sentinel_interval, action=rc.on_divergence)
        # the process's checkpoint engine, from checkpoint.engine (save and
        # load use whatever is current, as in the JAX engine)
        get_checkpoint_engine(config)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)

        # the activation checkpointing knobs (the JAX engine's
        # _configure_checkpointing)
        checkpointing.configure(deepspeed_config=config)

        log_dist(f"DeepSpeedEngine ready: zero_stage={self.zero_stage} "
                 f"dtype={self.compute_dtype} device={self.device} "
                 f"params={self.num_params} "
                 f"micro_batch={config.train_micro_batch_size_per_gpu} "
                 f"gas={config.gradient_accumulation_steps}", ranks=[0])

    def _init_param_stream_state(self, host_params, lr_scheduler):
        """ZeRO-Infinity's parameter offload (the JAX engine's
        ``_init_param_stream_state``): the host store and the stream over
        ``host_params`` (else the module's own parameters, copied), the
        optimizer one of :data:`OFFLOAD_OPTIMIZERS` (else the JAX engine's
        ``ValueError``), no flat buffer on the card; the module's
        parameters are released once the store holds them."""
        cfg = self._config
        oc = cfg.optimizer_config
        opt_name = (oc.type.lower() if oc is not None and oc.type
                    else ADAMW_OPTIMIZER)
        if opt_name not in OFFLOAD_OPTIMIZERS:
            raise ValueError(
                f"offload_param supports {sorted(OFFLOAD_OPTIMIZERS)}; got "
                f"'{opt_name}' (reference: ZeRO-Offload requires "
                "DeepSpeedCPUAdam/Adagrad)")
        if host_params is None:
            if any(p.device.type == "meta" for p in self._params):
                raise ValueError("a model built on 'meta' holds no weights: "
                                 "pass model_parameters")
            host_params = {n: p.detach()
                           for n, p in zip(self._names, self._params)}
        elif set(host_params) != set(self._names):
            raise ValueError(
                f"host_params do not match the model's parameters: missing "
                f"{sorted(set(self._names) - set(host_params))}, unexpected "
                f"{sorted(set(host_params) - set(self._names))}")
        self.master = self._compute = self.grads = None
        self._master_views, self._grad_views = [], []
        _, base_lr, schedule_fn = self._configure_optimizer(None,
                                                            lr_scheduler)
        self._has_schedule = schedule_fn is not None
        self._lr_at = schedule_fn or (lambda step: base_lr)
        self._param_stream = ParamStreamRunner(
            self.module, host_params, cfg, self.device,
            compute_dtype=self.compute_dtype,
            grad_accum_dtype=self.grad_accum_dtype, opt_name=opt_name,
            opt_params=dict(oc.params) if oc is not None else {},
            backend=self.backend)
        del host_params
        with torch.no_grad():
            for p in self._params:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
                p.grad = None
        self._offload = None
        self.optimizer = self._param_stream.store
        self.opt_state = None
        fc = cfg.fp16_config
        if cfg.fp16_enabled and cfg.dynamic_loss_scale:
            self._host_ls = HostLossScale(
                2.0 ** fc.initial_scale_power, dynamic=True,
                scale_window=fc.loss_scale_window,
                min_scale=fc.min_loss_scale, hysteresis=fc.hysteresis)
        else:
            self._host_ls = HostLossScale(
                cfg.loss_scale if cfg.fp16_enabled else 1.0, dynamic=False)
        runner = self._param_stream
        log_dist(f"param-stream offload: {runner.store.num_params():,} "
                 f"params host-resident, {runner.n_layers} layers streamed "
                 f"({runner.resident_layers} pinned), device="
                 f"{cfg.zero_config.offload_param_device}", ranks=[0])

    def _flat_layout(self):
        """The flat buffers' :class:`FlatLayout`: one span a parameter, the
        layers' copies of one weight in one leaf (the JAX model's stacked
        ``layers`` leaves)."""
        leaf_ids = {}
        leaves = []
        for name in self._names:
            parts = name.split(".")
            if parts[0] == "layers" and len(parts) > 2:
                name = "layers." + ".".join(parts[2:])
            leaves.append(leaf_ids.setdefault(name, len(leaf_ids)))
        return FlatLayout([n for _, n, _ in self._spans], leaves,
                          self.device)

    def _configure_optimizer(self, client_optimizer, client_scheduler):
        """(optimizer, base lr, schedule or None), in the JAX engine's
        precedence: the config's ``scheduler`` block, else a client
        :class:`LRScheduler`'s schedule, else a client callable; the
        schedule becomes the built-in optimizer's lr, and OneCycle also
        cycles the Adam family's beta1.  The config's ``optimizer`` wins
        over a client one; a name the registry does not know falls back to
        the client's with a warning; a client optimizer keeps its own lr
        (a ``scheduler`` block is then ignored, with a warning)."""
        cfg = self._config
        sc = cfg.scheduler_config
        schedule_fn = None
        if sc is not None and sc.type:
            schedule_fn = build_schedule(sc.type, sc.params)
        elif isinstance(client_scheduler, LRScheduler):
            schedule_fn = client_scheduler.schedule_fn
        elif callable(client_scheduler):
            schedule_fn = client_scheduler
        elif client_scheduler is not None:
            raise TypeError(f"lr_scheduler must be an LRScheduler or a "
                            f"callable, got {type(client_scheduler)}")
        oc = cfg.optimizer_config
        if oc is not None and oc.type:
            name, params = oc.type, dict(oc.params)
        elif client_optimizer is not None:
            if schedule_fn is not None and sc is not None:
                logger.warning("scheduler config ignored: client optimizer "
                               "owns its learning rate")
            return ClientOptimizer(client_optimizer), 0.0, schedule_fn
        else:   # the JAX engine's default: AdamW at lr 1e-3
            name, params = ADAMW_OPTIMIZER, {"lr": 1e-3}
        base_lr = params.get("lr", 1e-3)
        if schedule_fn is not None:
            params["lr"] = schedule_fn
        if sc is not None and sc.type == ONE_CYCLE and \
                name.lower() in ADAM_FAMILY:
            mom_fn = one_cycle_mom(sc.params)
            if mom_fn is not None:
                params["_b1_schedule"] = mom_fn
        try:
            opt = build_optimizer(name, params)
        except ValueError:
            if client_optimizer is None:
                raise
            logger.warning(f"optimizer '{name}' is not built in; using the "
                           f"client-supplied optimizer instead")
            opt = ClientOptimizer(client_optimizer)
        return opt, base_lr, schedule_fn

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _to_device(self, x):
        t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def _batch_to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        return self._to_device(batch)

    def _micro_batches(self, batch, gas):
        """Split a [gas, B, S] batch (or a dict of them) into gas micro
        batches; with gas 1 the batch is one [B, S] micro-batch."""
        batch = self._batch_to_device(batch)
        if gas == 1:
            return [batch]
        if isinstance(batch, dict):
            return [{k: v[i] for k, v in batch.items()} for i in range(gas)]
        return [batch[i] for i in range(gas)]

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @property
    def _fp16(self):
        return self._config.fp16_enabled

    def _scaled_backward(self, loss):
        """Backward of ``loss`` (fp32) times the loss scale under fp16
        (``_model_scaled_loss``); of the loss itself otherwise, where the
        JAX engine's scale is 1."""
        if self._fp16:
            loss = loss * self.loss_scale_state.cur_scale
        loss.backward()

    def _accumulate_grads(self, divisor=None):
        """Add every parameter's gradient (compute dtype) into the flat
        gradient buffer -- under fp16 unscaled first, in fp32, and cast to
        the buffer's dtype (``_loss_and_grads``) -- divided by ``divisor``
        (a 0-dim fp32 tensor) when given, and release it."""
        scale = self.loss_scale_state.cur_scale if self._fp16 else None
        fp32 = self.grad_accum_dtype == torch.float32
        with torch.no_grad():
            for p, g in zip(self._params, self._grad_views):
                if p.grad is None:
                    continue
                if divisor is None and scale is None:
                    # a bf16 buffer adds the gradient rounded to bf16
                    g.add_(p.grad if fp32 else p.grad.to(g.dtype))
                elif divisor is None and fp32:
                    # g + grad / scale in fp32: one pass, the same roundings
                    g.addcdiv_(p.grad, scale)
                else:
                    grad = p.grad.float()
                    if scale is not None:
                        grad = grad / scale
                    grad = grad.to(g.dtype)
                    g.add_(grad if divisor is None else grad / divisor)
                p.grad = None
        self._accum_count += 1

    def _apply_update(self, divisor=None):
        """The accumulated gradients divided by ``divisor`` when given;
        under fp16 the overflow flag (inf or nan anywhere); the fp32 global
        norm; clipping; one fused Adam launch that writes nothing on
        overflow; the loss-scale automaton and the skipped count; master
        -> module (``_finish_step`` / ``_apply_update``)."""
        cfg = self._config
        with torch.no_grad():
            g = self.grads
            if divisor is not None:
                g.div_(divisor)
            overflow = has_inf_or_nan(g) if self._fp16 else self._no_overflow
            # fp32 whatever the gradients' dtype (_global_norm_f32)
            norm = torch.linalg.vector_norm(g, dtype=torch.float32)
            clip = float(cfg.gradient_clipping or 0.0)
            if self._offload is not None:
                self._offload_host_apply(g, overflow, norm, clip)
            else:
                if clip > 0:
                    g.mul_(torch.clamp(clip / (norm + 1e-6),
                                       max=1.0).to(g.dtype))
                self.opt_state = self.optimizer.step(
                    self.master, g, self.opt_state,
                    skip=overflow.to(torch.int32) if self._fp16 else None,
                    backend=self.backend)
                self._compute.copy_(self.master)
            if self._fp16:
                fc = cfg.fp16_config
                self.loss_scale_state = update_scale(
                    self.loss_scale_state, overflow,
                    dynamic=cfg.dynamic_loss_scale,
                    scale_window=fc.loss_scale_window,
                    min_scale=fc.min_loss_scale, hysteresis=fc.hysteresis)
                self.skipped_steps.add_(overflow.to(torch.int32))
            g.zero_()
        self._overflow = overflow
        self._global_grad_norm = norm
        self._accum_count = 0
        self._step_applied = True
        self.global_steps += 1
        self.lr_scheduler.step()

    def _init_offload(self):
        """The host optimizer of ZeRO-Offload (``runtime/zero/offload.py``)
        over the host master: the config's optimizer (adamw when it names
        none), one of :data:`OFFLOAD_OPTIMIZERS`, else the JAX engine's
        ``ValueError``."""
        cfg = self._config
        oc = cfg.optimizer_config
        name = (oc.type.lower() if oc is not None and oc.type
                else ADAMW_OPTIMIZER)
        if name not in OFFLOAD_OPTIMIZERS:
            raise ValueError(
                f"offload_optimizer supports {sorted(OFFLOAD_OPTIMIZERS)}; "
                f"got '{name}' (reference: ZeRO-Offload requires "
                "DeepSpeedCPUAdam/Adagrad)")
        return HostOffloadOptimizer(
            self.master, cfg.zero_config, opt_name=name,
            opt_params=dict(oc.params) if oc is not None else {})

    def _offload_host_apply(self, g, overflow, norm, clip):
        """The host tail of an offload step (the JAX engine's
        ``_offload_host_apply``): the overflow flag read to the host under
        fp16 only; unless it is set, the lr of the schedule at
        ``global_steps`` (skipped steps counted, the JAX offload path's
        rule), the clip coefficient ``clip / (norm + 1e-6)`` when the norm
        exceeds ``clip``, and the pipelined host step, which writes the
        new weights into the compute buffer."""
        if self._fp16 and bool(overflow):
            return
        lr = float(self._lr_at(self.global_steps))
        coef = None
        if clip > 0:
            gn = float(norm)
            if gn > clip:
                coef = clip / (gn + 1e-6)
        self._offload.step_streamed(g, lr=lr, clip_coef=coef,
                                    out=self._compute)

    def _micro_step(self, mb):
        loss = self.module.loss(mb, attn_backend=self.backend)
        self._scaled_backward(loss)
        self._accumulate_grads()
        return loss.detach()

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over gas micro-batches.  ``batch``: a dict
        with ``input_ids`` [gas, B, S] ([B, S] when gas is 1; optional
        ``labels`` / ``loss_mask`` alike) or a raw token array;
        ``data_iter``: an iterator of micro-batches, gas of which it takes;
        neither: a fresh iterator over ``training_data`` on every call, as
        the JAX engine's synchronous loader does (so every such call reads
        the same first gas micro-batches).  Returns the mean loss over the
        micro-batches (a device scalar).  The preemption handler is polled
        before and after the step, the divergence sentinel after it."""
        if self._preempt is not None and self._preempt.requested:
            self._handle_preemption()
        loss = self._train_batch_inner(data_iter, batch)
        # the sentinel first (its restore clears state a preemption save
        # would persist), then a preemption signalled during the step
        if self._sentinel is not None:
            self._handle_sentinel()
        if self._preempt is not None and self._preempt.requested:
            self._handle_preemption()
        return loss

    def _train_batch_inner(self, data_iter, batch):
        if self._accum_count:
            raise RuntimeError("train_batch called with gradients of an "
                               "unfinished forward/backward/step cycle")
        gas = self._config.gradient_accumulation_steps
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch needs data_iter, batch= or "
                                     "training_data")
                data_iter = iter(self.training_dataloader)
            micro_batches = [self._batch_to_device(next(data_iter))
                             for _ in range(gas)]
        else:
            micro_batches = self._micro_batches(batch, gas)
        self.tput_timer.start()
        if self._injector is not None and \
                self._injector.poison_grads(self.global_steps):
            # the deterministic divergence trigger: NaN the float inputs,
            # or (a token batch has none) the weights this step computes
            # with, so its gradients go non-finite
            micro_batches, n_poisoned = poison_tree(micro_batches)
            if n_poisoned == 0:
                poison_tree(self._compute if self._param_stream is None
                            else self._param_stream.resident_dev)
            logger.warning(f"fault injector: poisoned gradients at step "
                           f"{self.global_steps}")
        if self._param_stream is not None:
            loss = self._param_stream_step(micro_batches, gas)
        else:
            lsum = None
            for mb in micro_batches:
                loss = self._micro_step(mb)
                lsum = loss if lsum is None else lsum + loss
            # the sum of the micro-batches' gradients, divided once
            # (``_forward_grads``)
            self._apply_update(self._gas if gas > 1 else None)
            loss = lsum / gas
        if self._sentinel is not None:
            # device tensors only: the sentinel reads them back in one
            # copy every ``sentinel_interval`` steps
            self._sentinel.push(self.global_steps, loss=loss,
                                overflow=self._overflow)
        self.tput_timer.stop(global_step=True)
        return loss

    def _param_stream_step(self, micro_batches, gas):
        """One streamed step (the JAX engine's ``train_batch`` branch): lr
        from the host ``global_steps`` and the scale from the host mirror,
        neither read from the card; the device automaton and the skipped
        count follow the overflow in lockstep."""
        cfg = self._config
        fp16 = self._fp16
        lr = float(self._lr_at(self.global_steps))
        scale = self._host_ls.cur_scale if fp16 else 1.0
        loss, norm, overflow = self._param_stream.train_step(
            micro_batches, gas, lr, scale, fp16,
            float(cfg.gradient_clipping or 0.0))
        flag = torch.tensor(overflow, device=self.device)
        if fp16:
            fc = cfg.fp16_config
            self.loss_scale_state = update_scale(
                self.loss_scale_state, flag, dynamic=cfg.dynamic_loss_scale,
                scale_window=fc.loss_scale_window,
                min_scale=fc.min_loss_scale, hysteresis=fc.hysteresis)
            self._host_ls.update(overflow)
            self.skipped_steps.add_(int(overflow))
        self._overflow = flag
        self._global_grad_norm = norm
        self._step_applied = True
        self.global_steps += 1
        self.lr_scheduler.step()
        return loss

    # ------------------------------------------------------------------
    # the three-call API
    # ------------------------------------------------------------------
    def _no_three_calls(self):
        if self._param_stream is not None:
            raise NotImplementedError(self._STREAM_ONLY)

    def forward(self, batch):
        """Loss of one micro-batch ([B, S] ids or a dict), with its graph
        kept for :meth:`backward`."""
        self._no_three_calls()
        if self._breakdown:
            self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self.module.loss(self._batch_to_device(batch),
                                attn_backend=self.backend)
        if self._breakdown:
            self.timers(FORWARD_GLOBAL_TIMER).stop()
        return loss

    __call__ = forward

    def backward(self, loss):
        """Backpropagate ``loss`` (times the loss scale under fp16) and add
        its gradients, unscaled and divided by gas, into the flat fp32
        buffer: the order of the JAX engine's ``backward``, which divides
        each micro-batch before summing (``train_batch`` sums, then divides
        once, as the JAX one does)."""
        self._no_three_calls()
        if self._breakdown:
            self.timers(BACKWARD_GLOBAL_TIMER).start()
        self._scaled_backward(loss)
        self._accumulate_grads(self._gas)
        self.micro_steps += 1
        if self._breakdown:
            self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def is_gradient_accumulation_boundary(self):
        return self._accum_count >= self._config.gradient_accumulation_steps

    def step(self):
        """Apply the update at the gradient-accumulation boundary; with
        ``wall_clock_breakdown``, log the fwd / bwd / step times every
        ``steps_per_print`` steps, as the JAX ``step`` does."""
        self._no_three_calls()
        self._step_applied = False
        if not self.is_gradient_accumulation_boundary():
            return
        if self._breakdown:
            self.timers(STEP_GLOBAL_TIMER).start()
        self._apply_update()
        if self._breakdown:
            self.timers(STEP_GLOBAL_TIMER).stop()
            if self.global_steps % self._config.steps_per_print == 0:
                self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                                 STEP_GLOBAL_TIMER])

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------
    def get_global_grad_norm(self):
        n = self._global_grad_norm
        return None if n is None else float(n)

    def get_lr(self):
        """The host scheduler's lr, stepped every batch (skipped ones
        too), as the JAX engine reports it."""
        return self.lr_scheduler.get_lr()

    def get_loss_scale(self):
        return float(self.loss_scale_state.cur_scale)

    @property
    def cur_scale(self):
        return self.get_loss_scale()

    def applied_steps(self):
        """Steps whose update was applied (host read of the device count;
        under offload the host optimizer's count)."""
        if self._offload is not None:
            return self._offload.step_count
        if self._param_stream is not None:
            return self._param_stream.store.step_count
        return int(self.opt_state.count)

    def last_step_overflowed(self):
        """Whether the last update was skipped for an fp16 overflow (host
        read of the device flag)."""
        return bool(self._overflow)

    def was_step_applied(self):
        """True once an update ran at the accumulation boundary, skipped
        or not: the JAX engine's host flag, which reads no device value
        (an fp16 skip shows in :meth:`last_step_overflowed`)."""
        return self._step_applied

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def train_batch_size(self):
        return self._config.train_batch_size

    def module_state_dict(self):
        """The fp32 master parameters, by module name, copied to the
        host."""
        if self._param_stream is not None:
            return self._param_stream.named_params()
        return {n: v.detach().cpu().clone()
                for n, v in zip(self._names, self._master_views)}

    def eval_batch(self, batch):
        """The loss of ``batch`` ([B, S] ids or a dict) under no_grad, with
        the compute-dtype weights the training forward sees (the JAX
        ``eval_batch``); a device scalar."""
        if self._param_stream is not None:
            return self._param_stream.eval_loss(self._batch_to_device(batch))
        with torch.no_grad():
            return self.module.loss(self._batch_to_device(batch),
                                    attn_backend=self.backend)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None,
                     num_local_io_workers=None):
        """A :class:`DeepSpeedDataLoader` over ``dataset``: global batches
        of ``batch_size`` (default: the micro-batch times the world size,
        1) in the config seed's order, numpy until the engine moves them;
        ``num_local_io_workers`` threads fetch each batch's samples."""
        if batch_size is None:
            batch_size = (self.train_micro_batch_size_per_gpu() *
                          _world_size())
        return DeepSpeedDataLoader(dataset, batch_size=batch_size,
                                   collate_fn=collate_fn,
                                   seed=self._config.seed,
                                   num_workers=num_local_io_workers or 0)

    # ------------------------------------------------------------------
    # fault tolerance (runtime/resilience.py)
    # ------------------------------------------------------------------
    def _shutdown_workers(self):
        """Stop the training loader's fetch threads."""
        if self.training_dataloader is not None:
            self.training_dataloader.close()

    def _handle_preemption(self):
        """Step-boundary answer to SIGTERM / SIGINT: an emergency
        checkpoint into ``resilience.ckpt_dir`` when it is set, the
        workers stopped, then :class:`TrainingPreempted`."""
        rc = self._resilience
        tag = f"emergency_step{self.global_steps}" if rc.ckpt_dir else None
        if tag is not None:
            try:
                self.save_checkpoint(rc.ckpt_dir, tag=tag)
            except Exception as exc:
                logger.error(f"emergency checkpoint failed: {exc!r}")
                tag = None
        self._shutdown_workers()
        fault_event(None, "fault/preempted", step=self.global_steps,
                    attrs={"tag": tag, "dir": rc.ckpt_dir or None})
        self._preempt.uninstall()
        self._preempt.clear()
        where = f"; emergency checkpoint {rc.ckpt_dir}/{tag}" if tag else ""
        raise TrainingPreempted(
            f"training preempted at step {self.global_steps}{where}")

    def _handle_sentinel(self):
        """Act on a tripped divergence sentinel: restore the last good
        checkpoint when configured and one exists, else halt with
        :class:`DivergenceError`."""
        action = self._sentinel.poll()
        if action is None:
            return
        if action == "restore" and self._last_good_ckpt is not None:
            load_dir, tag = self._last_good_ckpt
            logger.warning(
                f"divergence ({self._sentinel.reason} at step "
                f"{self._sentinel.trip_step}): auto-restoring {load_dir}/{tag}")
            self.load_checkpoint(load_dir, tag=tag)
            fault_event(None, "fault/auto_restore", step=self.global_steps,
                        attrs={"dir": load_dir, "tag": tag,
                               "reason": self._sentinel.reason})
            self._sentinel.reset()
            return
        reason, step = self._sentinel.reason, self._sentinel.trip_step
        self._shutdown_workers()
        raise DivergenceError(
            f"training diverged at step {step}: {reason} "
            f"(no checkpoint to restore)" if action == "restore" else
            f"training diverged at step {step}: {reason}")

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _ckpt_state(self):
        """The state a checkpoint holds: the named device buffers (the
        optimizer's by :func:`state_tensors`: Adam's ``m``, ``v`` and
        ``count`` keep the names of earlier tags)."""
        ls = self.loss_scale_state
        # the parameter stream's master and any host optimizer's state are
        # the sidecars'
        master = ({} if self._param_stream is not None
                  else {"master": self.master})
        opt = {} if self.opt_state is None else state_tensors(self.opt_state)
        return {**master, **opt,
                "loss_scale": {"cur_scale": ls.cur_scale,
                               "cur_hysteresis": ls.cur_hysteresis,
                               "last_overflow_iter": ls.last_overflow_iter,
                               "iteration": ls.iteration},
                "skipped_steps": self.skipped_steps}

    def _ckpt_layout(self):
        """Where each parameter lies in the flat buffers (``layout.json``):
        a checkpoint loads only into an engine with the same layout."""
        return {"params": [[n, o, list(shape)] for n, (o, _, shape)
                           in zip(self._names, self._spans)],
                "numel": self.num_params,
                "compute_dtype": str(self.compute_dtype).replace("torch.",
                                                                 ""),
                "zero_stage": self.zero_stage}

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Save the training state as ``save_dir/tag`` (default tag
        ``global_step<N>``).  With ``resilience.enabled`` (the default)
        through the durable protocol: the payload into ``.{tag}.tmp``, the
        manifest and commit marker, the rename, all under the retry policy
        (fault-injection site ``ckpt_save``), then ``latest`` (site
        ``fs``) and the keep-last retention; else in place, the legacy
        layout."""
        t0 = time.perf_counter()
        eng = get_checkpoint_engine()
        tag = tag or f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state.update({
            "global_steps": self.global_steps,
            "skipped_steps": int(self.skipped_steps),
            "micro_steps": self.micro_steps,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self._has_schedule else None),
        })
        if isinstance(self.optimizer, ClientOptimizer):
            client_state["client_optimizer"] = self.optimizer.host_state()
        state, layout = self._ckpt_state(), self._ckpt_layout()
        rc = self._resilience
        if not rc.enabled:
            eng.save(state, save_dir, tag, client_state=client_state,
                     layout=layout)
            if self._offload is not None:
                self._offload.save(save_dir, tag)
            if self._param_stream is not None:
                self._param_stream.save(save_dir, tag)
            if save_latest:
                with open(os.path.join(save_dir, "latest"), "w") as f:
                    f.write(tag)
            return True
        txn = CheckpointTransaction(save_dir, tag)

        def _attempt():
            txn.begin()
            staged = eng.save(state, save_dir, txn.tmp_tag,
                              client_state=client_state, layout=layout)
            # the offload sidecar goes into the tmp tag: the manifest
            # lists it
            if self._offload is not None:
                self._offload.save(save_dir, txn.tmp_tag)
            if self._param_stream is not None:
                self._param_stream.save(save_dir, txn.tmp_tag)
            # an async engine finishes its background write here: the
            # commit marker never precedes the payload
            eng.commit(txn.tmp_tag)
            # the manifest's checksums read the host copies just written
            return txn.commit(build_manifest(
                unflatten(dict(staged), state), tag, self.global_steps,
                checksum=rc.checksum))

        retry_io(_attempt, self._retry_policy, op=f"ckpt_save[{tag}]",
                 injector=self._injector, site="ckpt_save",
                 cleanup=txn.abort)
        t_commit = time.perf_counter()
        self._last_good_ckpt = (save_dir, tag)
        if save_latest:
            retry_io(lambda: atomic_write_text(
                os.path.join(save_dir, "latest"), tag),
                self._retry_policy, op=f"latest[{tag}]",
                injector=self._injector, site="fs")
        if rc.keep_last > 0:
            gc_tags(save_dir, rc.keep_last, protect=(tag,))
        meta_event(None, "ckpt/committed",
                   {"dir": os.path.abspath(save_dir), "tag": tag,
                    "step": self.global_steps})
        self.last_checkpoint_timing = dict(
            eng.last_timing, committed_s=t_commit - t0,
            returned_s=time.perf_counter() - t0)
        return True

    def _load_candidates(self, load_dir, tag):
        """The tags to try, in order: ``[(tag, status, manifest,
        is_fallback)]``.  An explicit ``tag`` is loaded or refused, never
        substituted; with ``tag=None`` the ``latest`` pointer comes first,
        then every other COMMITTED tag, newest first."""
        if tag is not None:
            status, manifest = validate_tag(os.path.join(load_dir, tag))
            if status == LEGACY:
                logger.warning(f"checkpoint {load_dir}/{tag} predates the "
                               "durable-commit protocol; loading unvalidated")
            elif status != COMMITTED:
                raise CheckpointCorruptError(
                    f"checkpoint {load_dir}/{tag} failed validation: "
                    f"{status}")
            return [(tag, status, manifest, False)]
        latest_tag = _read_latest(load_dir)
        tags = scan_tags(load_dir)
        by_tag = {t: (s, m) for t, s, m in tags}
        out = []
        if latest_tag:
            status, manifest = by_tag.get(latest_tag, (None, None))
            if status is None:
                status, manifest = validate_tag(
                    os.path.join(load_dir, latest_tag))
            if status in (COMMITTED, LEGACY):
                out.append((latest_tag, status, manifest, False))
            else:
                logger.error(f"latest checkpoint {load_dir}/{latest_tag} is "
                             f"{status}; scanning for newest valid tag")
        for t, s_, m in tags:
            if s_ == COMMITTED and t != latest_tag:
                out.append((t, s_, m, True))
        return out

    def _read_tag(self, eng, load_dir, tag, keys):
        """The host copies of tag ``tag``'s buffers (``keys`` only, when
        given) and its client_state, after checking its layout."""
        layout_path = os.path.join(load_dir, tag, LAYOUT_NAME)
        with open(layout_path) as f:
            saved = json.load(f).get("params")
        if saved != self._ckpt_layout()["params"]:
            raise ValueError(f"{layout_path}: the checkpoint's parameters "
                             f"are not this model's")
        return eng.load(self._ckpt_state(), load_dir, tag, keys=keys)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_strict=True, load_module_only=False):
        """Load ``load_dir/tag`` (default: ``latest``, falling back to the
        newest committed tag when it is torn or missing).  Every buffer is
        read and checked on the host before any is written to the card;
        ``load_module_only`` or ``load_optimizer_states=False`` restores
        the master weights alone (``load_module_strict`` is accepted, as in
        the JAX engine: the names must match).  Returns ``(load_dir,
        client_state)``, or ``(None, {})`` when there is nothing to
        load."""
        eng = get_checkpoint_engine()
        rc = self._resilience
        if not rc.enabled:
            if tag is None:
                tag = _read_latest(load_dir)
                if tag is None:
                    logger.warning(f"no 'latest' file at {load_dir}")
                    return None, {}
            candidates = [(tag, LEGACY, None, False)]
        else:
            candidates = self._load_candidates(load_dir, tag)
            if not candidates:
                logger.warning(f"no loadable checkpoint under {load_dir}")
                return None, {}
        keys = (None if load_optimizer_states and not load_module_only
                else {"['master']"})
        host = client_state = chosen = last_exc = None
        for cand_tag, status, manifest, is_fallback in candidates:
            if is_fallback:
                fault_event(None, "fault/ckpt_fallback",
                            attrs={"dir": os.path.abspath(load_dir),
                                   "to": cand_tag,
                                   "step": (manifest or {}).get(
                                       "global_step")})
                logger.warning(f"falling back to checkpoint {cand_tag}")
            try:
                def _attempt():
                    return self._read_tag(eng, load_dir, cand_tag, keys)
                if rc.enabled:
                    host, client_state = retry_io(
                        _attempt, self._retry_policy,
                        op=f"ckpt_load[{cand_tag}]",
                        injector=self._injector, site="ckpt_load")
                else:
                    host, client_state = _attempt()
                verify_restored(host, manifest)
                chosen = cand_tag
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:
                last_exc = exc
                logger.error(f"loading checkpoint {load_dir}/{cand_tag} "
                             f"failed: {exc!r}")
        if chosen is None:
            if last_exc is not None:
                raise last_exc
            logger.warning(f"no loadable checkpoint under {load_dir}")
            return None, {}
        flat = dict(flatten_with_keystr(host))
        with torch.no_grad():
            for key, dst in flatten_with_keystr(self._ckpt_state()):
                if key in flat:
                    dst.copy_(flat[key], non_blocking=True)
            # the offload sidecar: master, moments and step count; with
            # load_optimizer_states=False the master alone comes back, the
            # moments and count stay as they were
            if self._offload is not None and keys is None:
                self._offload.load(load_dir, chosen)
            if self._param_stream is not None:
                # the host masters (and with the optimizer's state the
                # moments and count), then the card's copies
                if not self._param_stream.load(
                        load_dir, chosen,
                        load_optimizer_states=keys is None):
                    logger.warning(f"no param-stream host state in "
                                   f"checkpoint {load_dir}/{chosen}; host "
                                   f"params unchanged")
                ls = self.loss_scale_state
                self._host_ls.load(float(ls.cur_scale),
                                   int(ls.cur_hysteresis),
                                   int(ls.last_overflow_iter),
                                   int(ls.iteration))
            else:
                # the compute-dtype weights are a cast of the master
                self._compute.copy_(self.master)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the host copies are reused
        self.global_steps = client_state.get("global_steps", 0)
        self.micro_steps = client_state.get("micro_steps", 0)
        if load_lr_scheduler_states and client_state.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(client_state["lr_scheduler"])
        if keys is None and isinstance(self.optimizer, ClientOptimizer) and \
                client_state.get("client_optimizer") is not None:
            self.optimizer.load_host_state(client_state["client_optimizer"])
        if rc.enabled:
            self._last_good_ckpt = (load_dir, chosen)
        return load_dir, client_state


def _copy_to_host(dst, src, bounce):
    """``dst`` (a host tensor) = ``src`` (on the card), a pinned ``bounce``
    buffer's length at a time."""
    src = src.float()
    for a in range(0, src.numel(), bounce.numel()):
        b = min(a + bounce.numel(), src.numel())
        piece = bounce[:b - a]
        piece.copy_(src[a:b])
        dst[a:b].copy_(piece)


def _read_latest(ckpt_dir):
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return f.read().strip()
    return None
