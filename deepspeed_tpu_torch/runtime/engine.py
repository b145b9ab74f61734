"""Training engine: a ``DeepSpeedEngine`` subset for one card.

Counterpart of ``deepspeed_tpu/runtime/engine.py``.  State, as the JAX
engine keeps it but laid out for eager PyTorch:

* fp32 master parameters, fp32 gradients and the fp32 Adam moments m and
  v, each ONE flat buffer on the card (16 bytes per parameter);
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
gradient, unscaled in fp32, into the flat fp32 buffer (``_forward_grads``:
fp32 sum, then divided by gas), then the update of ``_apply_update``:
overflow = inf or nan in the flat gradients (fp16 only), the fp32 global
norm, clipping when ``gradient_clipping`` > 0 (``clip_f32``), the schedules
at the applied count into Adam's scalar buffer, ONE ``fused_adam`` launch
over the flat buffer that writes nothing when the step overflowed, the
loss-scale automaton, and the master copied into the module.
``forward``/``backward``/``step`` share that accumulation and update;
``backward`` divides each micro-batch by gas before adding it, in the
order of the JAX ``backward``.  Nothing on the step path reads a value
back to the host: the loss, the grad norm, the overflow flag, the scale
and the counts stay device tensors until a caller asks.  The host's
``global_steps`` and its ``LRScheduler`` (``get_lr``) advance every batch,
skipped or not, as the JAX engine's do; so after a skipped step
``get_lr`` runs ahead of the lr the update used, which follows the applied
count (the JAX engine behaves the same way).

Not ported yet (each raises naming its ROADMAP item): checkpoints and
data loading (A10), multi-rank ZeRO (A8).
"""

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.ops.decode_attention import validate_backend
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.loss_scaler import (dynamic_loss_scale_state,
                                                     has_inf_or_nan,
                                                     static_loss_scale_state,
                                                     update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (ONE_CYCLE,
                                                      LRScheduler,
                                                      build_schedule,
                                                      one_cycle_mom)
from deepspeed_tpu_torch.runtime.optimizers import (ADAMW_OPTIMIZER,
                                                    build_optimizer)
from deepspeed_tpu_torch.utils.logging import log_dist


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
    ``scheduler`` block wins, as in the JAX engine)."""

    def __init__(self, model, config: DeepSpeedConfig, device=None,
                 backend="auto", lr_scheduler=None):
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
        self.master = torch.empty(off, dtype=torch.float32,
                                  device=self.device)
        self.grads = torch.zeros(off, dtype=torch.float32, device=self.device)
        self._compute = torch.empty(off, dtype=self.compute_dtype,
                                    device=self.device)
        self._master_views, self._grad_views = [], []
        with torch.no_grad():
            for p, (o, n, shape) in zip(self._params, spans):
                mv = self.master[o:o + n].view(shape)
                mv.copy_(p.detach())
                self._master_views.append(mv)
                self._grad_views.append(self.grads[o:o + n].view(shape))
                p.data = self._compute[o:o + n].view(shape)
                p.grad = None
            self._compute.copy_(self.master)

        # ---- optimizer and schedules --------------------------------
        self.optimizer, base_lr, schedule_fn = self._configure_optimizer(
            lr_scheduler)
        self.opt_state = self.optimizer.init_state(self.master)
        # the host-side scheduler get_lr reads (the JAX engine's: a client
        # LRScheduler as given, else one over the schedule or the base lr)
        self.lr_scheduler = (
            lr_scheduler if isinstance(lr_scheduler, LRScheduler) else
            LRScheduler(schedule_fn or (lambda step: base_lr)))

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
        self._accum_count = 0
        self._step_applied = False
        self._global_grad_norm = None
        # gas as a device tensor, made once: dividing by it is an IEEE
        # division (PyTorch may turn a division by a host scalar into a
        # multiply by its reciprocal) and needs no copy to the card per step
        self._gas = torch.tensor(float(config.gradient_accumulation_steps),
                                 dtype=torch.float32, device=self.device)
        log_dist(f"DeepSpeedEngine ready: zero_stage={self.zero_stage} "
                 f"dtype={self.compute_dtype} device={self.device} "
                 f"params={self.num_params} "
                 f"micro_batch={config.train_micro_batch_size_per_gpu} "
                 f"gas={config.gradient_accumulation_steps}", ranks=[0])

    def _configure_optimizer(self, client_scheduler):
        """(optimizer, base lr, schedule or None), in the JAX engine's
        precedence: the config's ``scheduler`` block, else a client
        :class:`LRScheduler`'s schedule, else a client callable; the
        schedule becomes Adam's lr, and OneCycle also cycles beta1."""
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
        else:   # the JAX engine's default: AdamW at lr 1e-3
            name, params = ADAMW_OPTIMIZER, {"lr": 1e-3}
        base_lr = params.get("lr", 1e-3)
        if schedule_fn is not None:
            params["lr"] = schedule_fn
        if sc is not None and sc.type == ONE_CYCLE:
            mom_fn = one_cycle_mom(sc.params)
            if mom_fn is not None:
                params["_b1_schedule"] = mom_fn
        return build_optimizer(name, params), base_lr, schedule_fn

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
        fp32 buffer -- under fp16 unscaled first, in fp32 (``_loss_and_
        grads``) -- divided by ``divisor`` (a 0-dim fp32 tensor) when
        given, and release it."""
        scale = self.loss_scale_state.cur_scale if self._fp16 else None
        with torch.no_grad():
            for p, g in zip(self._params, self._grad_views):
                if p.grad is None:
                    continue
                if divisor is None and scale is None:
                    g.add_(p.grad)
                elif divisor is None:
                    # g + grad / scale in fp32: one pass, the same roundings
                    g.addcdiv_(p.grad, scale)
                else:
                    grad = p.grad.float()
                    if scale is not None:
                        grad = grad / scale
                    g.add_(grad / divisor)
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
            norm = torch.linalg.vector_norm(g)
            clip = float(cfg.gradient_clipping or 0.0)
            if clip > 0:
                g.mul_(torch.clamp(clip / (norm + 1e-6), max=1.0))
            self.opt_state = self.optimizer.step(
                self.master, g, self.opt_state,
                skip=overflow.to(torch.int32) if self._fp16 else None,
                backend=self.backend)
            if self._fp16:
                fc = cfg.fp16_config
                self.loss_scale_state = update_scale(
                    self.loss_scale_state, overflow,
                    dynamic=cfg.dynamic_loss_scale,
                    scale_window=fc.loss_scale_window,
                    min_scale=fc.min_loss_scale, hysteresis=fc.hysteresis)
                self.skipped_steps.add_(overflow.to(torch.int32))
            self._compute.copy_(self.master)
            g.zero_()
        self._overflow = overflow
        self._global_grad_norm = norm
        self._accum_count = 0
        self._step_applied = True
        self.global_steps += 1
        self.lr_scheduler.step()

    def _micro_step(self, mb):
        loss = self.module.loss(mb, attn_backend=self.backend)
        self._scaled_backward(loss)
        self._accumulate_grads()
        return loss.detach()

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over gas micro-batches.  ``batch``: a dict
        with ``input_ids`` [gas, B, S] ([B, S] when gas is 1; optional
        ``labels`` / ``loss_mask`` alike) or a raw token array.  Returns
        the mean loss over the micro-batches (a device scalar).  Data
        iterators are not ported yet (ROADMAP A10)."""
        if batch is None or data_iter is not None:
            raise NotImplementedError("train_batch takes batch=; data "
                                      "iterators, training_data and "
                                      "deepspeed_io are not ported yet "
                                      "(ROADMAP A10)")
        if self._accum_count:
            raise RuntimeError("train_batch called with gradients of an "
                               "unfinished forward/backward/step cycle")
        gas = self._config.gradient_accumulation_steps
        lsum = None
        for mb in self._micro_batches(batch, gas):
            loss = self._micro_step(mb)
            lsum = loss if lsum is None else lsum + loss
        # the sum of the micro-batches' gradients, divided once
        # (``_forward_grads``)
        self._apply_update(self._gas if gas > 1 else None)
        return lsum / gas

    # ------------------------------------------------------------------
    # the three-call API
    # ------------------------------------------------------------------
    def forward(self, batch):
        """Loss of one micro-batch ([B, S] ids or a dict), with its graph
        kept for :meth:`backward`."""
        return self.module.loss(self._batch_to_device(batch),
                                attn_backend=self.backend)

    __call__ = forward

    def backward(self, loss):
        """Backpropagate ``loss`` (times the loss scale under fp16) and add
        its gradients, unscaled and divided by gas, into the flat fp32
        buffer: the order of the JAX engine's ``backward``, which divides
        each micro-batch before summing (``train_batch`` sums, then divides
        once, as the JAX one does)."""
        self._scaled_backward(loss)
        self._accumulate_grads(self._gas)
        return loss

    def is_gradient_accumulation_boundary(self):
        return self._accum_count >= self._config.gradient_accumulation_steps

    def step(self):
        """Apply the update at the gradient-accumulation boundary."""
        self._step_applied = False
        if self.is_gradient_accumulation_boundary():
            self._apply_update()

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
        """Steps whose update was applied (host read of the device
        count)."""
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
        return {n: v.detach().cpu().clone()
                for n, v in zip(self._names, self._master_views)}

    def eval_batch(self, batch):
        """The loss of ``batch`` ([B, S] ids or a dict) under no_grad, with
        the compute-dtype weights the training forward sees (the JAX
        ``eval_batch``); a device scalar."""
        with torch.no_grad():
            return self.module.loss(self._batch_to_device(batch),
                                    attn_backend=self.backend)

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP "
                                  "A10)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP "
                                  "A10)")

    def deepspeed_io(self, *args, **kwargs):
        raise NotImplementedError("deepspeed_io / training_data are not "
                                  "ported yet (ROADMAP A10)")
