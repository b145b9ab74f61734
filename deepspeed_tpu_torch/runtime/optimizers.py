"""Built-in optimizers over flat buffers, and client optimizers.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py`` (``build_optimizer``
and the registry).  The JAX engine steps through optax and XLA fuses the
whole update into one program; eager PyTorch fuses nothing, so here every
optimizer steps the engine's ONE flat fp32 master buffer from its ONE flat
gradient buffer (fp32 or bf16), with the same protocol:

* ``init_state(flat_master)`` returns a NamedTuple of flat device buffers
  and ``count``, the int32 device count of applied steps (it drives bias
  corrections and the LR schedule, as optax's count does);
* ``step(master, grads, state, skip=None, backend=...)`` updates the
  master and the state in place and returns the state; ``skip`` (an int32
  device scalar, nonzero on an fp16 overflow) leaves everything, the count
  included, as it was;
* :func:`state_tensors` names every buffer of a state for the checkpoint
  payload, each saved and restored in its own dtype.

The rules, each the optax transform the JAX registry builds, with its
defaults:

* adam / adamw / fusedadam (:class:`FusedAdam`): ``ops/adam.fused_adam``,
  ONE launch of the B3 kernel a step -- ``weight_decay`` 0.01 in AdamW mode
  and 0 otherwise, applied to EVERY parameter (``optax.adamw`` without a
  mask), moments fp32 or bf16 (``moment_dtype``, stochastically rounded);
* lamb / fusedlamb (:class:`Lamb`, ``optax.lamb``), sgd (:class:`SGD`,
  ``optax.sgd`` after ``add_decayed_weights``) and adagrad
  (:class:`Adagrad`, ``optax.adagrad``): plain PyTorch over the flat
  buffers, pieces at a time, with the per-leaf reductions LAMB needs over
  the parameter views (:class:`FlatLayout`; a leaf is a JAX param leaf, so
  a stacked layer weight's layers share one trust ratio, as in JAX);
* onebitadam / zerooneadam / onebitlamb (:class:`OneBit`): the error
  feedback of ``runtime/comm_compression.py`` before Adam in L2 mode or
  LAMB -- at world size 1 the whole of the 1-bit rule;
* a client optimizer (:class:`ClientOptimizer`): a ``torch.optim``
  optimizer class, or a callable returning one, built over the master
  views.

``lr`` may be a schedule (a function of the 0-dim fp32 applied count on
the device), and Adam's beta1 may follow 1Cycle's momentum schedule.
``cpuadam`` is the device Adam here, as in the JAX registry; the host
Adam runs under ``zero_optimization.offload_optimizer``
(``runtime/zero/offload.py``), which takes the Adam names and adagrad.
"""

import base64
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam import (_CHUNK, AdamState, _advance,
                                          adam_hyper, fused_adam, init_state)
from deepspeed_tpu_torch.runtime.comm_compression import ErrorFeedback

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB = "fusedlamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
# the optimizers 1Cycle's momentum schedule cycles (the JAX engine's list)
ADAM_FAMILY = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM, CPU_ADAM)

_MOMENT_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
                  "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


class FlatLayout:
    """How the flat buffers split into parameters and JAX leaves.
    ``sizes``: each parameter's element count, in buffer order (the spans
    tile the buffer from 0); ``leaves``: each parameter's leaf index (the
    engine maps ``layers.<i>.<key>`` to the leaf ``layers.<key>``).
    ``FlatLayout([n], [0])`` is one leaf."""

    def __init__(self, sizes, leaves, device):
        self.sizes = [int(s) for s in sizes]
        self.offsets = np.cumsum([0] + self.sizes[:-1]).tolist()
        self.numel = sum(self.sizes)
        self.n_leaves = max(leaves) + 1 if leaves else 0
        self._leaf = torch.as_tensor(leaves, dtype=torch.int64,
                                     device=device)
        self._sizes = torch.as_tensor(self.sizes, dtype=torch.int64,
                                      device=device)
        self._leaf_numel = self.leaf_sum(self._sizes.float())

    def views(self, flat):
        return [flat[o:o + n] for o, n in zip(self.offsets, self.sizes)]

    def leaf_sum(self, per_param):
        """Per-leaf sums of a per-parameter fp32 tensor."""
        return torch.zeros(self.n_leaves, dtype=torch.float32,
                           device=per_param.device).index_add_(
            0, self._leaf, per_param)

    def expand(self, per_leaf):
        """A per-leaf tensor repeated over each leaf's elements (flat)."""
        return torch.repeat_interleave(per_leaf[self._leaf], self._sizes,
                                       output_size=self.numel)

    def leaf_norm(self, flat):
        """The L2 norm of each leaf of ``flat`` (fp32)."""
        norms = torch.stack(torch._foreach_norm(self.views(flat), 2))
        return torch.sqrt(self.leaf_sum(norms.float() ** 2))

    def leaf_mean_abs(self, flat):
        """The mean of |x| over each leaf of ``flat`` (fp32)."""
        sums = torch.stack(torch._foreach_norm(self.views(flat), 1))
        return self.leaf_sum(sums.float()) / self._leaf_numel


def state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every device buffer of an optimizer state by name (a nested state's
    too), ``count`` last: the checkpoint payload's keys."""
    out = {}
    for name, val in state._asdict().items():
        if hasattr(val, "_asdict"):
            out.update(state_tensors(val))
        elif val is not None and name != "count":
            out[name] = val
    out["count"] = state.count
    return out


def _keep(skip):
    return None if skip is None else skip.bool()


def _put(dst, new, keep):
    """Write ``new`` into ``dst`` unless ``keep`` (a skipped step)."""
    dst.copy_(new if keep is None else torch.where(keep, dst, new))


class FlatOptimizer:
    """The protocol above.  ``lr``: a number or a schedule of the 0-dim
    fp32 applied count; ``layout``: set by the engine
    (:meth:`bind`), else the whole buffer is one leaf."""

    layout: Optional[FlatLayout] = None

    def __init__(self, lr):
        self.lr = lr if callable(lr) else float(lr)

    def bind(self, layout: FlatLayout):
        self.layout = layout

    def _layout(self, flat):
        if self.layout is None:
            self.layout = FlatLayout([flat.numel()], [0], flat.device)
        return self.layout

    def _lr(self, count):
        return self.lr(count.to(torch.float32)) if callable(self.lr) \
            else self.lr

    @staticmethod
    def _count(flat):
        return torch.zeros((), dtype=torch.int32, device=flat.device)


class FusedAdam(FlatOptimizer):
    """Adam / AdamW over one flat fp32 buffer.  ``step`` updates the
    buffer and the moments in place in one ``fused_adam`` call.
    ``b1_schedule``: None or a schedule for beta1 (1Cycle momentum,
    optax's ``inject_hyperparams``); ``moment_dtype``: torch.float32 or
    torch.bfloat16 (the JAX ``_scale_by_adam_dtyped``)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True, b1_schedule=None,
                 moment_dtype=torch.float32):
        super().__init__(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.b1_schedule = b1_schedule
        self.moment_dtype = moment_dtype

    def init_state(self, flat_params) -> AdamState:
        return init_state(flat_params, self.moment_dtype)

    def hyper(self, state: AdamState):
        """The step's scalar buffer (``ops.adam.adam_hyper``) from the
        schedules at the state's applied count, on the card."""
        t = state.count.to(torch.float32)
        b1 = self.b1_schedule(t) if self.b1_schedule else self.betas[0]
        return adam_hyper(state.count, self._lr(state.count), b1,
                          self.betas[1])

    def step(self, flat_params, flat_grads, state: AdamState, skip=None,
             backend="auto") -> AdamState:
        _, state = fused_adam(
            flat_params, flat_grads, state, self.hyper(state), skip,
            beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, adamw_mode=self.adamw_mode,
            backend=backend)
        return state


class SgdState(NamedTuple):
    trace: Optional[torch.Tensor]   # fp32 momentum trace; None without one
    count: torch.Tensor


class SGD(FlatOptimizer):
    """``optax.sgd(lr, momentum or None, nesterov)`` after
    ``add_decayed_weights(weight_decay)``: g += wd p; with momentum mu the
    trace t = g + mu t and the update t (g + mu t with Nesterov); p -= lr
    update."""

    def __init__(self, lr=1e-3, momentum=0.0, nesterov=False,
                 weight_decay=0.0):
        super().__init__(lr)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)
        self.weight_decay = float(weight_decay)

    def init_state(self, flat_params) -> SgdState:
        trace = (torch.zeros_like(flat_params, dtype=torch.float32)
                 if self.momentum else None)
        return SgdState(trace, self._count(flat_params))

    def step(self, params, grads, state: SgdState, skip=None,
             backend="auto") -> SgdState:
        lr, keep, mu = self._lr(state.count), _keep(skip), self.momentum
        for lo in range(0, params.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            p, g = params[sl], grads[sl].float()
            if self.weight_decay:
                g = g + p * self.weight_decay
            if state.trace is not None:
                t = g + state.trace[sl] * mu
                g = g + t * mu if self.nesterov else t
                _put(state.trace[sl], t, keep)
            _put(p, p - g * lr, keep)
        _advance(state.count, skip)
        return state


class AdagradState(NamedTuple):
    sum_of_squares: torch.Tensor    # fp32, from optax's 0.1
    count: torch.Tensor


class Adagrad(FlatOptimizer):
    """``optax.adagrad(lr, eps=eps)``: s += g^2 (s starts at 0.1, optax's
    ``initial_accumulator_value``), update g / sqrt(s + eps) (0 where s is
    0), p -= lr update.  Weight decay is not applied, as in JAX."""

    INITIAL_ACCUMULATOR = 0.1

    def __init__(self, lr=1e-2, eps=1e-10):
        super().__init__(lr)
        self.eps = float(eps)

    def init_state(self, flat_params) -> AdagradState:
        return AdagradState(
            torch.full_like(flat_params, self.INITIAL_ACCUMULATOR,
                            dtype=torch.float32), self._count(flat_params))

    def step(self, params, grads, state: AdagradState, skip=None,
             backend="auto") -> AdagradState:
        lr, keep = self._lr(state.count), _keep(skip)
        for lo in range(0, params.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            p, g = params[sl], grads[sl].float()
            s = g * g + state.sum_of_squares[sl]
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps),
                              torch.zeros_like(s))
            _put(p, p - (inv * g) * lr, keep)
            _put(state.sum_of_squares[sl], s, keep)
        _advance(state.count, skip)
        return state


class Lamb(FlatOptimizer):
    """``optax.lamb(lr, b1, b2, eps, weight_decay)``: Adam's bias-corrected
    update u = m_hat / (sqrt(v_hat) + eps) + wd p, then per JAX leaf the
    trust ratio ||p|| / ||u||, unclipped, 1 where either norm is 0; p -= lr
    ratio u.  fp32 moments (``AdamState``)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.0):
        super().__init__(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)

    def init_state(self, flat_params) -> AdamState:
        return init_state(flat_params)

    def step(self, params, grads, state: AdamState, skip=None,
             backend="auto") -> AdamState:
        layout, keep = self._layout(params), _keep(skip)
        b1, b2 = self.betas
        lr, _, omb1, c1, c2 = adam_hyper(state.count, self._lr(state.count),
                                         b1, b2).unbind()
        u = torch.empty_like(params)
        for lo in range(0, params.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            p, m, v, g = params[sl], state.m[sl], state.v[sl], grads[sl].float()
            m_new = m * b1 + g * omb1
            v_new = v * b2 + (g * g) * (1.0 - b2)
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            if self.weight_decay:
                upd = upd + p * self.weight_decay
            u[sl] = upd
            _put(m, m_new, keep)
            _put(v, v_new, keep)
        pn, un = layout.leaf_norm(params), layout.leaf_norm(u)
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                            pn / un)
        u.mul_(layout.expand(ratio))
        for lo in range(0, params.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            _put(params[sl], params[sl] - u[sl] * lr, keep)
        _advance(state.count, skip)
        return state


class OneBitState(NamedTuple):
    error: torch.Tensor    # fp32 error-feedback buffer
    inner: Any             # the inner rule's state

    @property
    def count(self):
        return self.inner.count


class OneBit(FlatOptimizer):
    """The 1-bit optimizers at world size 1: ``ErrorFeedback(freeze_step)``
    on the gradients, then ``inner`` (Adam in L2 mode, or LAMB), as the JAX
    ``_onebit`` chains them.  The error feedback's count is the inner
    rule's: both advance on applied steps only."""

    def __init__(self, inner, freeze_step=100):
        self.inner = inner
        self.ef = ErrorFeedback(freeze_step)
        self.lr = inner.lr

    def bind(self, layout):
        self.layout = layout
        self.inner.bind(layout)

    def init_state(self, flat_params) -> OneBitState:
        return OneBitState(ErrorFeedback.init_error(flat_params),
                           self.inner.init_state(flat_params))

    def step(self, params, grads, state: OneBitState, skip=None,
             backend="auto") -> OneBitState:
        q = self.ef.compress(grads, state.error, state.count,
                             self._layout(params), _keep(skip))
        self.inner.step(params, q, state.inner, skip, backend=backend)
        return state


class ClientState(NamedTuple):
    count: torch.Tensor


class ClientOptimizer(FlatOptimizer):
    """A client ``torch.optim`` optimizer: ``factory`` (an Optimizer class,
    or a callable returning an Optimizer) is called on the master views
    (:meth:`build`).  ``step`` points each view's ``.grad`` at the flat
    gradient view (bf16 gradients are first cast into an fp32 scratch
    buffer) and calls the optimizer's ``step()``.  A skipped fp16 step must
    not call it: that costs one host read of the overflow flag a step, for
    client optimizers only.  Its ``state_dict()`` rides the checkpoint's
    ``client_state`` (:meth:`host_state`)."""

    def __init__(self, factory):
        if isinstance(factory, torch.optim.Optimizer):
            raise TypeError(
                "pass the client optimizer as a torch.optim.Optimizer class "
                "or a callable returning one (e.g. functools.partial("
                "torch.optim.SGD, lr=0.1)): the engine builds it over its "
                "fp32 master weights")
        if not callable(factory):
            raise TypeError(f"client optimizer must be a torch.optim "
                            f"Optimizer class or a callable, got "
                            f"{type(factory)}")
        self.factory = factory
        self.lr = 0.0
        self.optimizer = None
        self._views = None
        self._scratch = None

    def build(self, master_views):
        self._views = list(master_views)
        self.optimizer = self.factory(self._views)
        if not isinstance(self.optimizer, torch.optim.Optimizer):
            raise TypeError(f"the client optimizer factory returned "
                            f"{type(self.optimizer)}, not a torch.optim "
                            f"Optimizer")

    def init_state(self, flat_params) -> ClientState:
        return ClientState(self._count(flat_params))

    def step(self, params, grads, state: ClientState, skip=None,
             backend="auto") -> ClientState:
        if skip is not None and bool(skip):    # one host read (fp16 only)
            return state
        if grads.dtype != torch.float32:
            if self._scratch is None:
                self._scratch = torch.empty_like(grads, dtype=torch.float32)
            self._scratch.copy_(grads)
            grads = self._scratch
        for v, g in zip(self._views, self.layout.views(grads)):
            v.grad = g.view(v.shape)
        self.optimizer.step()
        state.count.add_(1)
        return state

    def host_state(self):
        """The optimizer's ``state_dict()`` as JSON values: each tensor as
        its dtype, shape and base64 bytes, restored bit for bit."""
        return _encode(self.optimizer.state_dict())

    def load_host_state(self, obj):
        self.optimizer.load_state_dict(_decode(obj))


def _encode(obj):
    if torch.is_tensor(obj):
        t = obj.detach().cpu().contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return {"__tensor__": str(t.dtype).replace("torch.", ""),
                "shape": list(t.shape),
                "data": base64.b64encode(raw.numpy().tobytes()).decode()}
    if isinstance(obj, dict):
        return {"__dict__": [[_encode(k), _encode(v)]
                             for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return [_encode(x) for x in obj]
    return obj


def _decode(obj):
    if isinstance(obj, dict) and "__tensor__" in obj:
        dtype = getattr(torch, obj["__tensor__"])
        raw_dtype = torch.int16 if dtype == torch.bfloat16 else dtype
        buf = bytearray(base64.b64decode(obj["data"]))
        t = torch.frombuffer(buf, dtype=raw_dtype) if buf else \
            torch.empty(0, dtype=raw_dtype)
        return t.view(dtype).reshape(obj["shape"]).clone()
    if isinstance(obj, dict) and "__dict__" in obj:
        return {_decode(k): _decode(v) for k, v in obj["__dict__"]}
    if isinstance(obj, list):
        return [_decode(x) for x in obj]
    return obj


def _moment_dtype(params: Dict[str, Any]):
    name = str(params.get("moment_dtype", "float32")).lower()
    if name not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of "
                         f"{sorted(_MOMENT_DTYPES)}, got '{name}'")
    return _MOMENT_DTYPES[name]


def _adam(params: Dict[str, Any], adamw_mode=True) -> FusedAdam:
    mdt = _moment_dtype(params)
    if mdt != torch.float32 and params.get("_b1_schedule") is not None:
        raise ValueError("moment_dtype != float32 is not supported "
                         "together with OneCycle momentum cycling")
    return FusedAdam(lr=params.get("lr", 1e-3),
                     betas=params.get("betas", (0.9, 0.999)),
                     eps=params.get("eps", 1e-8),
                     weight_decay=params.get("weight_decay",
                                             0.01 if adamw_mode else 0.0),
                     adamw_mode=adamw_mode,
                     b1_schedule=params.get("_b1_schedule"),
                     moment_dtype=mdt)


def _lamb(params: Dict[str, Any]) -> Lamb:
    return Lamb(lr=params.get("lr", 1e-3),
                betas=params.get("betas", (0.9, 0.999)),
                eps=params.get("eps", 1e-6),
                weight_decay=params.get("weight_decay", 0.0))


def _sgd(params: Dict[str, Any]) -> SGD:
    return SGD(lr=params.get("lr", 1e-3),
               momentum=params.get("momentum", 0.0),
               nesterov=params.get("nesterov", False),
               weight_decay=params.get("weight_decay", 0.0))


def _adagrad(params: Dict[str, Any]) -> Adagrad:
    return Adagrad(lr=params.get("lr", 1e-2), eps=params.get("eps", 1e-10))


def _onebit(params: Dict[str, Any], inner) -> OneBit:
    return OneBit(inner, freeze_step=int(params.get("freeze_step", 100)))


OPTIMIZER_REGISTRY = {
    ADAM_OPTIMIZER: lambda p: _adam(p, adamw_mode=p.get("adam_w_mode",
                                                        True)),
    ADAMW_OPTIMIZER: lambda p: _adam(p, adamw_mode=True),
    FUSED_ADAM: lambda p: _adam(p, adamw_mode=p.get("adam_w_mode", True)),
    # the device Adam, as the JAX registry maps it: the host Adam runs
    # under zero_optimization.offload_optimizer (runtime/zero/offload.py)
    CPU_ADAM: lambda p: _adam(p, adamw_mode=p.get("adamw_mode", True)),
    LAMB_OPTIMIZER: _lamb,
    FUSED_LAMB: _lamb,
    ONEBIT_ADAM_OPTIMIZER: lambda p: _onebit(p, _adam(p, adamw_mode=False)),
    ZERO_ONE_ADAM_OPTIMIZER: lambda p: _onebit(p, _adam(p,
                                                        adamw_mode=False)),
    ONEBIT_LAMB_OPTIMIZER: lambda p: _onebit(p, _lamb(p)),
    SGD_OPTIMIZER: _sgd,
    ADAGRAD_OPTIMIZER: _adagrad,
}


def build_optimizer(name: str, params: Dict[str, Any]) -> FlatOptimizer:
    key = name.lower()
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(f"Unknown optimizer '{name}'. Built-ins: "
                         f"{sorted(OPTIMIZER_REGISTRY)}")
    return OPTIMIZER_REGISTRY[key](params)
