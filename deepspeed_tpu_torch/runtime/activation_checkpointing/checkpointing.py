"""Activation checkpointing: the Megatron-style surface on
``torch.utils.checkpoint``.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py``: ``checkpoint`` / ``checkpoint_wrapper`` recompute a
block in the backward under the configured policy, ``configure`` sets the
module's knobs from a DeepSpeed config and explicit arguments (explicit
ones win), and ``RNGStatesTracker`` keeps named random streams.

The JAX package hands a ``jax.checkpoint_policies`` name to
``jax.checkpoint``; here the same names choose what the non-reentrant
``torch.utils.checkpoint`` keeps (:data:`POLICIES`):

* ``nothing_saveable``: only the block's inputs; everything is recomputed;
* ``dots_saveable`` (alias ``checkpoint_dots``): also the outputs of the
  matrix products (``aten.mm``, ``aten.addmm``, ``aten.bmm``), through
  ``create_selective_checkpoint_contexts``; the rest is recomputed;
* ``dots_with_no_batch_dims_saveable`` (alias
  ``checkpoint_dots_with_no_batch_dims``): the same without ``bmm``;
* ``everything_saveable``: the block runs with no checkpoint at all.

What the hand-written kernels compute is not a matrix product to the
dispatcher (they launch through ``ctypes``), so a recompute re-runs them,
as ``jax.checkpoint`` re-runs a Pallas call under any policy but
``everything_saveable``.

The model's layers (:func:`remat`) keep their products another way: the
selective contexts route every op of the layer through a Python dispatch
mode, twice (forward and recompute), which on an H100 80GB HBM3 at 700 W
made ``ds_bench train``'s gpt_350m train_batch 1.47x slower on the wall
than saving nothing, its device time 4% faster
(``scripts/remat_policy_ab.py``).  A layer's projections go through
:func:`matmul` instead: inside :func:`remat` the forward keeps each
product's output and the recompute hands it back through an autograd
function whose backward is the product's own -- the same tensors kept,
the same values, no per-op dispatch.

With ``cpu_checkpointing`` (``checkpoint_in_cpu``) :func:`checkpoint`
keeps what ``dots_with_no_batch_dims_saveable`` keeps, in host memory:
the JAX module's ``offload_dot_with_no_batch_dims("device",
"pinned_host")``, whatever the policy.  The block's forward copies each
product's output to pinned host memory (a plain host copy off the card)
and frees it on the card; its recompute in the backward takes the copies
back to the card in place of the products and recomputes the rest.  The
model's own layers follow ``TransformerConfig.remat_policy`` as before.

At world size 1 ``partition_activations`` changes nothing (the JAX module
shards saved inputs over tp, which is 1 here; a wider mesh raises ROADMAP
A14 in the config).
"""

import contextlib
import functools
import threading
from typing import Callable, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)
from torch.utils.checkpoint import checkpoint as _torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu_torch.utils.logging import logger

# ----------------------------------------------------------------------
# module-level config (the JAX module's globals)
# ----------------------------------------------------------------------
PARTITION_ACTIVATIONS = False
CPU_CHECKPOINT = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False
NUM_CHECKPOINTS = None
_POLICY_NAME = "nothing_saveable"
_CONFIGURED = False

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default,
                   _aten.bmm.default})
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
SAVE_NOTHING = frozenset()
SAVE_EVERYTHING = None
# policy name -> the ops whose outputs are kept (SAVE_EVERYTHING: no
# checkpoint at all)
POLICIES = {
    "nothing_saveable": SAVE_NOTHING,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
    "everything_saveable": SAVE_EVERYTHING,
}


def resolve_policy(name):
    """The saved-op set of policy ``name`` (:data:`POLICIES`); an unknown
    name raises ``ValueError``, as the JAX module's resolver does."""
    if name not in POLICIES:
        raise ValueError(f"unknown activation-checkpointing policy "
                         f"'{name}' (one of {sorted(POLICIES)})")
    return POLICIES[name]


def _policy_fn(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def run_checkpointed(function: Callable, *args, policy=SAVE_NOTHING):
    """``function(*args)`` recomputed in the backward, keeping the outputs
    of the ops in ``policy`` (a :data:`POLICIES` value)."""
    if policy is SAVE_EVERYTHING:
        return function(*args)
    if not policy:
        return _torch_checkpoint(function, *args, use_reentrant=False)
    return _torch_checkpoint(
        function, *args, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     functools.partial(_policy_fn, policy)))


class _KeptProducts(threading.local):
    """The products kept by the :func:`remat` call running on this thread
    (None outside one)."""
    current = None


_KEPT = _KeptProducts()


class _Product(torch.autograd.Function):
    """``a @ b`` (a 2-d ``b``) inside a :func:`remat` layer that keeps
    products: the layer's first run computes it and keeps its output, a
    recompute hands the kept output back.  Both save (a, b), as the
    checkpoint's recompute must save what the first run saved, and
    backpropagate as ``torch.matmul`` does (``a``'s leading dims folded
    into one ``mm``)."""

    @staticmethod
    def forward(ctx, a, b, kept):
        ctx.save_for_backward(a, b)
        return kept.output(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g2 = grad.reshape(-1, grad.shape[-1])
        ga = g2.mm(b.t()).view(a.shape)
        gb = a.reshape(-1, a.shape[-1]).t().mm(g2)
        return ga, gb, None


class _Products:
    """One :func:`remat` call's kept products, in call order: recorded by
    its first run, handed back by each recompute."""

    def __init__(self):
        self.outs, self.runs, self.next = [], 0, None

    def start(self):
        self.runs += 1
        self.next = None if self.runs == 1 else 0

    def output(self, a, b):
        if self.next is None:
            out = a @ b
            self.outs.append(out.detach())
            return out
        out = self.outs[self.next]
        self.next += 1
        return out.view_as(out)


def matmul(a, b):
    """``a @ b`` with a 2-d ``b``: inside a :func:`remat` layer that keeps
    products its output is kept in the forward and not recomputed."""
    kept = _KEPT.current
    return a @ b if kept is None else _Product.apply(a, b, kept)


def remat(function: Callable, *args, policy=SAVE_NOTHING):
    """A model layer ``function(*args)`` under a :data:`POLICIES` value:
    ``SAVE_EVERYTHING`` runs it plainly; ``SAVE_NOTHING`` keeps its inputs
    alone and recomputes it in the backward; a dots policy also keeps the
    outputs of its :func:`matmul` products (the model's projections, none
    with a batch dim, so both dots policies keep them all) and recomputes
    the rest."""
    if policy is SAVE_EVERYTHING:
        return function(*args)
    if not policy:
        return _torch_checkpoint(function, *args, use_reentrant=False)
    kept = _Products()

    def run(*inner):
        kept.start()
        outer, _KEPT.current = _KEPT.current, kept
        try:
            return function(*inner)
        finally:
            _KEPT.current = outer

    return _torch_checkpoint(run, *args, use_reentrant=False)


def _to_host(t):
    """A host copy of ``t``: pinned, copied without a sync, from the card;
    a plain copy on the CPU."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)
    return t.detach().clone()


class _HostDots(TorchDispatchMode):
    """``cpu_checkpointing``'s forward: each no-batch-dim product's output
    also goes to ``kept`` as a host copy."""

    def __init__(self, kept):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS_NO_BATCH:
            self.kept.append(_to_host(out))
        return out


class _DotsFromHost(TorchDispatchMode):
    """``cpu_checkpointing``'s recompute: the products come back from
    ``kept``, in call order, on the device of their first input; every
    other op runs."""

    def __init__(self, kept):
        super().__init__()
        self.kept = kept

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _DOTS_NO_BATCH:
            return func(*args, **(kwargs or {}))
        host = self.kept[self.next]
        self.next += 1
        return host.to(args[0].device, non_blocking=True)


def checkpoint(function: Callable, *args):
    """Checkpoint a model block: ``function(*args)`` with its internals
    recomputed in the backward under the configured policy, or under
    ``cpu_checkpointing`` with its no-batch-dim products kept in host
    memory (the reference's drop-in for
    ``torch.utils.checkpoint.checkpoint``)."""
    if CPU_CHECKPOINT:
        kept = []
        return _torch_checkpoint(
            function, *args, use_reentrant=False,
            context_fn=lambda: (_HostDots(kept), _DotsFromHost(kept)))
    return run_checkpointed(function, *args,
                            policy=resolve_policy(_POLICY_NAME))


def checkpoint_wrapper(function: Callable) -> Callable:
    """Decorator form: ``f = checkpoint_wrapper(f)``."""
    @functools.wraps(function)
    def wrapped(*args):
        return checkpoint(function, *args)
    return wrapped


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None, num_checkpoints=None,
              policy=None):
    """Set the module's knobs from the DeepSpeed config (a
    ``DeepSpeedConfig`` or a config dict) and / or explicit arguments
    (explicit ones win)."""
    global PARTITION_ACTIVATIONS, CPU_CHECKPOINT, CONTIGUOUS_CHECKPOINTING
    global SYNCHRONIZE, PROFILE_TIME, NUM_CHECKPOINTS, _POLICY_NAME, _CONFIGURED

    cfg = None
    if deepspeed_config is not None:
        cfg = getattr(deepspeed_config, "activation_checkpointing_config",
                      None)
        if cfg is None and isinstance(deepspeed_config, dict):
            from deepspeed_tpu_torch.runtime.config import \
                ActivationCheckpointingConfig
            cfg = ActivationCheckpointingConfig(
                deepspeed_config.get("activation_checkpointing") or {})
    if cfg is not None:
        PARTITION_ACTIVATIONS = cfg.partition_activations
        CONTIGUOUS_CHECKPOINTING = cfg.contiguous_memory_optimization
        CPU_CHECKPOINT = cfg.cpu_checkpointing
        SYNCHRONIZE = cfg.synchronize_checkpoint_boundary
        PROFILE_TIME = cfg.profile
        NUM_CHECKPOINTS = cfg.number_checkpoints
        _POLICY_NAME = cfg.policy

    if partition_activations is not None:
        PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if checkpoint_in_cpu is not None:
        CPU_CHECKPOINT = checkpoint_in_cpu
    if synchronize is not None:
        SYNCHRONIZE = synchronize
    if profile is not None:
        PROFILE_TIME = profile
    if num_checkpoints is not None:
        NUM_CHECKPOINTS = num_checkpoints
    if policy is not None:
        _POLICY_NAME = policy
    if CONTIGUOUS_CHECKPOINTING:
        # the caching allocator places the saved tensors; the reference's
        # hand-managed contiguous buffers have no counterpart here
        logger.info("contiguous_memory_optimization: handled by the CUDA "
                    "caching allocator; no user-visible effect")
    _CONFIGURED = True


def is_configured():
    return _CONFIGURED


def reset():
    """The reference's ``reset()``: drop per-iteration buffers (nothing is
    kept between iterations here)."""


def model_parallel_reconfigure_tp_seed(seed):
    get_rng_tracker().add(_MODEL_PARALLEL_RNG, _tp_offset_seed(seed))


# ----------------------------------------------------------------------
# RNG state tracker (the reference's CudaRNGStatesTracker)
# ----------------------------------------------------------------------
_MODEL_PARALLEL_RNG = "model-parallel-rng"
_DEFAULT_RNG = "default-rng"


def _tp_offset_seed(seed: int) -> int:
    """A distinct seed per tp rank (the reference's ``seed + 2718 +
    tp_rank``); the tp rank is 0 at world size 1."""
    return int(seed) + 2718


class RNGStatesTracker:
    """Named random streams, each a seeded ``torch.Generator``.  ``fork``
    yields a generator seeded from a draw of the named one, so repeated
    forks are fresh and deterministic."""

    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states):
        self.states_ = {}
        for name, state in states.items():
            g = torch.Generator()
            g.set_state(state)
            self.states_[name] = g

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise Exception(f"RNG state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(int(seed))

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG, device="cpu"):
        """A fresh generator on ``device``, seeded from the named stream
        (which advances)."""
        if name not in self.states_:
            raise Exception(f"RNG state {name} is not added")
        seed = int(torch.randint(0, 2 ** 62, (),
                                 generator=self.states_[name]))
        yield torch.Generator(device=device).manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


# the reference's name, kept as an alias
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_manual_seed(seed: int):
    """Seed the default and the model-parallel streams (the latter at the
    tp rank's offset seed)."""
    tracker = get_rng_tracker()
    tracker.reset()
    tracker.add(_DEFAULT_RNG, seed)
    tracker.add(_MODEL_PARALLEL_RNG, _tp_offset_seed(seed))
    return tracker


model_parallel_cuda_manual_seed = model_parallel_manual_seed
