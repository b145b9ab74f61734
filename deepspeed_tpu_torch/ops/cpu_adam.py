"""Host Adam and Adagrad over fp32 CPU tensors (the ZeRO-Offload update).

Counterpart of the JAX package's ``ops/cpu_adam.py``: ``adam_update`` and
``adagrad_update`` run the fused C++ of ``ops/csrc/host/cpu_adam.cpp``
(one OpenMP pass over p, g, m and v; the compiler vectorises it), built
by ``ops/host_builder.py`` at first use, with the same arguments and the
same bias corrections (computed here in double, handed over as floats),
so the port's output and the JAX package's build of the same source agree
bit for bit on the same CPU.  Pointers go over by ``data_ptr()``;
``ctypes`` releases the GIL for the call, so a host update overlaps the
transfers other threads and the card's copy engines run.

``adam_update_plain`` and ``adagrad_update_plain`` are the same rules in
plain PyTorch, for comparison only: the C++ is what runs, and a failed
build raises.  ``adam_update.calls`` and ``adagrad_update.calls`` count
the C calls.
"""

import ctypes
from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops import host_builder

_PF = ctypes.c_void_p
_SIGNATURES = {
    "adam_update": ([_PF] * 4 + [ctypes.c_long] + [ctypes.c_float] * 7 +
                    [ctypes.c_int], None),
    "adagrad_update": ([_PF] * 3 + [ctypes.c_long] + [ctypes.c_float] * 3,
                       None),
}


def _lib():
    return host_builder.load("cpu_adam", _SIGNATURES)


class CPUAdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    step: int


def init_state(numel) -> CPUAdamState:
    return CPUAdamState(m=torch.zeros(numel, dtype=torch.float32),
                        v=torch.zeros(numel, dtype=torch.float32), step=0)


def _check(**tensors):
    """Every tensor fp32, contiguous, on the CPU and of one length."""
    n = None
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device.type != "cpu" or \
                not t.is_contiguous():
            raise ValueError(f"host {name} must be a contiguous fp32 CPU "
                             f"tensor, got {t.dtype} on {t.device}")
        if n is not None and t.numel() != n:
            raise ValueError(f"host {name} has {t.numel()} elements, "
                             f"expected {n}")
        n = t.numel()
    return n


def _bias_corrections(beta1, beta2, step, bias_correction):
    if not bias_correction:
        return 1.0, 1.0
    return 1.0 - beta1 ** step, 1.0 - beta2 ** step


def adam_update(params, grads, state: CPUAdamState, lr=1e-3, beta1=0.9,
                beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True,
                bias_correction=True) -> CPUAdamState:
    """In-place fused Adam (AdamW in ``adamw_mode``, else L2) on host fp32
    tensors at step ``state.step + 1``; returns the state with that step."""
    n = _check(params=params, grads=grads, m=state.m, v=state.v)
    step = state.step + 1
    bc1, bc2 = _bias_corrections(beta1, beta2, step, bias_correction)
    _lib().adam_update(params.data_ptr(), grads.data_ptr(),
                       state.m.data_ptr(), state.v.data_ptr(), n, lr, beta1,
                       beta2, eps, weight_decay, bc1, bc2,
                       1 if adamw_mode else 0)
    adam_update.calls += 1
    return CPUAdamState(m=state.m, v=state.v, step=step)


def adagrad_update(params, grads, sq_accum, lr=1e-2, eps=1e-10,
                   weight_decay=0.0):
    """In-place fused Adagrad on host fp32 tensors; returns ``sq_accum``."""
    n = _check(params=params, grads=grads, sq_accum=sq_accum)
    _lib().adagrad_update(params.data_ptr(), grads.data_ptr(),
                          sq_accum.data_ptr(), n, lr, eps, weight_decay)
    adagrad_update.calls += 1
    return sq_accum


adam_update.calls = 0
adagrad_update.calls = 0


def adam_update_plain(params, grads, state: CPUAdamState, lr=1e-3,
                      beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
                      adamw_mode=True, bias_correction=True) -> CPUAdamState:
    """:func:`adam_update` in plain PyTorch (the C++ loop's operations in
    its order, each rounded to fp32; the C++ may fuse a multiply and an
    add, so the two agree within a few fp32 ulps, not bit for bit)."""
    step = state.step + 1
    bc1, bc2 = _bias_corrections(beta1, beta2, step, bias_correction)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    inv_bc1, inv_bc2_sqrt = 1.0 / f32(bc1), 1.0 / f32(bc2).sqrt()
    g = grads
    if not adamw_mode and weight_decay:
        g = g + weight_decay * params
    state.m.mul_(beta1).add_((1.0 - f32(beta1)) * g)
    state.v.mul_(beta2).add_((1.0 - f32(beta2)) * g * g)
    update = (state.m * inv_bc1) / (state.v.sqrt() * inv_bc2_sqrt + eps)
    if adamw_mode and weight_decay:
        update = update + weight_decay * params
    params.sub_(lr * update)
    return CPUAdamState(m=state.m, v=state.v, step=step)


def adagrad_update_plain(params, grads, sq_accum, lr=1e-2, eps=1e-10,
                         weight_decay=0.0):
    """:func:`adagrad_update` in plain PyTorch (for comparison only)."""
    g = grads + weight_decay * params if weight_decay else grads
    sq_accum.add_(g * g)
    params.sub_(lr * g / (sq_accum.sqrt() + eps))
    return sq_accum
