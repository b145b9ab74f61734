"""Port parity: the fp16 loss-scale automaton and the overflow check.

``deepspeed_tpu_torch.runtime.loss_scaler`` against the JAX package's
``runtime/loss_scaler``: ``update_scale`` stepped over seeded overflow
sequences (dynamic with hysteresis 1 and 2, a short growth window, a
min_scale floor; static), every field of the state compared at every step,
exactly -- the scale is a power of two times the start and the counters
are integers, so there is nothing to round.  ``has_inf_or_nan`` on finite
arrays and on arrays holding one inf or nan, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from torch_threads import _one_torch_thread  # noqa: F401

# (dynamic, initial scale power, hysteresis, scale_window, min_scale,
# overflow probability): growth every 3 clean steps, a floor the shrinking
# reaches, long clean runs, static
CASES = {
    "hysteresis1": (True, 8, 1, 3, 1.0, 0.3),
    "hysteresis2": (True, 8, 2, 3, 1.0, 0.3),
    "floor": (True, 4, 1, 50, 4.0, 0.6),
    "window1000": (True, 16, 2, 1000, 1.0, 0.05),
    "static": (False, 10, 0, 1000, 1.0, 0.3),
}
STEPS = 200


def _fields(state):
    return [float(np.asarray(x)) for x in state]


@pytest.mark.parametrize("case", list(CASES))
def test_update_scale_matches_jax(case):
    dynamic, power, hyst, window, min_scale, p = CASES[case]
    flags = np.random.default_rng(len(case)).random(STEPS) < p
    kw = dict(dynamic=dynamic, scale_window=window, min_scale=min_scale,
              hysteresis=hyst)
    if dynamic:
        js = jls.dynamic_loss_scale_state(power, hysteresis=hyst)
        ts = tls.dynamic_loss_scale_state(power, hysteresis=hyst,
                                          device="cpu")
    else:
        js = jls.static_loss_scale_state(2.0 ** power)
        ts = tls.static_loss_scale_state(2.0 ** power, device="cpu")
    assert _fields(ts) == _fields(js)
    scales = set()
    for i, f in enumerate(flags):
        js = jls.update_scale(js, jnp.asarray(bool(f)), **kw)
        ts = tls.update_scale(ts, torch.tensor(bool(f)), **kw)
        assert _fields(ts) == _fields(js), f"step {i}"
        assert ts.cur_scale.dtype == torch.float32
        assert ts.iteration.dtype == ts.cur_hysteresis.dtype == torch.int32
        scales.add(float(ts.cur_scale))
    if dynamic:
        assert len(scales) > 2        # the sequence both shrank and grew
    else:
        assert scales == {2.0 ** power}


@pytest.mark.parametrize("bad", [None, np.inf, -np.inf, np.nan])
def test_has_inf_or_nan_matches_jax(bad):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(n).astype(np.float32) * 1e4
              for n in (7, 1000)]
    if bad is not None:
        arrays[1][417] = bad
    want = bool(jls.has_inf_or_nan([jnp.asarray(a) for a in arrays]))
    got = tls.has_inf_or_nan(*[torch.as_tensor(a) for a in arrays])
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want == (bad is not None)
