"""Weights from the JAX package's param tree, through numpy.

``from_jax_params`` turns a ``deepspeed_tpu`` ``CausalTransformerLM``
params dict (leaves as numpy arrays, e.g. ``jax.tree.map(np.asarray,
params)``) into a state dict for this package's ``CausalTransformerLM``.
It unstacks the leading ``n_layers`` dim of ``params["layers"]`` into
``layers.<i>.<key>`` and KEEPS the ``[in, out]`` orientation of every
weight matrix: the port's model computes ``h @ w`` exactly as the JAX
model does, so no weight is transposed.
"""

from typing import Dict

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    check_supported)


def from_jax_params(params: Dict, config: TransformerConfig, device=None,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``params``: the JAX param dict with numpy leaves; floating leaves
    are cast to ``dtype`` on ``device`` (default: the CPU, where the
    conversion runs; the engine moves them to its device)."""
    check_supported(config)
    layers = params["layers"]
    if not isinstance(layers, dict):
        raise NotImplementedError("per-layer (MoE) param lists are not "
                                  "ported yet (ROADMAP A14)")

    def tensor(x):
        t = torch.from_numpy(np.array(x))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t

    out = {k: tensor(v) for k, v in params.items() if k != "layers"}
    for key, stacked in layers.items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != config.n_layers:
            raise ValueError(f"layers.{key} has leading dim "
                             f"{stacked.shape[0]}, expected n_layers "
                             f"{config.n_layers}")
        for i in range(config.n_layers):
            out[f"layers.{i}.{key}"] = tensor(stacked[i])
    return out


def to_numpy_params(model) -> Dict:
    """The JAX param dict of ``model`` (a port ``CausalTransformerLM``, or
    its state dict): fp32 numpy leaves, the per-layer tensors stacked
    along a leading ``n_layers`` dim under ``"layers"`` -- the inverse of
    :func:`from_jax_params`."""
    state = model if isinstance(model, dict) else model.state_dict()

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    out, layers = {}, {}
    for name, t in state.items():
        if name.startswith("layers."):
            _, i, key = name.split(".", 2)
            layers.setdefault(key, {})[int(i)] = leaf(t)
        else:
            out[name] = leaf(t)
    out["layers"] = {k: np.stack([v[i] for i in sorted(v)])
                     for k, v in layers.items()}
    return out
