"""Universal checkpoint format: the interchange between the two packages.

Counterpart of ``deepspeed_tpu/checkpoint/universal_checkpoint.py``: a
directory of ``.npy`` files, one fp32 file per leaf of the JAX param tree,
named by the leaf's ``keystr`` (``['layers']['wq']`` ->
``layers_wq.npy``), and ``universal_meta.json`` (``{"keys": {keystr:
{"file", "shape", "dtype"}}, "tag": ...}``).  The names, files and meta
keys are the JAX package's, so either package reads the other's universal
dirs.  :func:`ds_to_universal` converts a port training checkpoint;
:func:`load_universal_checkpoint` rebuilds a flat ``{keystr: array}``
dict or a tree shaped like a template; :func:`universal_to_state_dict`
gives a port model's state dict.
"""

import json
import os
from typing import Any, Optional

import numpy as np

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (
    load_checkpoint_tree, read_latest_tag)
from deepspeed_tpu_torch.runtime.checkpoint_engine import _safe, unflatten
from deepspeed_tpu_torch.runtime.resilience import flatten_with_keystr
from deepspeed_tpu_torch.utils.logging import logger

META_NAME = "universal_meta.json"


def ds_to_universal(ckpt_dir: str, out_dir: str, tag: Optional[str] = None,
                    include_optimizer: bool = False) -> str:
    """Convert a saved port checkpoint into the universal layout (with
    ``include_optimizer``, Adam's m and v too, under ``['opt_state']``)."""
    state = load_checkpoint_tree(ckpt_dir, tag,
                                 load_optimizer_states=include_optimizer)
    tree = state["params"]
    if include_optimizer:
        tree = {"params": tree, "opt_state": state["opt_state"]}
    os.makedirs(out_dir, exist_ok=True)
    meta = {"keys": {}, "tag": tag or read_latest_tag(ckpt_dir)}
    for key, leaf in flatten_with_keystr(tree):
        leaf = np.asarray(leaf)
        fname = _safe(key) + ".npy"
        np.save(os.path.join(out_dir, fname),
                leaf.astype(np.float32)
                if np.issubdtype(leaf.dtype, np.floating) else leaf)
        meta["keys"][key] = {"file": fname, "shape": list(leaf.shape),
                             "dtype": str(leaf.dtype)}
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    logger.info(f"universal checkpoint: {len(meta['keys'])} tensors -> "
                f"{out_dir}")
    return out_dir


def load_universal_checkpoint(out_dir: str, template: Any = None):
    """The universal dir as a flat ``{keystr: array}`` dict; with
    ``template`` (a nested dict of arrays, e.g. the JAX param layout),
    a tree of its shape, each leaf cast to the template's dtype (a key the
    dir lacks raises ``KeyError``, a shape that differs ``ValueError``)."""
    with open(os.path.join(out_dir, META_NAME)) as f:
        meta = json.load(f)
    flat = {k: np.load(os.path.join(out_dir, v["file"]), allow_pickle=False)
            for k, v in meta["keys"].items()}
    if template is None:
        return flat
    out = {}
    for key, leaf in flatten_with_keystr(template):
        if key not in flat:
            raise KeyError(f"universal checkpoint missing '{key}'")
        if list(flat[key].shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: {flat[key].shape} "
                             f"vs {np.shape(leaf)}")
        out[key] = flat[key].astype(np.asarray(leaf).dtype)
    return unflatten(out, template)


# the reference function name
def load_hp_checkpoint_state(out_dir: str, template=None):
    return load_universal_checkpoint(out_dir, template)


def universal_to_state_dict(flat, model):
    """A port model's state dict (numpy, by parameter name) from a flat
    universal dict: ``layers.<i>.<key>`` is row i of ``['layers']['key']``,
    every other name ``[name]``.  Raises ``KeyError`` for a parameter the
    dir lacks."""
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            _, i, key = name.split(".", 2)
            src = flat.get(f"['layers'][{key!r}]")
            src = None if src is None else src[int(i)]
        else:
            src = flat.get(f"[{name!r}]")
        if src is None:
            raise KeyError(f"universal checkpoint has no tensor for {name}")
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {src.shape} in the checkpoint, "
                             f"{tuple(p.shape)} in the model")
        out[name] = src
    return out
