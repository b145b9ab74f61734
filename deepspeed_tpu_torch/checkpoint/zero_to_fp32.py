"""Offline checkpoint -> consolidated fp32 weights.

Counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py``
(``get_fp32_state_dict_from_zero_checkpoint`` /
``convert_zero_checkpoint_to_fp32_state_dict``): the port's checkpoint
holds the fp32 master whole at every ZeRO stage, so consolidating is a
host read of it in the JAX param layout.  The ``.npz`` it writes has the
JAX tool's keys (the leaves' ``keystr``, ``['layers']['wq']``).  Runnable
as a module::

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out.npz>

A ZeRO-Offload tag's sidecar (``zero_offload_rank0.npz``) holds the
authoritative fp32 master, as in the JAX tool, and is read in its place.
A parameter-stream tag's sidecar (``zero_param_stream_rank0.npz``) holds
the whole model's masters and its ``.meta.json`` their structure, so the
tree is rebuilt from those two without the model (the JAX tool's
``_param_stream_state_dict``); the stream's tag holds no master of its
own.
"""

import argparse
import glob
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (
    _param_tree, _resolve_tag, load_checkpoint_tree)
from deepspeed_tpu_torch.runtime.checkpoint_engine import (LAYOUT_NAME,
                                                           unflatten)
from deepspeed_tpu_torch.runtime.resilience import flatten_with_keystr
from deepspeed_tpu_torch.utils.logging import logger


def _insert(root: dict, keys, val):
    cur = root
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = val


def _unflatten_meta(flat: np.ndarray, leaves_meta) -> dict:
    """A nested dict from a flat fp32 master and the leaf metadata the
    stream saved, in its flat order; non-float leaves from the values the
    sidecar carries."""
    tree: dict = {}
    off = 0
    for lm in leaves_meta:
        if not lm["float"]:
            if "value" in lm:
                _insert(tree, lm["path"],
                        np.asarray(lm["value"],
                                   lm.get("dtype")).reshape(lm["shape"]))
            continue
        size = int(np.prod(lm["shape"])) if lm["shape"] else 1
        _insert(tree, lm["path"],
                np.asarray(flat[off:off + size],
                           np.float32).reshape(lm["shape"]))
        off += size
    return tree


def _param_stream_state_dict(npz_path: str, meta_path: str) -> Dict[str, Any]:
    """The full nested fp32 tree of a parameter-stream sidecar, without
    the model: only the masters are read from the npz (``np.load`` reads a
    key at a time; the moments would triple the host RAM)."""
    with open(meta_path) as f:
        meta = json.load(f)
    L = int(meta["n_layers"])
    with np.load(npz_path) as z:
        params = _unflatten_meta(z["res_master"], meta["resident"])
        if meta["homogeneous"]:
            masters = z["masters"]
            per = [_unflatten_meta(masters[l], meta["layer"])
                   for l in range(L)]
        else:
            per = [_unflatten_meta(z[f"master{l}"], meta["layer_list"][l])
                   for l in range(L)]
    if meta.get("stacked"):
        layers = {k: np.stack([p[k] for p in per]) for k in per[0]}
    else:
        layers = per
    params[meta.get("layers_key", "layers")] = layers
    return params


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, Any]:
    """The fp32 params tree (JAX layout) of a port checkpoint."""
    tag = _resolve_tag(ckpt_dir, tag)
    # the parameter stream: its sidecar IS the whole model's fp32 master
    ps = sorted(glob.glob(os.path.join(ckpt_dir, tag,
                                       "zero_param_stream_rank*.npz")))
    if ps:
        meta = ps[0][:-len(".npz")] + ".meta.json"
        if not os.path.exists(meta):
            raise RuntimeError(
                f"{ps[0]} has no .meta.json structure sidecar: re-save it "
                "from a running engine (save_checkpoint writes it) or "
                "export engine.module_state_dict() directly")
        logger.info(f"consolidating from param-stream master {ps[0]}")
        return _param_stream_state_dict(ps[0], meta)
    params = load_checkpoint_tree(ckpt_dir, tag,
                                  load_optimizer_states=False)["params"]
    # ZeRO-Offload: the host master of the sidecar is authoritative
    off = sorted(glob.glob(os.path.join(ckpt_dir, tag,
                                        "zero_offload_rank*.npz")))
    if off:
        with open(os.path.join(ckpt_dir, tag, LAYOUT_NAME)) as f:
            layout = json.load(f)["params"]
        with np.load(off[0]) as z:
            params = _param_tree(z["master"], layout)
        logger.info(f"consolidated from offload master {off[0]}")
    return unflatten({k: np.asarray(v, np.float32)
                      if np.issubdtype(np.asarray(v).dtype, np.floating)
                      else np.asarray(v)
                      for k, v in flatten_with_keystr(params)}, params)


def _flatten_keys(tree) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in flatten_with_keystr(tree)}


def convert_zero_checkpoint_to_fp32_state_dict(ckpt_dir: str,
                                               output_file: str,
                                               tag: Optional[str] = None):
    params = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    np.savez(output_file, **_flatten_keys(params))
    logger.info(f"saved consolidated fp32 state dict to {output_file}")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Consolidate a checkpoint into one fp32 .npz")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output_file")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
