"""Checkpoint inspection and reshaping.

Counterpart of ``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py``.
:func:`load_checkpoint_tree` reads a port training checkpoint
(``runtime/checkpoint_engine.py``: one ``.npy`` per state buffer and
``layout.json``) with numpy alone -- no engine, no card -- and returns it
in the JAX package's param layout (the per-layer tensors stacked under
``["layers"]``, as ``models.convert.to_numpy_params`` lays them out), so
the offline tools below and ``universal_checkpoint`` see the trees the JAX
tools see.  ``merge_tp_shards`` / ``slice_tp_shards`` /
``merge_pp_layer_shards`` are the numpy interop helpers for rank-sharded
formats.
"""

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.models.convert import stack_layers
from deepspeed_tpu_torch.runtime.checkpoint_engine import (CLIENT_STATE_NAME,
                                                           LAYOUT_NAME)
from deepspeed_tpu_torch.utils.logging import logger


def read_latest_tag(ckpt_dir: str) -> Optional[str]:
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return f.read().strip()
    return None


def _resolve_tag(ckpt_dir, tag):
    tag = tag or read_latest_tag(ckpt_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' file under {ckpt_dir}; pass "
                                f"tag=")
    return tag


def _param_tree(flat, params_layout):
    """The JAX-layout param tree of one flat buffer."""
    named = {}
    for name, off, shape in params_layout:
        n = int(np.prod(shape)) if shape else 1
        named[name] = np.asarray(flat[off:off + n]).reshape(shape)
    return stack_layers(named)


def load_checkpoint_tree(ckpt_dir: str, tag: Optional[str] = None,
                         load_optimizer_states: bool = True
                         ) -> Dict[str, Any]:
    """A port checkpoint as a host numpy tree: ``params`` (the fp32
    master), ``opt_state`` (the optimizer's flat buffers under their names
    -- Adam's ``m`` and ``v`` -- in the same layout, as fp32 (bf16 moments
    widened), and its applied ``count``; left out with
    ``load_optimizer_states=False``, which reads the master alone),
    ``loss_scale``, ``skipped_steps`` and ``global_step``."""
    tag = _resolve_tag(ckpt_dir, tag)
    path = os.path.join(os.path.abspath(ckpt_dir), tag)
    with open(os.path.join(path, LAYOUT_NAME)) as f:
        layout = json.load(f)
    buffers = layout["buffers"]

    def buf(key, mmap=False):
        return np.load(os.path.join(path, buffers[key]["file"]),
                       mmap_mode="r" if mmap else None, allow_pickle=False)

    params = layout["params"]
    state = {"params": _param_tree(buf("['master']", mmap=True), params)}
    if load_optimizer_states:
        scalars = ("['master']", "['count']", "['skipped_steps']")
        opt = {}
        for key, rec in buffers.items():
            if key in scalars or key.startswith("['loss_scale']"):
                continue
            flat = buf(key, mmap=True)
            if rec["dtype"] == "bfloat16":     # stored as its bit pattern
                flat = (flat.view(np.uint16).astype(np.uint32) << 16).view(
                    np.float32)
            opt[key[2:-2]] = _param_tree(flat, params)
        opt["count"] = buf("['count']")
        state["opt_state"] = opt
        state["loss_scale"] = {
            k[len("['loss_scale']['"):-2]: buf(k) for k in buffers
            if k.startswith("['loss_scale']")}
        state["skipped_steps"] = buf("['skipped_steps']")
    cs = os.path.join(path, CLIENT_STATE_NAME)
    if os.path.exists(cs):
        with open(cs) as f:
            state["global_step"] = json.load(f).get("global_steps", 0)
    return state


class DeepSpeedCheckpoint:

    def __init__(self, ckpt_dir: str, tag: Optional[str] = None,
                 tp_degree: Optional[int] = None,
                 pp_degree: Optional[int] = None,
                 dp_degree: Optional[int] = None):
        self.dir = ckpt_dir
        self.tag = _resolve_tag(ckpt_dir, tag)
        self.state = load_checkpoint_tree(ckpt_dir, self.tag)
        self.client_state = {}
        cs = os.path.join(ckpt_dir, self.tag, CLIENT_STATE_NAME)
        if os.path.exists(cs):
            with open(cs) as f:
                self.client_state = json.load(f)
        # target degrees are advisory: the state is whole, not sharded
        self.tp_degree = tp_degree or 1
        self.pp_degree = pp_degree or 1
        self.dp_degree = dp_degree or 1
        self.global_state = {
            "iteration": self.client_state.get("global_steps", 0)}

    @property
    def params(self):
        return self.state.get("params", self.state)

    def get_iteration(self) -> int:
        return int(self.global_state["iteration"])

    def show_tp_degree(self):
        logger.info(f"target tp_degree: {self.tp_degree}")

    def validate_files(self):
        path = os.path.join(self.dir, self.tag, LAYOUT_NAME)
        if not os.path.exists(path):
            raise FileNotFoundError(f"missing checkpoint layout at {path}")
        with open(path) as f:
            for rec in json.load(f)["buffers"].values():
                p = os.path.join(self.dir, self.tag, rec["file"])
                if np.load(p, mmap_mode="r").shape != tuple(rec["shape"]):
                    raise ValueError(f"{p}: shape differs from the layout")


# ----------------------------------------------------------------------
# rank-sharded interop
# ----------------------------------------------------------------------
def merge_tp_shards(shards: List[np.ndarray], partition_dim: int
                    ) -> np.ndarray:
    """Concatenate per-TP-rank weight shards into the whole tensor."""
    return np.concatenate([np.asarray(s) for s in shards],
                          axis=partition_dim)


def slice_tp_shards(tensor: np.ndarray, tp_degree: int, partition_dim: int
                    ) -> List[np.ndarray]:
    """Whole tensor -> per-TP-rank shards (the inverse of
    :func:`merge_tp_shards`)."""
    if tensor.shape[partition_dim] % tp_degree:
        raise ValueError(f"dim {partition_dim} "
                         f"({tensor.shape[partition_dim]}) not divisible by "
                         f"tp={tp_degree}")
    return [np.ascontiguousarray(s) for s in
            np.split(tensor, tp_degree, axis=partition_dim)]


def merge_pp_layer_shards(stage_layers: List[Dict[str, np.ndarray]]
                          ) -> Dict[str, np.ndarray]:
    """Stack per-PP-stage layer dicts (each with a leading layer dim) into
    the full stacked-layer tree."""
    return {k: np.concatenate([np.asarray(s[k]) for s in stage_layers],
                              axis=0)
            for k in stage_layers[0]}
