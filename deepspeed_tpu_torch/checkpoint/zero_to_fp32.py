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
The param-stream sidecar is not ported yet (ROADMAP A12b).
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


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, Any]:
    """The fp32 params tree (JAX layout) of a port checkpoint."""
    tag = _resolve_tag(ckpt_dir, tag)
    if glob.glob(os.path.join(ckpt_dir, tag, "zero_param_stream_rank*.npz")):
        raise NotImplementedError(
            "zero_param_stream_rank*.npz sidecars (param streaming) are not "
            "ported yet (ROADMAP A12b)")
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
