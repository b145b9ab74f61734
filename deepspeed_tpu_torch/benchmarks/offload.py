"""The NVMe-swapped optimizer step, pipelined against serial
(``ds_bench offload``).

Counterpart of the JAX package's ``benchmarks/offload.py``: one host
optimizer (``runtime/zero/offload.py``, AdamW over ``--numel`` fp32
elements in ``--sub-groups`` sub-groups, its moments swapped to files)
timed with the swapper's pipeline (the next sub-group's moments read
while one updates, write-backs behind) and with every read and write
serial, on the same store.  Usage::

    python -m deepspeed_tpu_torch.benchmarks offload [--numel 100000000] \
        [--swap-dir /path/on/nvme]

Prints one JSON line per mode and a speedup line.
"""

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer


def _build(numel, sub_group_size, swap_dir, pipelined):
    zc = DeepSpeedZeroConfig({
        "stage": 3,
        "sub_group_size": sub_group_size,
        "offload_optimizer": {"device": "nvme", "nvme_path": swap_dir},
    })
    opt = HostOffloadOptimizer(torch.zeros(numel), zc, opt_name="adamw",
                               opt_params={"lr": 1e-4})
    opt.swapper.pipelined = pipelined
    return opt


def _time_steps(opt, numel, reps):
    rng = np.random.default_rng(0)
    grads = torch.from_numpy(rng.normal(size=numel).astype(np.float32))
    opt.step(grads)                  # warm: makes the swap files
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        opt.step(grads)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ds_bench offload")
    ap.add_argument("--numel", type=int, default=100_000_000,
                    help="flat fp32 master elements (100M = 400MB, 800MB "
                         "of swapped Adam moments)")
    ap.add_argument("--sub-groups", type=int, default=8)
    ap.add_argument("--swap-dir", default=None,
                    help="put this on the NVMe device to bench it; "
                         "default: a new temp dir")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    base = args.swap_dir or tempfile.mkdtemp(prefix="ds_offload_bench_")
    sub = -(-args.numel // args.sub_groups)
    rows = []
    try:
        for pipelined in (True, False):
            d = tempfile.mkdtemp(dir=base)
            opt = _build(args.numel, sub, d, pipelined)
            sec = _time_steps(opt, args.numel, args.reps)
            rows.append({
                "mode": "pipelined" if pipelined else "serial",
                "numel": args.numel, "sub_groups": args.sub_groups,
                "sec_per_step": round(sec, 4),
                # moments read and written a step: 2 x 2 x 4 B an element
                "swapped_gbps": round(args.numel * 16 / sec / 1e9, 2),
            })
            print(json.dumps(rows[-1]))
            del opt
            shutil.rmtree(d, ignore_errors=True)
    finally:
        if args.swap_dir is None:
            shutil.rmtree(base, ignore_errors=True)
    rows.append({"metric": "offload_pipeline_speedup",
                 "value": round(rows[1]["sec_per_step"] /
                                rows[0]["sec_per_step"], 2),
                 "unit": "x"})
    print(json.dumps(rows[-1]))
    return rows


if __name__ == "__main__":
    main()
