"""Host Adam throughput (``ds_bench cpu_adam``).

Counterpart of the JAX package's ``benchmarks/cpu_adam.py``: the
ZeRO-Offload step is host-bound, so the fused C++ pass
(``ops/csrc/host/cpu_adam.cpp``, OpenMP and the compiler's vectors) is
timed against the same rule in plain PyTorch (where the JAX bench times
its numpy fallback) and against the host's memory rate: an element moves
7 x 4 bytes a step (p, g, m, v read; p, m, v written).  Usage::

    python -m deepspeed_tpu_torch.benchmarks cpu_adam [--numel 50000000]

Prints one JSON line per implementation and a summary line.
"""

import argparse
import json
import time

import numpy as np
import torch

from deepspeed_tpu_torch.ops import cpu_adam

BYTES_PER_ELEM = 7 * 4  # read p, g, m, v; write p, m, v (fp32)


def _time_impl(numel: int, reps: int, plain: bool):
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.normal(size=numel).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=numel).astype(np.float32))
    st = cpu_adam.init_state(numel)
    update = cpu_adam.adam_update_plain if plain else cpu_adam.adam_update
    ts = []
    for _ in range(reps + 1):   # the first rep takes the page faults
        t0 = time.perf_counter()
        st = update(p, g, st, lr=1e-4, weight_decay=0.01)
        ts.append(time.perf_counter() - t0)
    best = min(ts[1:])
    return {
        "impl": "plain_torch" if plain else "fused_cpp",
        "numel": numel,
        "sec_per_step": round(best, 4),
        "gbps": round(numel * BYTES_PER_ELEM / best / 1e9, 2),
        "melem_per_sec": round(numel / best / 1e6, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ds_bench cpu_adam")
    ap.add_argument("--numel", type=int, default=50_000_000,
                    help="elements per step (50M fp32 = 200MB params, the "
                         "shape of a ~1B-param model's offload sub-group)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    rows = [_time_impl(args.numel, args.reps, plain=False),
            _time_impl(args.numel, args.reps, plain=True)]
    rows.append({
        "metric": "cpu_adam_fused_vs_plain_speedup",
        "value": round(rows[1]["sec_per_step"] / rows[0]["sec_per_step"], 2),
        "unit": "x",
        "fused_gbps": rows[0]["gbps"],
        "plain_gbps": rows[1]["gbps"],
    })
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
