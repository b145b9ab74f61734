#!/usr/bin/env python3
"""A/B of the fused Adam kernel (B3): a parent commit's form, whose
per-step scalars (lr, beta1, 1 - beta1, c1, c2) are host floats, against
this tree's, which reads them and a skip flag from device buffers.

    python3 scripts/adam_kernel_ab.py --parent DIR [--n N] [--out FILE]

DIR holds the parent's ``fused_adam.cu`` (e.g. ``deepspeed_tpu_torch/ops/
csrc`` of a ``git archive`` of the parent unpacked under the gitignored
``.tmp/``).  Both sources are built with the op builder's nvcc flags, at
once, into ``deepspeed_tpu_torch/_build/ab_adam``.  Over n fp32 elements
(default: gpt_1b's 1,011,165,184 parameters) both forms step the same
p, g, m, v once and must agree bit for bit; then each is timed by CUDA
events (5 launches after one warm-up, from zero moments) in turns parent,
change, change, parent, and the change once more with its skip flag set.
Prints one JSON line (also written to FILE) with the card's name and
power limit.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# the parent's entry: host scalars; this tree's: device buffers (the
# scalars, the skip flag and the applied count) and the moments' dtype
PARENT_ARGS = [_P] * 4 + [_L, _I, _I] + [_F] * 9 + [_P]
CHANGE_ARGS = [_P] * 4 + [_L, _I, _I, _I, _P, _P, _P] + [_F] * 4 + [_P]


def build(sources, out):
    from deepspeed_tpu_torch.ops import op_builder
    os.makedirs(out, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(out, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *op_builder.ARCH_FLAGS, *op_builder.NVCC_FLAGS, "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(lib).ds_fused_adam
        fn.argtypes = PARENT_ARGS if name == "parent" else CHANGE_ARGS
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--n", type=int, default=1_011_165_184)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    from deepspeed_tpu_torch.ops.adam import adam_hyper
    libs = build({"parent": os.path.join(a.parent, "fused_adam.cu"),
                  "change": os.path.join(REPO, "deepspeed_tpu_torch", "ops",
                                         "csrc", "fused_adam.cu")},
                 os.path.join(REPO, "deepspeed_tpu_torch", "_build",
                              "ab_adam"))
    n, lr, b1, b2, eps, wd = a.n, 1e-4, 0.9, 0.999, 1e-8, 0.01
    gen = torch.Generator(device="cuda").manual_seed(3)
    p0 = torch.randn(n, generator=gen, device="cuda") * 0.02
    g = torch.randn(n, generator=gen, device="cuda") * 1e-3
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    hyper = adam_hyper(count, lr, b1, b2)
    c1, c2 = (float(x) for x in hyper[3:].cpu())
    flags = [torch.full((), f, dtype=torch.int32, device="cuda")
             for f in (0, 1)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name, p, m, v, skip=0):
        if name == "parent":
            rc = libs[name](p.data_ptr(), g.data_ptr(), m.data_ptr(),
                            v.data_ptr(), n, 0, 1, lr, b1, 1.0 - b1, b2,
                            1.0 - b2, eps, wd, c1, c2, stream)
        else:
            rc = libs[name](p.data_ptr(), g.data_ptr(), m.data_ptr(),
                            v.data_ptr(), n, 0, 0, 1, hyper.data_ptr(),
                            flags[skip].data_ptr(), count.data_ptr(), b2,
                            1.0 - b2, eps, wd, stream)
        if rc:
            sys.exit(f"{name}: CUDA error {rc}")

    states = {}
    for name in ("parent", "change"):
        st = [p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)]
        launch(name, *st)
        states[name] = st
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(states["parent"],
                                                 states["change"]))
    del states
    p, m, v = p0, torch.zeros_like(p0), torch.zeros_like(p0)

    def time_ms(name, skip=0, iters=5):
        launch(name, p, m, v, skip)
        m.zero_()
        v.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            launch(name, p, m, v, skip)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    turns = [(name, time_ms(name)) for name in
             ("parent", "change", "change", "parent")]
    res = {"card": smi, "n": n, "bit_identical": same, "turns_ms": turns,
           "parent_ms": sum(t for nm, t in turns if nm == "parent") / 2,
           "change_ms": sum(t for nm, t in turns if nm == "change") / 2,
           "change_skip_ms": time_ms("change", skip=1),
           "bound_ms": 28 * n / 3.35e12 * 1e3}
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    if not same:
        sys.exit("the two forms disagree")


if __name__ == "__main__":
    main()
