"""Environment / compatibility report -- ``ds_report`` for the port.

Counterpart of ``deepspeed_tpu/env_report.py``: the op compatibility
table, then the versions and the device.  The ops are the port's kernel
libraries (``ops/op_builder.SIGNATURES``: one row per kernel entry); a
library is compatible when ``nvcc`` and a compute-capability-9.0 card
(Hopper, which ``sm_90a`` needs) are both present.  ``--kernel-gate``
builds every library (``op_builder.build()``, one ``nvcc`` per source, all
at once) -- the counterpart of the JAX report's Mosaic compile gate.

    python -m deepspeed_tpu_torch.env_report [--kernel-gate] [-v]
"""

import re
import shutil
import subprocess
import sys

import torch

GREEN = "\033[92m"
RED = "\033[91m"
YELLOW = "\033[93m"
END = "\033[0m"
OKAY = f"{GREEN}[OKAY]{END}"
WARNING = f"{YELLOW}[WARNING]{END}"
NO = f"{RED}[NO]{END}"
HOPPER = (9, 0)


def nvcc_version():
    """``nvcc``'s release ("12.8"), or None when there is no nvcc."""
    from deepspeed_tpu_torch.ops import op_builder
    try:
        path = op_builder._nvcc()
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"release (\d+\.\d+)", out)
    return m.group(1) if m else "?"


def card_capability():
    """The first card's compute capability, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_capability(0)


def compatibility(verbose=False):
    """(compatible, why not): the libraries build and run only with nvcc
    and a compute-capability-9.0 card."""
    nvcc, cap = nvcc_version(), card_capability()
    why = []
    if nvcc is None:
        why.append("no nvcc")
    if cap is None:
        why.append("no CUDA device")
    elif tuple(cap) != HOPPER:
        why.append(f"compute capability {cap[0]}.{cap[1]}, not 9.0")
    if verbose and why:
        print(f"{WARNING} kernels not compatible: {', '.join(why)}")
    return not why, ", ".join(why)


def op_report(verbose=False):
    """Print and return [(kernel, source, compatible)], one row per entry
    of ``op_builder.SIGNATURES``."""
    from deepspeed_tpu_torch.ops.op_builder import SIGNATURES
    compatible, _ = compatibility(verbose=verbose)
    max_dots = 30
    print("-" * 72)
    print("DeepSpeed-TPU (PyTorch / CUDA port) kernel report")
    print("-" * 72)
    print("op name" + "." * (max_dots - len("op name")) + "compatible")
    print("-" * 72)
    rows = []
    for name in sorted(SIGNATURES):
        print(name + "." * max(1, max_dots - len(name)) +
              (OKAY if compatible else NO))
        rows.append((name, SIGNATURES[name][0], compatible))
    return rows


def _power_limit():
    """nvidia-smi's power limit of the first card, or None."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def debug_report():
    """Print and return [(key, value)]: Python, torch, CUDA and nvcc
    versions, the card count, and the first card's name, memory and power
    limit."""
    print("-" * 72)
    print("DeepSpeed-TPU (PyTorch / CUDA port) general environment info:")
    print("-" * 72)
    import deepspeed_tpu_torch
    rows = [
        ("python version", sys.version.replace("\n", " ")),
        ("torch version", torch.__version__),
        ("torch CUDA version", torch.version.cuda),
        ("nvcc version", nvcc_version()),
        ("deepspeed_tpu_torch version", deepspeed_tpu_torch.__version__),
        ("device count", torch.cuda.device_count()
         if torch.cuda.is_available() else 0),
    ]
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        rows += [("device name", props.name),
                 ("compute capability", f"{props.major}.{props.minor}"),
                 ("memory per device",
                  f"{props.total_memory / 2**30:.1f} GiB"),
                 ("power limit", _power_limit())]
    for k, v in rows:
        print(f"{k} {'.' * max(1, 40 - len(k))} {v}")
    return rows


def build_gate():
    """Build every kernel library; 0 if all build, else 1."""
    from deepspeed_tpu_torch.ops import op_builder
    print("\nkernel build gate (nvcc, sm_90a):")
    try:
        logs = op_builder.build()
    except RuntimeError as e:
        print(f"{NO} {e}")
        return 1
    built = sorted(logs) or ["(every library already built)"]
    print(f"{OKAY} built: {', '.join(built)}")
    return 0


def main(verbose=False, kernel_gate=False):
    op_report(verbose=verbose)
    debug_report()
    return build_gate() if kernel_gate else 0


def cli_main(argv=None):  # console entry point
    argv = sys.argv[1:] if argv is None else argv
    sys.exit(main(verbose="-v" in argv or "--verbose" in argv,
                  kernel_gate="--kernel-gate" in argv))


if __name__ == "__main__":
    cli_main()
