"""Build and load the hand-written CUDA kernels.

Each ``ops/csrc/<source>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (pointers
and the stream as ``c_void_p``, ints as ``c_int``, element counts as
``c_longlong``; every C entry returns ``cudaGetLastError()``).  One source
may export several kernels' entry points.  Libraries are built at first
use into ``deepspeed_tpu_torch/_build/`` (gitignored), named by a hash of
their
sources so an edited kernel is never served from a stale library.
:func:`build` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -split-compile=0: each nvcc runs the device compiler's optimizer over
# its kernels on all the host's cores (the slowest source, ragged paged
# attention's, took 203.5 s without it and 94.5 s with it on the H100
# machine's 8 cores; no kernel spills either way)
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo", "-split-compile=0"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the kernels' entry points
# (kernel name -> source, symbol, argtypes)
SIGNATURES = {
    "decode_attention": ("decode_attention", "ds_decode_attention",
                         [_P] * 6 + [_I] * 10 + [_F, _P]),
    "decode_attention_slots": ("decode_attention",
                               "ds_decode_attention_slots", [_I] * 3),
    # one call launches the decode form, the prefill form or both
    "ragged_paged_attention": ("ragged_paged_attention",
                               "ds_ragged_paged_attention",
                               [_P] * 12 + [_I] * 15 + [_F, _P]),
    "ragged_decode_slots": ("ragged_paged_attention",
                            "ds_ragged_decode_slots", [_I] * 3),
    # the flash entries take the biased kernels' ALiBi slopes (a pointer,
    # null for none) and sliding window (an int, <= 0 for none) as well
    "flash_attention_fwd": ("flash_attention_fwd", "ds_flash_attention_fwd",
                            [_P] * 6 + [_I] * 8 + [_F, _P]),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               "ds_flash_attention_bwd_dq",
                               [_P] * 8 + [_I] * 8 + [_F, _P]),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                "ds_flash_attention_bwd_dkv",
                                [_P] * 9 + [_I] * 8 + [_F, _P]),
    # the backward's row term delta = sum_d dO * O, beside its kernels
    "flash_attention_bwd_delta": ("flash_attention_bwd",
                                  "ds_flash_attention_bwd_delta",
                                  [_P] * 3 + [_I] * 5 + [_P]),
    # fused Adam reads lr, beta1, 1 - beta1, c1, c2, the skip flag and the
    # applied count from device buffers (three pointers after the ints:
    # g's dtype, the moments' dtype, the mode)
    "fused_adam": ("fused_adam", "ds_fused_adam",
                   [_P] * 4 + [_L, _I, _I, _I, _P, _P, _P] + [_F] * 4 +
                   [_P]),
    # the block-sparse entry takes both forms' tables: the fp32 form's
    # (counts, table) and the bf16 form's (counts, starts, steps)
    "sparse_attention": ("sparse_attention", "ds_sparse_attention",
                         [_P] * 9 + [_I] * 8 + [_F, _P]),
}

_lock = threading.Lock()
_loaded = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{source}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:12]}.so"


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile the source of every kernel in ``names`` that has no library
    yet, one ``nvcc`` process per source, all started together.  Returns
    {source: compiler log}; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in dict.fromkeys(SIGNATURES[n][0] for n in names):
        out = _lib_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for source, (proc, tmp, out) in procs.items():
        logs[source] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(source)
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{source}.log").write_text(logs[source])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str):
    """The ctypes function of kernel ``name``, building it on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            source, symbol, argtypes = SIGNATURES[name]
            path = _lib_path(source)
            if not path.exists():
                build((name,))
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
