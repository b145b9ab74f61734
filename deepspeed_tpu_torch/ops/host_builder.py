"""Build and load the host C++ of ZeRO-Offload (the CPU side).

Counterpart of the JAX package's ``ops/native.py``: ``g++ -O3 -shared
-fPIC -std=c++17 -fopenmp -march=native`` over a source of
``ops/csrc/host/`` into a shared library loaded with ``ctypes``, built at
first use into ``deepspeed_tpu_torch/_build/`` (gitignored) beside the
CUDA kernels' libraries.  The library's name holds a hash of the source,
the flags and the host CPU's model and feature flags: ``-march=native``
code is never reused on another CPU, nor an edited source served from a
stale library.  Each build goes to a temporary name and is renamed into place, so
parallel test workers never load a half-written library.

A failed build raises.  Nothing falls back to numpy or to Python I/O: the
port runs its host C++ or nothing (the JAX package falls back quietly).
Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

HOST_CSRC = Path(__file__).resolve().parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
             "-march=native"]

_lock = threading.Lock()
_loaded = {}


def _cpuinfo(field: str):
    """The first ``field`` line's value in ``/proc/cpuinfo``, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":", 1)[0].strip() == field:
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), or the machine type
    where the kernel gives none."""
    return _cpuinfo("model name") or os.uname().machine


def _lib_path(source: str, ldflags) -> Path:
    h = hashlib.sha256()
    h.update((HOST_CSRC / f"{source}.cpp").read_bytes())
    h.update(" ".join(CXX_FLAGS + list(ldflags)).encode())
    # -march=native follows the CPU's features: its model and flags
    h.update(f"{cpu_model()} {_cpuinfo('flags')}".encode())
    return BUILD_DIR / f"libhost_{source}-{h.hexdigest()[:12]}.so"


def build(source: str, ldflags=()) -> Path:
    """Compile ``ops/csrc/host/<source>.cpp`` unless its library exists;
    returns the library's path.  Raises if ``g++`` is missing or fails."""
    out = _lib_path(source, ldflags)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the host C++ of {source} "
                           f"builds only where g++ is installed")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(HOST_CSRC / f"{source}.cpp"), "-o",
           str(tmp), *ldflags]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def load(source: str, signatures, ldflags=()):
    """The ``ctypes`` library of ``source``, built on first use, with
    ``signatures`` ({symbol: (argtypes, restype)}) declared."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, ldflags)))
            for symbol, (argtypes, restype) in signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded[source] = lib
        return lib
