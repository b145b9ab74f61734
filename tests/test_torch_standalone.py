"""The port stands alone and never carries on on the CPU by accident.

* ``deepspeed_tpu_torch`` (every module of it, the checkpoint tools and
  the fault-tolerance layer among them) and ``chip_smoke.py`` import with
  ``jax`` and ``orbax`` blocked, and load no ``deepspeed_tpu`` module;
* the host C++ of ZeRO-Offload is the port's own copy: built from scratch,
  then run (the aio engine, the NVMe-swapped host Adam, the host benches),
  it opens no file of the JAX package and hands none to ``g++``;
* with no card, entry points called without ``device`` raise
  (``init_inference``, ``initialize``, the model);
* the kernel wrappers and the ``"cuda"`` backend refuse CPU tensors.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.ops.adam import adam_hyper, fused_adam, init_state
from deepspeed_tpu_torch.ops.attention import attention
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_dkv_biased_cuda, flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dq_biased_cuda, flash_attention_bwd_dq_cuda,
    flash_attention_fwd_biased_cuda, flash_attention_fwd_cuda)
from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
from deepspeed_tpu_torch.ops.cuda.decode_attention import \
    decode_attention_cuda
from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_attention_cuda)
from deepspeed_tpu_torch.ops.cuda.sparse_attention import \
    sparse_attention_cuda
from deepspeed_tpu_torch.ops.decode_attention import (decode_attention,
                                                      init_cache)
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention
from torch_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
sys.modules["orbax"] = None        # the JAX checkpoint library too
import deepspeed_tpu_torch
for mod in pkgutil.walk_packages(deepspeed_tpu_torch.__path__,
                                 "deepspeed_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = [m for m in sys.modules
       if m == "deepspeed_tpu" or m.startswith("deepspeed_tpu.")
       or m == "jax" and sys.modules[m] is not None]
assert not bad, bad
print("ok", len([m for m in sys.modules
                 if m.startswith("deepspeed_tpu_torch")]))
"""


def test_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")


_HOST_AUDIT = r"""
import os, sys, tempfile
sys.modules["jax"] = None
jax_pkg = os.path.join(os.getcwd(), "deepspeed_tpu") + os.sep
seen = []


def audit(event, args):
    if event in ("open", "subprocess.Popen", "os.exec", "ctypes.dlopen"):
        seen.extend(str(a) for a in args if isinstance(a, (str, bytes))
                    or hasattr(a, "__fspath__"))
        for a in args:
            if isinstance(a, (list, tuple)):
                seen.extend(str(x) for x in a)


sys.addaudithook(audit)
import torch
from deepspeed_tpu_torch.benchmarks.__main__ import main as ds_bench
from deepspeed_tpu_torch.ops import aio, host_builder
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
tmp = tempfile.mkdtemp()
host_builder.BUILD_DIR = host_builder.Path(tmp) / "build"
h = aio.AsyncIOHandle()
buf = h.new_cpu_locked_tensor(4096, torch.uint8)
h.sync_pwrite(buf, os.path.join(tmp, "blob"))
zc = DeepSpeedZeroConfig({"sub_group_size": 1000, "offload_optimizer": {
    "device": "nvme", "nvme_path": tmp}})
opt = HostOffloadOptimizer(torch.zeros(3000), zc)
opt.step(torch.ones(3000))
ds_bench(["cpu_adam", "--numel", "1000", "--reps", "1"])
built = sorted(p.name.split("-")[0] for p in
               host_builder.BUILD_DIR.glob("*.so"))
bad = [a for a in seen if jax_pkg in os.path.abspath(a.strip("'\""))]
assert built == ["libhost_aio", "libhost_cpu_adam"], built
assert not bad, bad
print("ok", len(seen))
"""


def test_host_code_is_the_ports_own():
    from deepspeed_tpu_torch.ops import host_builder
    port = os.path.join(REPO, "deepspeed_tpu_torch") + os.sep
    assert str(host_builder.HOST_CSRC).startswith(port)
    assert sorted(p.name for p in host_builder.HOST_CSRC.glob("*.cpp")) == \
        ["aio.cpp", "cpu_adam.cpp"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _HOST_AUDIT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("ok ")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalTransformerLM(cfg)
    model = CausalTransformerLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference(model)
    # naming the CPU is the only way onto it
    eng = deepspeed_tpu_torch.init_inference(model, device="cpu")
    assert eng.device.type == "cpu"
    config = {"train_micro_batch_size_per_gpu": 1}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=model, config=config)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                                device="cpu")
    assert engine.device.type == "cpu" and engine.master.device.type == "cpu"


def test_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 1, 4, 64)
    kv = torch.zeros(1, 4, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q, kv, kv, 1)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, init_cache(1, 8, 4, 64, torch.float32,
                                       device="cpu"), backend="cuda")
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_paged_attention_cuda(q[0], kv, kv, i32[None], i32, i32, i32,
                                    i32, i32, 8)
    # the training kernels: flash attention forward / backward, fused Adam
    qs = torch.zeros(1, 8, 4, 128)
    rows = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_cuda(qs, qs, qs, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dq_cuda(qs, qs, qs, qs, rows, rows, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dkv_cuda(qs, qs, qs, qs, rows, rows, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        attention(qs, qs, qs, backend="cuda")
    flat = torch.zeros(16)
    st = init_state(flat)
    hyper = adam_hyper(st.count, 1e-3, 0.9, 0.999)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam_cuda(flat, flat, flat, flat, hyper,
                        torch.zeros((), dtype=torch.int32), st.count, 0.999,
                        1e-8, 0.0, True)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam(flat, flat, st, hyper, backend="cuda")
    # its bf16-moment form too (bf16 gradients and moments)
    st16 = init_state(flat, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam(flat, flat.bfloat16(), st16, hyper, backend="cuda")


def test_biased_and_sparse_wrappers_refuse_cpu_tensors():
    """The biased flash kernels' and the block-sparse kernel's wrappers,
    and the ``"cuda"`` backend of their entry points, refuse CPU
    tensors."""
    qs = torch.zeros(1, 8, 4, 128)
    rows = torch.zeros(1, 4, 8)
    slopes = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd_biased_cuda(qs, qs, qs, 0.1, alibi_slopes=slopes)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dq_biased_cuda(qs, qs, qs, qs, rows, rows, 0.1,
                                           window=4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_dkv_biased_cuda(qs, qs, qs, qs, rows, rows, 0.1,
                                            alibi_slopes=slopes, window=4)
    with pytest.raises(ValueError, match="CUDA"):
        attention(qs, qs, qs, backend="cuda", alibi_slopes=[1.0] * 4)
    layout = np.ones((4, 1, 1), bool)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_attention_cuda(qs, qs, qs, layout, 8)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_attention(qs, qs, qs, layout, 8, backend="cuda")


def test_init_inference_refuses_hf_models():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(2, 2),
                                           device="cpu")
