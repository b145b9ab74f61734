"""Port parity of ZeRO-Offload and ZeRO-Infinity's optimizer swap (ROADMAP
A12, first part).

Mirrors ``tests/unit/test_offload.py``, ``test_offload_overlap.py`` and the
host-op parts of ``test_ops.py`` on the port:

* the host C++ (``ops/csrc/host/cpu_adam.cpp``, the JAX package's source
  copied) built by the port agrees BIT FOR BIT with the JAX package's
  build of the same source on the same numpy-seeded inputs (same flags,
  same CPU): Adam in AdamW and L2 mode, with and without bias
  correction, and Adagrad; the plain PyTorch versions agree within 2 fp32
  ulps a step of the largest term (the C++ may fuse a multiply and an
  add); a build that fails raises, with nothing to fall back to;
* ``HostOffloadOptimizer`` against the JAX one, cpu and nvme, over several
  sub-groups: master and moments bit for bit after 3 steps (Adam; the
  JAX offload Adagrad runs numpy, whose unfused roundings differ, so
  Adagrad's are held within 2 ulps a step);
* the NVMe swapper's state machine and its manifest (the JAX tests'
  cases), the tiered store's surface, the aio handle;
* the engine on a tiny ``CausalTransformerLM`` (2 layers, d 64, fp32,
  ``device="cpu"``): the offload trajectory against the JAX engine's
  offload trajectory (losses and grad norms rtol 1e-4, final parameters
  as ``tests/test_torch_training.py`` holds them), against the port's own
  device path (losses rtol 1e-4), nvme bit for bit against cpu, the
  three-call API, checkpoints, ``zero_to_fp32``, the fp16 skip's lr
  counter (the schedule at ``global_steps``, skipped steps counted) and the
  configuration rules;
* ``cpu_checkpointing``: the same gradients as without it, with the
  block's products kept in host memory.
"""

import ctypes
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.ops import cpu_adam as jax_cpu_adam
from deepspeed_tpu.ops import native as jax_native
from deepspeed_tpu.runtime.lr_schedules import \
    build_schedule as jax_build_schedule
from deepspeed_tpu.runtime.zero.config import \
    DeepSpeedZeroConfig as JaxZeroConfig
from deepspeed_tpu.runtime.zero.offload import \
    HostOffloadOptimizer as JaxHostOffloadOptimizer
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.models.convert import to_numpy_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.ops import aio, cpu_adam, host_builder
from deepspeed_tpu_torch.runtime import resilience
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt
from deepspeed_tpu_torch.runtime.tiered_store import (PlacementPolicy,
                                                      PrefetchEngine,
                                                      TieredStore)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffloadOptimizer,
                                                      OptimizerStateSwapper)
from torch_threads import _one_torch_thread  # noqa: F401

F32_EPS = 2.0 ** -23


def _rand(rng, n, scale=1.0, positive=False):
    x = rng.normal(size=n).astype(np.float32) * np.float32(scale)
    return np.abs(x) if positive else x


def _ulp_close(got, want, scale, steps):
    """|got - want| within 2 fp32 ulps a step of ``scale`` (the largest
    term the value came from), elementwise."""
    tol = 2 * steps * F32_EPS * np.maximum(np.abs(scale), np.abs(want))
    assert np.all(np.abs(got - want) <= tol), \
        np.max(np.abs(got - want) / np.maximum(tol, 1e-45))


# ---------------------------------------------------------- the host C++
@pytest.mark.parametrize("adamw,bias_correction", [
    (True, True), (False, True), (True, False)])
def test_host_adam_matches_jax_build(adamw, bias_correction):
    assert jax_cpu_adam._load_native() is not None   # JAX's C++, not numpy
    rng = np.random.default_rng(0)
    n = 10_007
    p, g = _rand(rng, n), _rand(rng, n)
    m, v = _rand(rng, n, 0.1), _rand(rng, n, 0.01, positive=True)
    jp, jst = p.copy(), jax_cpu_adam.CPUAdamState(m.copy(), v.copy(), 2)
    tp = torch.tensor(p)
    tst = cpu_adam.CPUAdamState(torch.tensor(m), torch.tensor(v), 2)
    kw = dict(lr=1e-3, weight_decay=0.01, adamw_mode=adamw,
              bias_correction=bias_correction)
    for step in range(3):
        gs = g * np.float32(1 + step)
        jst = jax_cpu_adam.adam_update(jp, gs, jst, **kw)
        tst = cpu_adam.adam_update(tp, torch.tensor(gs), tst, **kw)
        assert tst.step == jst.step == step + 3
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tst.m.numpy(), jst.m)
    np.testing.assert_array_equal(tst.v.numpy(), jst.v)


def _jax_adagrad_build():
    """The JAX package's build of the same source, its ``adagrad_update``
    symbol (the JAX module's Python wrapper runs numpy instead)."""
    lib = jax_native.load_extension("cpu_adam", [jax_cpu_adam._CPP_SRC])
    fn = lib.adagrad_update
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long] + \
        [ctypes.c_float] * 3
    fn.restype = None
    return fn


def test_host_adagrad_matches_jax_build():
    rng = np.random.default_rng(1)
    n = 10_007
    p, g = _rand(rng, n), _rand(rng, n)
    sq = _rand(rng, n, 0.1, positive=True)
    jp, jsq = p.copy(), sq.copy()
    tp, tsq = torch.tensor(p), torch.tensor(sq)
    fn = _jax_adagrad_build()
    for _ in range(3):
        fn(jp.ctypes.data, g.ctypes.data, jsq.ctypes.data, n, 1e-2, 1e-10,
           0.01)
        cpu_adam.adagrad_update(tp, torch.tensor(g), tsq, lr=1e-2,
                                weight_decay=0.01)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tsq.numpy(), jsq)


def test_plain_versions_agree_within_ulps():
    """The plain PyTorch versions against the C++: 2 fp32 ulps a step of
    the largest term (the C++ fuses some multiply-adds)."""
    rng = np.random.default_rng(2)
    n, steps = 4099, 3
    p, g = _rand(rng, n), _rand(rng, n)
    m, v = _rand(rng, n, 0.1), _rand(rng, n, 0.01, positive=True)
    for adamw in (True, False):
        a = [torch.tensor(x) for x in (p, m, v)]
        b = [torch.tensor(x) for x in (p, m, v)]
        sa = cpu_adam.CPUAdamState(a[1], a[2], 0)
        sb = cpu_adam.CPUAdamState(b[1], b[2], 0)
        for _ in range(steps):
            sa = cpu_adam.adam_update(a[0], torch.tensor(g), sa,
                                      weight_decay=0.01, adamw_mode=adamw)
            sb = cpu_adam.adam_update_plain(b[0], torch.tensor(g), sb,
                                            weight_decay=0.01,
                                            adamw_mode=adamw)
        _ulp_close(b[1].numpy(), a[1].numpy(), np.abs(m) + np.abs(g), steps)
        _ulp_close(b[2].numpy(), a[2].numpy(), np.abs(v) + g * g, steps)
        _ulp_close(b[0].numpy(), a[0].numpy(), np.abs(p) + 1e-3 * steps,
                   steps)
    a = [torch.tensor(x) for x in (p, np.abs(v))]
    b = [torch.tensor(x) for x in (p, np.abs(v))]
    for _ in range(steps):
        cpu_adam.adagrad_update(a[0], torch.tensor(g), a[1], lr=1e-2)
        cpu_adam.adagrad_update_plain(b[0], torch.tensor(g), b[1], lr=1e-2)
    _ulp_close(b[1].numpy(), a[1].numpy(), np.abs(v) + steps * g * g, steps)
    _ulp_close(b[0].numpy(), a[0].numpy(), np.abs(p) + 1e-2 * steps, steps)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No g++, or a source g++ refuses: the build raises (nothing falls
    back to numpy or a plain version); the library's name holds the CPU
    model, so -march=native code is never reused on another CPU."""
    monkeypatch.setattr(host_builder, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_builder, "_loaded", {})
    path = host_builder._lib_path("cpu_adam", ())
    monkeypatch.setattr(host_builder, "cpu_model", lambda: "another CPU")
    assert host_builder._lib_path("cpu_adam", ()) != path
    monkeypatch.setattr(host_builder.shutil, "which", lambda name: None)
    t = torch.zeros(8)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        cpu_adam.adam_update(t, t.clone(), cpu_adam.init_state(8))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        aio.AsyncIOHandle()
    monkeypatch.undo()
    (tmp_path / "broken.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(host_builder, "HOST_CSRC", tmp_path)
    monkeypatch.setattr(host_builder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken"):
        host_builder.build("broken")
    assert not list((tmp_path / "build").glob("*"))   # no half library


def test_host_update_checks_its_tensors():
    t = torch.zeros(8)
    with pytest.raises(ValueError, match="fp32"):
        cpu_adam.adam_update(t.double(), t, cpu_adam.init_state(8))
    with pytest.raises(ValueError, match="elements"):
        cpu_adam.adagrad_update(t, torch.zeros(4), torch.zeros(8))


# --------------------------------------------------- aio and the store
def test_aio_round_trip_and_queues(tmp_path):
    h = aio.AsyncIOHandle(block_size=4096, queue_depth=4)
    buf = h.new_cpu_locked_tensor(3 * 4096 + 100, torch.uint8)
    buf.copy_(torch.arange(buf.numel()) % 251)
    path = str(tmp_path / "blob.bin")
    assert h.sync_pwrite(buf, path) == buf.numel()
    back = torch.zeros_like(buf)
    h.async_pread(back, path)
    h.async_pread(torch.zeros(16, dtype=torch.uint8), path, 4096)
    assert h.wait() == 2
    assert torch.equal(back, buf)
    # the blocking path on a thread pool (io_uring refused) does the same
    pool = aio.AsyncIOHandle(thread_count=2)
    if pool.uses_io_uring():
        pool._lib.ds_aio_destroy(pool._engine)
        pool._engine = None
    back.zero_()
    pool.async_pread(back, path)
    pool.async_pwrite(buf, str(tmp_path / "copy.bin"))
    assert pool.wait() == 2 and torch.equal(back, buf)
    aio.aio_read(back, str(tmp_path / "copy.bin"))
    assert torch.equal(back, buf)
    h.free_cpu_locked_tensor(buf)
    with pytest.raises(OSError, match="short read"):
        h.sync_pread(torch.zeros(1 << 20, dtype=torch.uint8), path)


def test_tiered_store_swap_surface(tmp_path):
    store = TieredStore(name="s", nvme_dir=str(tmp_path))
    assert store.nvme_path == str(tmp_path / "ds_tiered" / "s")
    store.register_swap("a/b", 1000)
    buf = store.alloc_pinned(1000)
    buf.copy_(torch.arange(1000.0))
    store.write_from("a/b", buf, sync=False)
    store.writer_wait()
    back = torch.zeros(1000)
    store.read_into("a/b", back, async_op=True)
    store.reader_wait()
    assert torch.equal(back, buf) and "a/b" in store and len(store) == 1
    stats = store.stats()
    assert stats["nvme_bytes"] == 4000 and stats["writebacks"] == 1
    assert store.tier_bytes() == {"hbm": 0, "host": 0, "nvme": 4000}
    store.note_transfer("h2d", 10, 1.0)
    store.note_prefetch(True, 3)
    assert store.stats()["prefetch_hit_rate"] == 1.0
    assert store.commit() == store.nvme_path
    assert store.validate()[0] == resilience.COMMITTED
    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        store.publish_gauges()
    # the parameter stream's part runs (A12b): the policy, and planes in
    # RAM and on NVMe (a bf16 one mapped as uint16), catalogued by tier
    assert PlacementPolicy().place("w", 10) == "host"
    ram = store.register_plane("p/ram", (2, 3))
    mapped = store.register_plane("p/mm", 5, torch.bfloat16,
                                  nvme_dir=str(tmp_path / "planes"))
    mapped.fill_(1.5)
    assert ram.shape == (2, 3) and not ram.any()
    assert os.path.exists(tmp_path / "planes" / "p_mm.mm")
    assert np.load(tmp_path / "planes" / "p_mm.mm", mmap_mode="r").dtype == \
        np.uint16
    assert store.tier_bytes() == {"hbm": 0, "host": 24, "nvme": 4010}
    # ZeRO-Inference's weight streaming raises A12c, the int8 tier A13
    for call in (lambda: store.put("k", buf), lambda: store.fetch("k"),
                 lambda: store.evict("k"),
                 lambda: PrefetchEngine(store, []),
                 lambda: TieredStore(host_budget_bytes=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP A12c"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        TieredStore(policy=PlacementPolicy(quantize=True))
    store.destroy()
    assert not os.path.exists(store.nvme_path) and len(store) == 0


# ------------------------------------------------ the swapper (JAX tests)
def _full(n, x):
    return torch.full((n,), float(x))


def test_optimizer_state_swapper_persistence(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path), n_tensors=2,
                               subgroup_sizes=[10, 10, 6], buffer_count=2)
    m, v = sw.swap_in(0)
    m[:] = 1.5
    v[:] = 2.5
    sw.swap_out(0)
    for g in (1, 2):     # recycle group 0's slot
        bufs = sw.swap_in(g)
        bufs[0][:] = g
        sw.swap_out(g)
    sw.release()
    m2, v2 = sw.swap_in(0)
    assert torch.equal(m2, _full(10, 1.5)) and torch.equal(v2, _full(10, 2.5))


def test_swapper_prefetch_next_while_updating(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path), n_tensors=2,
                               subgroup_sizes=[8, 8, 8], buffer_count=2)
    for g in range(3):
        for t, b in enumerate(sw.swap_in(g)):
            b[:] = 10 * g + t
        sw.swap_out(g)
    sw.release()
    m0, v0 = sw.swap_in(0)
    snap = (m0.clone(), v0.clone())
    sw.swap_in(1, prefetch=True)
    m0 += 1.0            # the in-flight read must not clobber this
    v0 += 1.0
    sw.swap_out(0)
    assert torch.equal(m0, snap[0] + 1.0)
    m1, v1 = sw.swap_in(1)      # waits for the reader
    assert torch.equal(m1, _full(8, 10)) and torch.equal(v1, _full(8, 11))
    sw.release()
    assert torch.equal(sw.swap_in(0)[0], snap[0] + 1.0)


def test_swapper_writeback_ordering_on_slot_reuse(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path), n_tensors=1,
                               subgroup_sizes=[16, 16, 16, 16],
                               buffer_count=2)
    for g in range(4):
        (b,) = sw.swap_in(g)
        b[:] = float(g + 1)
        sw.swap_out(g)
    sw.release()
    for g in range(4):
        (b,) = sw.swap_in(g)
        assert torch.equal(b, _full(16, g + 1))


def test_swapper_release_leaves_no_stranded_files(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path), n_tensors=2,
                               subgroup_sizes=[12, 12], buffer_count=2)
    for g in range(2):
        for b in sw.swap_in(g):
            b[:] = g + 0.5
        sw.swap_out(g)
    sw.release()
    status, manifest = resilience.validate_tag(str(tmp_path))
    assert status == resilience.COMMITTED
    on_disk = {f for f in os.listdir(tmp_path)
               if f not in (resilience.MANIFEST_NAME,
                            resilience.COMMIT_MARKER)}
    listed = {f["path"] for f in manifest["files"]}
    assert on_disk == listed and len(listed) == 4


def test_swapper_torn_file_detected_via_manifest(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path), n_tensors=1,
                               subgroup_sizes=[32], buffer_count=2)
    (b,) = sw.swap_in(0)
    b[:] = 7.0
    sw.swap_out(0)
    sw.release()
    assert sw.store.validate()[0] == resilience.COMMITTED
    with open(sw._path(0, 0), "r+b") as f:
        f.truncate(8)
    assert sw.store.validate()[0] == resilience.PARTIAL
    os.remove(os.path.join(str(tmp_path), resilience.COMMIT_MARKER))
    assert sw.store.validate()[0] == resilience.NO_MARKER


def test_swapper_makes_only_the_slots_it_uses(tmp_path):
    """A ring slot's pinned buffers are made at its first use: one
    sub-group under buffer_count 4 holds one slot's."""
    sw = OptimizerStateSwapper(str(tmp_path), n_tensors=2,
                               subgroup_sizes=[64], buffer_count=4)
    assert sw._buffers == [None] * 4
    for _ in range(2):
        sw.swap_in(0)
        sw.swap_out(0)
        sw.release()
    assert [b is not None for b in sw._buffers] == [True, False, False,
                                                    False]


def _offload_opt(tmp_path, numel, sub, pipelined, name="adamw"):
    zc = DeepSpeedZeroConfig({
        "stage": 3, "sub_group_size": sub,
        "offload_optimizer": {"device": "nvme",
                              "nvme_path": str(tmp_path)}})
    opt = HostOffloadOptimizer(torch.zeros(numel), zc, opt_name=name,
                               opt_params={"lr": 1e-4})
    opt.swapper.pipelined = pipelined
    return opt


def test_pipelined_and_serial_agree_numerically(tmp_path):
    numel, sub = 100_000, 25_000
    masters = {}
    for name, piped in (("s", False), ("p", True)):
        opt = _offload_opt(tmp_path / name, numel, sub, piped)
        rng = np.random.default_rng(1)
        for _ in range(3):
            opt.step(torch.from_numpy(rng.normal(size=numel)
                                      .astype(np.float32)))
        masters[name] = opt.master
    assert torch.equal(masters["s"], masters["p"])


# ------------------------------------- HostOffloadOptimizer against JAX
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(40, 30)).astype(np.float32)},
            "b": rng.normal(size=(77,)).astype(np.float32)}


def _flat(tree):
    """The JAX FlatLayout's order: leaves in tree order, raveled."""
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("device", ["cpu", "nvme"])
@pytest.mark.parametrize("name,params", [
    ("adamw", {"lr": 1e-3, "weight_decay": 0.01}),
    ("adam", {"lr": 1e-3, "weight_decay": 0.01}),
    ("adagrad", {"lr": 1e-2})])
def test_host_offload_optimizer_matches_jax(tmp_path, device, name, params):
    """Several sub-groups, 3 steps (the last streamed, clipped): master and
    moments bit for bit for Adam; Adagrad within 2 ulps a step."""
    zero = {"stage": 2, "sub_group_size": 200,
            "offload_optimizer": {"device": device,
                                  "nvme_path": str(tmp_path / "jax")}}
    tree = _tree()
    jopt = JaxHostOffloadOptimizer(tree, JaxZeroConfig(zero), opt_name=name,
                                   opt_params=params)
    zero["offload_optimizer"]["nvme_path"] = str(tmp_path / "port")
    topt = HostOffloadOptimizer(torch.from_numpy(_flat(tree)),
                                DeepSpeedZeroConfig(zero), opt_name=name,
                                opt_params=params)
    assert topt.subgroups == jopt.subgroups and len(topt.subgroups) == 7
    assert (topt.swapper is None) == (device == "cpu")
    for step in range(3):
        grads = _tree(seed=10 + step)
        if step < 2:
            jopt.step(grads, lr=1e-3 * (step + 1))
            topt.step(torch.from_numpy(_flat(grads)), lr=1e-3 * (step + 1))
        else:
            jopt.step_streamed(grads, lr=5e-4, clip_coef=0.3)
            topt.step_streamed(torch.from_numpy(_flat(grads)), lr=5e-4,
                               clip_coef=0.3)
    want, got = jopt.state_dict(), topt.state_dict()
    assert got["step"] == want["step"] == 3
    keys = ["master"] + [f"moment{i}" for i in range(topt.n_moments)]
    for key in keys:
        if name == "adagrad":     # JAX's offload Adagrad runs numpy
            _ulp_close(got[key].numpy(), want[key],
                       np.abs(want[key]) + 1e-2, 3)
        else:
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=key)


def test_streamed_step_matches_step_and_writes_the_weights():
    """The pipeline's pieces (finer than the sub-groups here) give the
    unpipelined step's master bit for bit, and write each piece, cast,
    into ``out``."""
    from deepspeed_tpu_torch.runtime.zero import offload
    zc = DeepSpeedZeroConfig({"sub_group_size": 3000,
                              "offload_optimizer": {"device": "cpu"}})
    rng = np.random.default_rng(4)
    master = torch.from_numpy(rng.normal(size=10_000).astype(np.float32))
    a = HostOffloadOptimizer(master.clone(), zc)
    b = HostOffloadOptimizer(master.clone(), zc)
    out = torch.zeros(10_000, dtype=torch.bfloat16)
    old = offload.PIPELINE_CHUNK
    offload.PIPELINE_CHUNK = 1024
    try:
        for _ in range(2):
            g = torch.from_numpy(rng.normal(size=10_000).astype(np.float32))
            a.step(g * 0.5)
            b.step_streamed(g, clip_coef=0.5, out=out)
            assert torch.equal(a.master, b.master)
            assert torch.equal(out, b.master.bfloat16())
        # sub-groups of 3000, 3000, 3000, 1000 in pieces of <= 1024
        assert b.last_step["pieces"] == 10 and b.subgroup_updates == 8
    finally:
        offload.PIPELINE_CHUNK = old
    for ma, mb in zip(a.moments, b.moments):
        assert torch.equal(ma, mb)


# ------------------------------------------------------------ the engine
JAX_DEVICES = 8
GPT = dict(hidden_size=64, n_heads=4, n_layers=2, activation="gelu",
           use_rmsnorm=False, use_rope=False, norm_bias=True,
           tie_embeddings=True)
SEQ = 16


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32),
        JaxLM(JaxConfig.tiny(**GPT)).init(jax.random.key(seed)))


def _config(micro, zero=None, clip=0.5, gas=2, **extra):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": clip, **extra}
    if zero is not None:
        cfg["zero_optimization"] = zero
    return cfg


OFFLOAD_CPU = {"stage": 2, "offload_optimizer": {"device": "cpu"},
               "sub_group_size": 20_000}


def _port(config, params=None):
    return deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(**GPT),
                                  device="cpu"),
        model_parameters=params if params is not None else _params(),
        config=config, device="cpu")[0]


def _batches(n=3, gas=2, micro=JAX_DEVICES, seed=5):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (gas, micro, SEQ))}
            for _ in range(n)]


def test_engine_offload_trajectory_matches_jax():
    """The port's offload engine against the JAX engine's offload engine
    (8 virtual devices, micro 1 each; the port micro 8): losses and grad
    norms rtol 1e-4 over 3 clipped steps, final parameters atol 2e-5 +
    rtol 1e-4, as tests/test_torch_training.py holds the device paths."""
    params = _params()
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(JaxConfig.tiny(**GPT)), model_parameters=params,
        config=_config(1, dict(OFFLOAD_CPU)))
    teng = _port(_config(JAX_DEVICES, dict(OFFLOAD_CPU)), params)
    assert jeng._offload is not None and teng._offload is not None
    assert teng.opt_state is None and teng.master.device.type == "cpu"
    for step, batch in enumerate(_batches()):
        np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                                   float(jeng.train_batch(batch=batch)),
                                   rtol=1e-4, err_msg=f"loss {step}")
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        assert teng.get_global_grad_norm() > 0.5     # clipping acts
    assert teng.global_steps == jeng.global_steps == 3
    assert teng.applied_steps() == jeng._offload.step_count == 3
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray, jeng.module_state_dict())
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=1e-4, atol=2e-5, err_msg=key)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=2e-5, err_msg=key)


def test_engine_offload_matches_device_path_and_nvme_matches_cpu(tmp_path):
    """The port's offload engine tracks its device path (losses rtol 1e-4,
    the JAX test's limit); nvme is bit for bit cpu; the compute weights are
    the master's cast; ``eval_batch`` sees them."""
    nvme = {"stage": 3, "sub_group_size": 20_000, "offload_optimizer": {
        "device": "nvme", "nvme_path": str(tmp_path), "buffer_count": 2}}
    dev = _port(_config(4, {"stage": 2}))
    cpu = _port(_config(4, dict(OFFLOAD_CPU)))
    nv = _port(_config(4, nvme))
    assert nv._offload.swapper is not None
    for batch in _batches(micro=4):
        ld = float(dev.train_batch(batch=batch))
        lc = float(cpu.train_batch(batch=batch))
        assert float(nv.train_batch(batch=batch)) == lc
        np.testing.assert_allclose(lc, ld, rtol=1e-4)
    assert torch.equal(cpu.master, nv.master)
    sd = nv._offload.state_dict()
    for i, m in enumerate(cpu._offload.moments):
        assert torch.equal(sd[f"moment{i}"], m)
    assert resilience.validate_tag(nv._offload.swapper.swap_dir)[0] == \
        resilience.COMMITTED
    assert torch.equal(cpu._compute, cpu.master)          # fp32 compute
    ids = {"input_ids": _batches(1, gas=1, micro=4)[0]["input_ids"][0]}
    assert float(cpu.eval_batch(ids)) == float(nv.eval_batch(ids))


def test_engine_offload_three_call_api():
    """forward / backward / step under offload leave train_batch's state
    (gas 2: dividing each micro-batch by 2 is exact)."""
    fused = _port(_config(4, dict(OFFLOAD_CPU)))
    three = _port(_config(4, dict(OFFLOAD_CPU)))
    for batch in _batches(2, micro=4):
        fused.train_batch(batch=batch)
        for i in range(2):
            three.backward(three.forward({"input_ids":
                                          batch["input_ids"][i]}))
            three.step()
            assert three.was_step_applied() == (i == 1)
    assert three.global_steps == fused.global_steps == 2
    assert torch.equal(three.master, fused.master)
    assert torch.equal(three._offload.moments[1], fused._offload.moments[1])


def test_engine_offload_checkpoint_round_trip(tmp_path):
    """A tag of an offload engine holds the sidecar, listed in its
    manifest; a fresh engine loads it and the next 2 steps are bit for
    bit; ``load_optimizer_states=False`` restores the master alone (the
    moments and count as they were); ``zero_to_fp32`` reads the sidecar's
    master."""
    batches = _batches(4, micro=4)
    a = _port(_config(4, dict(OFFLOAD_CPU)))
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path), tag="ck")
    status, manifest = resilience.validate_tag(str(tmp_path / "ck"))
    assert status == resilience.COMMITTED
    assert "zero_offload_rank0.npz" in {f["path"] for f in manifest["files"]}
    b = _port(_config(4, dict(OFFLOAD_CPU)))
    b.load_checkpoint(str(tmp_path), tag="ck")
    assert b.global_steps == 2 and b._offload.step_count == 2
    for e in (a, b):
        for batch in batches[2:]:
            e.train_batch(batch=batch)
    assert torch.equal(a.master, b.master)
    assert torch.equal(a._compute, b._compute)
    for ma, mb in zip(a._offload.moments, b._offload.moments):
        assert torch.equal(ma, mb)
    c = _port(_config(4, dict(OFFLOAD_CPU)))
    c.load_checkpoint(str(tmp_path), tag="ck", load_optimizer_states=False)
    with np.load(str(tmp_path / "ck" / "zero_offload_rank0.npz")) as z:
        saved = torch.from_numpy(z["master"])
    assert torch.equal(c.master, saved) and torch.equal(c._compute, saved)
    assert c._offload.step_count == 0
    assert not c._offload.moments[0].any()
    # zero_to_fp32 of the tag: the sidecar's master, in the JAX layout
    tree = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path), "ck")
    want = to_numpy_params(c.module_state_dict())
    np.testing.assert_array_equal(tree["layers"]["wq"],
                                  want["layers"]["wq"])
    # and it is the sidecar that is read: one changed there shows
    path = str(tmp_path / "ck" / "zero_offload_rank0.npz")
    with np.load(path) as z:
        sd = {k: z[k] for k in z.files}
    sd["master"] = sd["master"] + np.float32(1.0)
    np.savez(path, **sd)
    moved = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path), "ck")
    np.testing.assert_array_equal(moved["layers"]["wq"],
                                  want["layers"]["wq"] + np.float32(1.0))


def test_engine_offload_fp16_skip_uses_the_global_step_lr():
    """fp16 from a loss scale that overflows: a skipped step leaves the
    master and the host count as they were; an applied step's lr is the
    schedule at ``global_steps`` (skipped steps counted: the JAX offload
    path's rule, where the device path uses the applied count)."""
    sched = {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                            "warmup_max_lr": 1e-3,
                                            "warmup_num_steps": 10}}
    eng = _port(_config(4, dict(OFFLOAD_CPU), clip=0.0,
                        fp16={"enabled": True, "initial_scale_power": 20},
                        scheduler=sched))
    want_lr = jax_build_schedule(sched["type"], sched["params"])
    lrs = []
    step = eng._offload.step_streamed

    def record(g, lr=None, **kw):
        lrs.append((eng.global_steps, lr))
        return step(g, lr=lr, **kw)
    eng._offload.step_streamed = record
    skipped, prev = 0, eng.master.clone()
    for batch in _batches(8, micro=4):
        eng.train_batch(batch=batch)
        if eng.last_step_overflowed():
            skipped += 1
            assert torch.equal(eng.master, prev)
        prev = eng.master.clone()
    assert 0 < skipped < 8 and int(eng.skipped_steps) == skipped
    assert eng._offload.step_count == len(lrs) == 8 - skipped
    assert eng.applied_steps() == 8 - skipped
    for gs, lr in lrs:       # the JAX schedule at the global step
        assert lr == pytest.approx(float(want_lr(gs)), rel=1e-6)
    assert lrs[0][0] == skipped and lrs[0][1] > 0  # the skips moved it


def test_engine_offload_configuration_rules():
    """Adagrad trains through offload (one moment); an optimizer offload
    does not take raises the JAX engine's ``ValueError``; the legacy
    ``cpu_offload`` key means device cpu; parameter offload (beside
    optimizer offload, whose host optimizer it takes over) and the
    ``memory`` block, which raised naming ROADMAP A12 until A12b, build."""
    ada = _port(_config(4, dict(OFFLOAD_CPU), optimizer={
        "type": "Adagrad", "params": {"lr": 1e-2}}))
    before = ada.master.clone()
    ada.train_batch(batch=_batches(1, micro=4)[0])
    assert ada._offload.n_moments == 1 and len(ada._offload.moments) == 1
    assert not torch.equal(ada.master, before)
    lamb = _config(4, dict(OFFLOAD_CPU), optimizer={"type": "Lamb",
                                                    "params": {}})
    with pytest.raises(ValueError, match="offload_optimizer supports") as e:
        _port(lamb)
    with pytest.raises(ValueError) as je:
        deepspeed_tpu.initialize(model=JaxLM(JaxConfig.tiny(**GPT)),
                                 model_parameters=_params(),
                                 config=_config(1, dict(OFFLOAD_CPU),
                                                optimizer={"type": "Lamb",
                                                           "params": {}}))
    assert str(e.value) == str(je.value)
    legacy = _port(_config(4, {"stage": 2, "cpu_offload": True}))
    assert legacy._offload is not None and legacy._offload.swapper is None
    cpuadam = _port(_config(4, dict(OFFLOAD_CPU), optimizer={
        "type": "CPUAdam", "params": {"lr": 1e-3}}))
    assert cpuadam._offload.adamw_mode
    stream = _port({"train_micro_batch_size_per_gpu": 4, "zero_optimization":
                    dict(OFFLOAD_CPU, offload_param={"device": "cpu"})})
    assert stream._offload is None and stream._param_stream is not None
    assert stream.optimizer is stream._param_stream.store
    mem = _port({"train_micro_batch_size_per_gpu": 4,
                 "memory": {"placement_policy": "nvme", "nvme_dir": "d"}})
    assert mem._offload is None and mem._param_stream is None


def test_ds_bench_train_offload_on_cpu(monkeypatch, capsys, tmp_path):
    """``ds_bench train --offload cpu`` (and nvme, under the temp dir)
    trains on a tiny model and prints the JAX CLI's keys."""
    from deepspeed_tpu_torch.benchmarks import training
    real = training.model_config
    monkeypatch.setattr(training, "model_config", lambda model, seq, **kw:
                        real(dict(hidden_size=64, n_heads=4, n_layers=1),
                             seq, **dict(kw, vocab_size=256)))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    for device in ("cpu", "nvme"):
        out = training.main(["--batch", "2", "--seq", "8", "--steps", "1",
                             "--device", "cpu", "--offload", device,
                             "--json"])
        printed = json.loads(capsys.readouterr().out.strip())
        assert "offload" not in printed and "loss" in printed
        assert out["offload"] == device and out["offload_step"]["pieces"]
        assert np.isfinite(out["losses"]).all()
    assert glob.glob(str(tmp_path / "zero_stage_offload" / "rank0" / "*"))


# ------------------------------------------------------ cpu_checkpointing
def test_cpu_checkpointing_keeps_products_on_the_host(monkeypatch):
    """A block under ``cpu_checkpointing`` gives the gradients it gives
    without it; its forward keeps each no-batch-dim product's output as a
    host copy (two here: the linear and the matmul), none from the
    recompute."""
    gen = torch.Generator().manual_seed(0)
    w1 = torch.randn(16, 32, generator=gen, requires_grad=True)
    b1 = torch.randn(32, generator=gen, requires_grad=True)
    w2 = torch.randn(32, 16, generator=gen, requires_grad=True)
    x = torch.randn(4, 8, 16, generator=gen, requires_grad=True)

    def block(x, w1, b1, w2):
        h = torch.nn.functional.gelu(torch.nn.functional.linear(x, w1.t(),
                                                                b1))
        return (h @ w2).tanh()

    def grads(fn):
        for t in (x, w1, b1, w2):
            t.grad = None
        fn(x, w1, b1, w2).square().sum().backward()
        return [t.grad.clone() for t in (x, w1, b1, w2)]

    want = grads(block)
    kept = []
    real = ckpt._to_host
    monkeypatch.setattr(ckpt, "_to_host",
                        lambda t: kept.append(real(t)) or kept[-1])
    try:
        ckpt.configure(deepspeed_config={"activation_checkpointing": {
            "cpu_checkpointing": True}})
        got = grads(lambda *a: ckpt.checkpoint(block, *a))
    finally:
        ckpt.configure(checkpoint_in_cpu=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [tuple(t.shape) for t in kept] == [(32, 32), (32, 16)]
    assert all(t.device.type == "cpu" for t in kept)
