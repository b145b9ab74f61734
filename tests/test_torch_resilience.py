"""Port parity of the fault-tolerance layer (``runtime/resilience.py``).

* The protocol against the JAX package's own code: a port-written tag is
  ``committed`` under ``deepspeed_tpu.runtime.resilience.validate_tag``
  and ``scripts/ds_ckpt_fsck.py``; each corruption (marker removed,
  manifest edited, payload truncated, a stale ``.tmp`` dir, a legacy dir)
  gets the same status from both packages' ``validate_tag`` and ``fsck``;
  ``scan_tags`` orders alike; ``RetryPolicy.delay`` draws the same delays;
  the fault sites are the same frozen list.
* The engine, as the JAX package's ``tests/unit/test_resilience.py``
  drives it: the faulted save -> kill -> resume acceptance test (a
  bit-identical tail), retries that absorb or exhaust injected failures,
  fallback, keep-last, checksums, a legacy tag, preemption with and
  without ``ckpt_dir``, the divergence sentinel (overflow streak, interval
  batching, poisoned halt, poisoned auto-restore, no restore point).
* Serving: a ``serving.fault_injection`` spec fires at the same
  ``serve_step`` call in the port's and the JAX serving engines.

Everything runs on the CPU with the plain versions; a tiny Llama-style
``CausalTransformerLM`` (2 layers, d 64), fp32 unless stated.
"""

import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import ServingEngine as JaxServing
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.runtime import resilience as jres
from deepspeed_tpu_torch.checkpoint import fsck as port_fsck
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.runtime import resilience as res
from deepspeed_tpu_torch.runtime.resilience import (
    COMMITTED, LEGACY, NO_MARKER, CheckpointCorruptError, DivergenceError,
    DivergenceSentinel, FaultInjector, RetryPolicy, TrainingPreempted,
    validate_tag)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(hidden_size=64, n_heads=4, n_kv_heads=2)
CFG = TransformerConfig.tiny(**KW)


def _engine(**blocks):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **blocks}
    return deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(CFG, device="cpu").init(0), config=cfg,
        device="cpu")[0]


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2, 4, 16))}
            for _ in range(n)]


def _load_jax_fsck():
    path = os.path.join(REPO, "scripts", "ds_ckpt_fsck.py")
    spec = importlib.util.spec_from_file_location("ds_ckpt_fsck", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A port checkpoint root: global_step1 and global_step2 committed."""
    root = tmp_path_factory.mktemp("port_ckpt")
    eng = _engine()
    for b in _batches(2):
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(root))
    return root


# ----------------------------------------------------------------------
# the protocol against the JAX package's own code
# ----------------------------------------------------------------------
def test_port_tag_is_committed_under_the_jax_validators(saved, capsys):
    for tag in ("global_step1", "global_step2"):
        status, manifest = jres.validate_tag(str(saved / tag))
        assert status == COMMITTED, tag
        assert manifest == validate_tag(str(saved / tag))[1]
    jax_fsck = _load_jax_fsck()
    assert jax_fsck.main([str(saved)]) == 0
    assert jax_fsck.fsck(str(saved), deep=True) == port_fsck.fsck(
        str(saved), deep=True)
    assert "OK" in capsys.readouterr().out


def _corrupt(root, kind):
    tag = root / "global_step2"
    if kind == "marker_removed":
        os.remove(tag / ".ds_commit")
    elif kind == "manifest_edited":
        m = json.loads((tag / "ds_manifest.json").read_text())
        m["global_step"] = 999
        (tag / "ds_manifest.json").write_text(json.dumps(m))
    elif kind == "manifest_unparseable":
        (tag / "ds_manifest.json").write_text("{not json")
    elif kind == "payload_truncated":
        p = tag / "master.npy"
        p.write_bytes(p.read_bytes()[:100])
    elif kind == "payload_removed":
        os.remove(tag / "v.npy")
    elif kind == "stale_tmp":
        shutil.copytree(tag, root / ".global_step3.tmp")
        return root / ".global_step3.tmp"
    elif kind == "legacy":
        (root / "legacy").mkdir()
        (root / "legacy" / "state.bin").write_bytes(b"old world")
        return root / "legacy"
    return tag


@pytest.mark.parametrize("kind", [
    "marker_removed", "manifest_edited", "manifest_unparseable",
    "payload_truncated", "payload_removed", "stale_tmp", "legacy"])
def test_corruption_gets_the_jax_status(saved, tmp_path, kind):
    root = tmp_path / "root"
    shutil.copytree(saved, root)
    path = str(_corrupt(root, kind))
    assert res.validate_tag(path) == jres.validate_tag(path)
    assert res.scan_tags(str(root)) == jres.scan_tags(str(root))
    want = {"marker_removed": NO_MARKER, "manifest_edited": "bad_manifest",
            "manifest_unparseable": "bad_manifest",
            "payload_truncated": "partial", "payload_removed": "partial",
            "stale_tmp": COMMITTED, "legacy": LEGACY}[kind]
    assert res.validate_tag(path)[0] == want
    jax_fsck = _load_jax_fsck()
    assert port_fsck.fsck(str(root)) == jax_fsck.fsck(str(root))
    assert port_fsck.main([str(root)]) == jax_fsck.main([str(root)])


def test_scan_tags_orders_like_jax_and_fsck_exit_codes(tmp_path):
    eng = _engine()
    for i, b in enumerate(_batches(3)):
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(tmp_path), tag=f"t{2 - i}")
    os.makedirs(tmp_path / ".crashed.tmp")
    got = res.scan_tags(str(tmp_path))
    assert [t for t, _, _ in got] == ["t0", "t1", "t2"]   # by global_step
    assert got == jres.scan_tags(str(tmp_path))
    report = port_fsck.fsck(str(tmp_path))
    assert report["stale_tmp_dirs"] == [".crashed.tmp"] and report["ok"]
    res.atomic_write_text(str(tmp_path / "latest"), "nope")
    assert port_fsck.main([str(tmp_path)]) == 1
    assert port_fsck.main([str(tmp_path / "missing")]) == 2


def test_retry_policy_delays_equal_jax():
    kw = dict(max_retries=6, backoff_secs=0.5, backoff_max_secs=3.0,
              jitter=0.25)
    port, ref = RetryPolicy(**kw), jres.RetryPolicy(**kw)
    assert [port.delay(a) for a in range(1, 7)] == \
        [ref.delay(a) for a in range(1, 7)]


def test_fault_sites_and_injector_match_jax():
    assert res.FAULT_SITES == jres.FAULT_SITES
    spec = {"ckpt_save": {"fail_times": 2}, "fs": {"fail_at": [1, 3]},
            "poison_grads_at": [4]}
    port, ref = FaultInjector(spec), jres.FaultInjector(spec)
    for site in ("ckpt_save", "fs", "serve_step"):
        for _ in range(5):
            outcome = []
            for inj in (port, ref):
                try:
                    inj.check(site)
                    outcome.append(None)
                except OSError as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1]
        assert port.calls(site) == ref.calls(site) == 5
    assert [port.poison_grads(s) for s in (3, 4, 4)] == [False, True, False]
    assert FaultInjector.from_config({}) is None


def test_poison_tree_nan_fills_float_leaves_only():
    tree = {"ids": torch.arange(4), "x": torch.ones(3),
            "y": [np.ones(2, np.float32), np.arange(2)]}
    out, n = res.poison_tree(tree)
    assert n == 2
    assert torch.isnan(out["x"]).all() and np.isnan(out["y"][0]).all()
    assert torch.equal(out["ids"], torch.arange(4))


def test_manifest_keystr_and_checksums_match_jax_on_numpy_leaves():
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "opt": {"count": np.int32(3)}}
    port = res.build_manifest(state, "t", 1, checksum=True)
    ref = jres.build_manifest(state, "t", 1, checksum=True)
    assert port["leaves"] == ref["leaves"]
    assert res.verify_restored(state, port)
    state["w"] = state["w"] + 1
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        res.verify_restored(state, port)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def test_acceptance_faulted_save_kill_resume_bitwise(tmp_path):
    """The JAX acceptance test on the port: two injected write failures
    absorbed by the retries, the newest tag torn, and a fresh engine
    resumes from the newest valid tag on a bit-identical trajectory."""
    ckpt = tmp_path / "ckpt"
    batches = _batches(6)
    ref = _engine()
    for b in batches[:2]:
        ref.train_batch(batch=b)
    ref_tail = [float(ref.train_batch(batch=b)) for b in batches[2:]]

    eng = _engine(resilience={"retry_backoff_secs": 0.0,
                              "retry_jitter": 0.0, "fault_injection": {
                                  "ckpt_save": {"fail_times": 2}}})
    for b in batches[:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(ckpt))               # the third try wins
    assert eng._injector.calls("ckpt_save") == 3
    for b in batches[2:4]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(ckpt))
    os.remove(ckpt / "global_step4" / ".ds_commit")

    resumed = _engine()
    path, _ = resumed.load_checkpoint(str(ckpt))
    assert path is not None and resumed.global_steps == 2
    got_tail = [float(resumed.train_batch(batch=b)) for b in batches[2:]]
    assert got_tail == ref_tail
    assert torch.equal(resumed.master, ref.master)
    assert torch.equal(resumed.opt_state.v, ref.opt_state.v)


def test_save_fails_after_retry_budget_and_cleans_up(tmp_path):
    eng = _engine(resilience={"retry_backoff_secs": 0.0, "max_retries": 2,
                              "fault_injection": {
                                  "ckpt_save": {"fail_times": 5}}})
    eng.train_batch(batch=_batches(1)[0])
    with pytest.raises(OSError, match="injected"):
        eng.save_checkpoint(str(tmp_path))
    assert eng._injector.calls("ckpt_save") == 3
    assert list(tmp_path.iterdir()) == []       # no tmp dir, no tag


def test_retry_io_retries_then_succeeds_and_exhausts():
    slept, cleaned = [], []
    policy = RetryPolicy(max_retries=2, backoff_secs=0.1, jitter=0.0,
                         sleep_fn=slept.append)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("flaky")
        return "ok"
    assert res.retry_io(flaky, policy, cleanup=lambda: cleaned.append(1)) \
        == "ok"
    assert slept == [0.1, 0.2] and len(cleaned) == 2
    with pytest.raises(OSError):
        res.retry_io(lambda: (_ for _ in ()).throw(OSError("x")), policy,
                     cleanup=lambda: cleaned.append(1))
    assert len(cleaned) == 5                     # after every failure


def test_latest_write_and_load_retry_their_sites(tmp_path):
    eng = _engine(resilience={"retry_backoff_secs": 0.0, "fault_injection": {
        "fs": {"fail_times": 1}, "ckpt_load": {"fail_times": 2}}})
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path))
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert eng._injector.calls("fs") == 2
    path, client = eng.load_checkpoint(str(tmp_path))
    assert path is not None and client["global_steps"] == 1
    assert eng._injector.calls("ckpt_load") == 3


def test_explicit_corrupt_tag_raises_and_latest_falls_back(saved, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(saved, root)
    os.remove(root / "global_step2" / ".ds_commit")
    eng = _engine()
    with pytest.raises(CheckpointCorruptError, match="no_marker"):
        eng.load_checkpoint(str(root), tag="global_step2")
    path, _ = eng.load_checkpoint(str(root))
    assert path is not None and eng.global_steps == 1
    # a payload that keeps its size but not its bytes is caught only by
    # checksums: without them it loads, so the fallback is what saves a
    # torn newest tag
    assert eng.load_checkpoint(str(tmp_path / "none")) == (None, {})


def test_keep_last_retention(tmp_path):
    eng = _engine(resilience={"keep_last": 2})
    for b in _batches(4):
        eng.train_batch(batch=b)
        eng.save_checkpoint(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == \
        ["global_step3", "global_step4"]


def test_checksummed_roundtrip_and_corruption_caught(tmp_path):
    eng = _engine(resilience={"checksum": True})
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path))
    _, manifest = validate_tag(str(tmp_path / "global_step1"))
    assert manifest["checksum"] and all("crc32" in r
                                        for r in manifest["leaves"])
    fresh = _engine(resilience={"checksum": True})
    assert fresh.load_checkpoint(str(tmp_path))[0] is not None
    assert torch.equal(fresh.master, eng.master)
    # flip bytes inside master.npy at the same size: the crc catches it
    p = tmp_path / "global_step1" / "master.npy"
    raw = bytearray(p.read_bytes())
    raw[-4:] = b"\x00\x00\xc0\x7f"
    p.write_bytes(bytes(raw))
    before = fresh.master.clone()
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        fresh.load_checkpoint(str(tmp_path), tag="global_step1")
    assert torch.equal(fresh.master, before)    # nothing was written


def test_legacy_checkpoint_still_loads(tmp_path):
    eng = _engine(resilience={"enabled": False})
    eng.train_batch(batch=_batches(1)[0])
    eng.save_checkpoint(str(tmp_path))
    assert validate_tag(str(tmp_path / "global_step1"))[0] == LEGACY
    fresh = _engine()
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path is not None and fresh.global_steps == 1
    assert torch.equal(fresh.master, eng.master)


def test_async_engine_roundtrip_and_engine_selection(tmp_path):
    from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
    try:
        eng = _engine(checkpoint={"engine": "async"})
        assert isinstance(ce.get_checkpoint_engine(),
                          ce.AsyncCheckpointEngine)
        eng.train_batch(batch=_batches(1)[0])
        eng.save_checkpoint(str(tmp_path))
        assert validate_tag(str(tmp_path / "global_step1"))[0] == COMMITTED
        timing = eng.last_checkpoint_timing
        assert timing["staged_s"] <= timing["written_s"] <= \
            timing["committed_s"] <= timing["returned_s"]
        e2 = ce.get_checkpoint_engine({"checkpoint": {"engine": "sync"}})
        assert type(e2) is ce.SyncCheckpointEngine
        assert ce.get_checkpoint_engine() is e2
        assert ce.get_checkpoint_engine({"checkpoint": {"engine": "orbax"}}) \
            is e2
        fresh = _engine()
        assert fresh.load_checkpoint(str(tmp_path))[0] is not None
        assert torch.equal(fresh.opt_state.m, eng.opt_state.m)
    finally:
        ce.get_checkpoint_engine({"checkpoint": {"engine": "sync"}})


def test_preemption_emergency_checkpoint(tmp_path):
    eng = _engine(resilience={"preemption_handler": True,
                              "ckpt_dir": str(tmp_path)})
    b = _batches(2)
    eng.train_batch(batch=b[0])
    eng._preempt.request()                # a deterministic signal
    with pytest.raises(TrainingPreempted, match="emergency_step1"):
        eng.train_batch(batch=b[1])
    status, manifest = validate_tag(str(tmp_path / "emergency_step1"))
    assert status == COMMITTED and manifest["global_step"] == 1
    fresh = _engine()
    fresh.load_checkpoint(str(tmp_path), tag="emergency_step1")
    assert fresh.global_steps == 1


def test_preemption_without_ckpt_dir_still_unwinds():
    eng = _engine(resilience={"preemption_handler": True})
    eng.train_batch(batch=_batches(1)[0])
    eng._preempt.request()
    with pytest.raises(TrainingPreempted):
        eng.train_batch(batch=_batches(1)[0])
    assert eng.global_steps == 1


def test_sentinel_overflow_streak_unit():
    s = DivergenceSentinel(max_consecutive_skips=3, interval=1)
    for step in range(1, 3):
        s.push(step, loss=torch.tensor(1.0), overflow=torch.tensor(True))
        assert s.poll() is None
    s.push(3, loss=np.float32(1.0), overflow=np.asarray(True))
    assert s.poll() == "halt"
    assert s.reason == "overflow_streak" and s.trip_step == 3
    assert s.poll() is None                      # delivered once
    s.reset()
    s.push(4, loss=np.float32(1.0), overflow=np.asarray(False))
    assert s.poll() is None


def test_sentinel_interval_batches_readback():
    s = DivergenceSentinel(max_consecutive_skips=0, interval=4)
    s.push(1, loss=torch.tensor(float("nan")))
    assert s.poll() is None                      # below the interval
    for step in (2, 3, 4):
        s.push(step, loss=torch.tensor(1.0))
    assert s.poll() == "halt" and s.trip_step == 1


def test_fp16_overflow_streak_trips_the_engines_sentinel():
    eng = _engine(fp16={"enabled": True, "initial_scale_power": 40,
                        "hysteresis": 1},
                  resilience={"divergence_sentinel": True,
                              "max_consecutive_skips": 2})
    eng.train_batch(batch=_batches(1)[0])         # overflows: skip 1
    with pytest.raises(DivergenceError, match="overflow_streak"):
        eng.train_batch(batch=_batches(1, seed=1)[0])


def test_poisoned_step_trips_sentinel_halt():
    eng = _engine(resilience={"divergence_sentinel": True,
                              "fault_injection": {"poison_grads_at": [0]}})
    with pytest.raises(DivergenceError, match="nonfinite_loss"):
        eng.train_batch(batch=_batches(1)[0])


def test_poisoned_step_auto_restores(tmp_path):
    eng = _engine(resilience={"divergence_sentinel": True,
                              "on_divergence": "restore",
                              "fault_injection": {"poison_grads_at": [2]}})
    b = _batches(3)
    eng.train_batch(batch=b[0])
    eng.train_batch(batch=b[1])
    eng.save_checkpoint(str(tmp_path))
    good = eng.master.clone()
    assert not np.isfinite(float(eng.train_batch(batch=b[2])))
    assert eng.global_steps == 2 and torch.equal(eng.master, good)
    assert np.isfinite(float(eng.train_batch(batch=b[2])))
    assert eng.global_steps == 3


def test_divergence_halts_when_no_restore_point():
    eng = _engine(resilience={"divergence_sentinel": True,
                              "on_divergence": "restore",
                              "fault_injection": {"poison_grads_at": [0]}})
    with pytest.raises(DivergenceError, match="no checkpoint to restore"):
        eng.train_batch(batch=_batches(1)[0])


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def test_serving_fault_injection_fires_at_the_jax_call_index():
    jmodel = JaxLM(JaxConfig.tiny(**KW))
    params = jmodel.init(jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = CausalTransformerLM(CFG, device="cpu")
    tmodel.load_state_dict(from_jax_params(np_params, CFG))
    serving = {"attention_backend": "jnp",
               "fault_injection": {"serve_step": {"fail_at": [1, 3]}}}
    jeng = JaxServing(jmodel, params, max_batch=2, page_size=8, max_seq=64,
                      dtype=jnp.float32, serving=serving)
    teng = ServingEngine(tmodel, max_batch=2, page_size=8, max_seq=64,
                         dtype=torch.float32,
                         serving=dict(serving, attention_backend="auto"))
    assert isinstance(teng.injector, FaultInjector)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)).tolist()
               for n in (5, 9, 4)]
    runs = []
    for eng in (jeng, teng):
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=5)
        faulted, steps = [], 0
        while eng.queue or eng.n_active:
            before = eng.stats["step_faults"]
            eng.step()
            if eng.stats["step_faults"] > before:
                faulted.append(steps)
            steps += 1
        runs.append((faulted, eng.injector.calls("serve_step"),
                     dict(eng.finished)))
    assert runs[0][0] == runs[1][0] == [1, 3]
    assert runs[0][1:] == runs[1][1:]
