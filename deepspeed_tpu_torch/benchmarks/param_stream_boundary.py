"""The parameter stream's boundary and the offloaded step's writeback.

Counterpart of ``deepspeed_tpu/benchmarks/param_stream_boundary.py``, the
same two measurements on the card (``--cpu``: off it):

* ``boundary`` -- ``ParamStreamRunner._apply_boundary`` with the host
  update on the main thread and the uploads of the updated units (the
  resident group, the pinned layers, the first window) on the worker,
  against the serial walk; each timed until the card holds the uploads.
* ``writeback`` -- ``HostOffloadOptimizer.step_streamed`` (D2H, host Adam
  and H2D a piece at a time, overlapped) against the serial D2H ->
  ``step()`` -> whole-buffer cast and upload.

Run::

    python -m deepspeed_tpu_torch.benchmarks.param_stream_boundary \\
        [--hidden 2048] [--layers 16] [--numel 200000000] [--reps 3]

Prints one JSON line a section and a summary line, the JAX bench's keys.
Each section's time is the best of ``--reps`` after one warm-up.
"""

import argparse
import json
import time

import torch


def _runner(hidden, layers, vocab, buffer_count, device):
    """The stream of a Llama-style model (the JAX bench's: fp32, heads of
    128 or 4 heads) under ``offload_param`` cpu, its weights drawn on the
    host."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    cfg = TransformerConfig(
        vocab_size=vocab, hidden_size=hidden, n_layers=layers,
        n_heads=max(4, hidden // 128), max_seq_len=128)
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, device=device, config={
            "train_micro_batch_size_per_gpu": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            "zero_optimization": {
                "stage": 0,
                "offload_param": {"device": "cpu",
                                  "buffer_count": buffer_count},
                "offload_optimizer": {"device": "cpu"}}})
    return engine._param_stream


def _grads(store, seed=0):
    """Random accumulated gradients for every unit, drawn once: the
    boundary zeroes them, each rep copies them back."""
    g = torch.Generator().manual_seed(seed)
    units = [store.gacc(l) for l in range(-1, store.n_layers)]
    return [torch.randn(u.shape, generator=g).to(u.dtype) for u in units]


def _fill(store, grads):
    for l, g in zip(range(-1, store.n_layers), grads):
        store.gacc(l).copy_(g)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_boundary(runner, grads, pipelined, reps):
    ts = []
    for i in range(reps + 1):                 # the first is the warm-up
        _fill(runner.store, grads)
        _sync(runner.device)
        t0 = time.perf_counter()
        runner._apply_boundary(1e-4, None, 1, pipelined=pipelined)
        for ws in [runner._res, *runner._pinned.values(),
                   *runner._dev.values()]:
            ws.wait()
        _sync(runner.device)
        if i:
            ts.append(time.perf_counter() - t0)
    return min(ts)


def _time_writeback(numel, sub_groups, reps, device):
    from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
    from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
    zc = DeepSpeedZeroConfig({"stage": 3,
                              "sub_group_size": numel // sub_groups,
                              "offload_optimizer": {"device": "cpu"}})

    def build():
        return HostOffloadOptimizer(torch.zeros(numel), zc, opt_name="adamw",
                                    opt_params={"lr": 1e-4})

    g_dev = torch.randn(numel, generator=torch.Generator().manual_seed(0)
                        ).to(device)
    out = torch.empty(numel, dtype=torch.bfloat16, device=device)
    serial, streamed = [], []
    opt = build()
    for i in range(reps + 1):
        # serial: the whole D2H, the whole step, one cast and upload
        _sync(device)
        t0 = time.perf_counter()
        opt.step(g_dev.cpu())
        out.copy_(opt.master.to(torch.bfloat16))
        _sync(device)
        if i:
            serial.append(time.perf_counter() - t0)
    opt = build()
    for i in range(reps + 1):
        _sync(device)
        t0 = time.perf_counter()
        opt.step_streamed(g_dev, out=out)
        _sync(device)
        if i:
            streamed.append(time.perf_counter() - t0)
    return min(serial), min(streamed)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="param_stream_boundary",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--buffer-count", type=int, default=5)
    ap.add_argument("--numel", type=int, default=200_000_000)
    ap.add_argument("--sub-groups", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run off the card")
    args = ap.parse_args(argv)
    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --cpu to run off the card)")
    platform = "gpu" if device.type == "cuda" else "cpu"

    runner = _runner(args.hidden, args.layers, args.vocab, args.buffer_count,
                     device)
    grads = _grads(runner.store)
    serial_b = _time_boundary(runner, grads, pipelined=False, reps=args.reps)
    piped_b = _time_boundary(runner, grads, pipelined=True, reps=args.reps)
    boundary = {
        "section": "boundary", "n_params": runner.store.num_params(),
        "serial_sec": round(serial_b, 4), "pipelined_sec": round(piped_b, 4),
        "speedup_x": round(serial_b / piped_b, 3),
        "hidden": args.hidden, "layers": args.layers,
        "buffer_count": args.buffer_count, "device": platform,
    }
    print(json.dumps(boundary))
    del runner, grads

    ser_w, str_w = _time_writeback(args.numel, args.sub_groups, args.reps,
                                   device)
    writeback = {
        "section": "writeback", "numel": args.numel,
        "serial_sec": round(ser_w, 4), "streamed_sec": round(str_w, 4),
        "speedup_x": round(ser_w / str_w, 3),
        "sub_groups": args.sub_groups, "device": platform,
    }
    print(json.dumps(writeback))
    print(json.dumps({"section": "summary",
                      "boundary_speedup_x": boundary["speedup_x"],
                      "writeback_speedup_x": writeback["speedup_x"]}))
    return boundary, writeback


if __name__ == "__main__":
    main()
