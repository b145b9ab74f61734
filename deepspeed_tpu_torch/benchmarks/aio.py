"""Async file I/O throughput (``ds_bench aio``).

Counterpart of the JAX package's ``benchmarks/aio.py`` (the reference's
``ds_aio_bench``): GB/s of the io_uring engine (``ops/aio.py``) at several
queue depths and block sizes, then of the blocking thread-pool path, on
one page-locked buffer and one file (warm: the file was just written, so
reads may come from the page cache).  Usage::

    python -m deepspeed_tpu_torch.benchmarks aio [--size-mb 256] [--file PATH]

Prints one JSON line per configuration; ``tier`` says which path ran
(``threadpool`` where ``io_uring_setup`` is refused).
"""

import argparse
import json
import os
import tempfile
import time

import torch

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle


def _bench(handle, buf, path, reps, write):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        if write:
            handle.async_pwrite(buf, path)
        else:
            handle.async_pread(buf, path)
        handle.wait()
        ts.append(time.perf_counter() - t0)
    return buf.numel() / min(ts) / 1e9


def _row(handle, buf, path, reps, **head):
    return dict(head, read_gbps=round(_bench(handle, buf, path, reps,
                                             False), 3),
                write_gbps=round(_bench(handle, buf, path, reps, True), 3))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ds_bench aio")
    ap.add_argument("--size-mb", type=int, default=256)
    ap.add_argument("--file", default=None,
                    help="target file (put it on NVMe to bench the device; "
                         "default: a file in a new temp dir)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    nbytes = args.size_mb << 20
    tmpdir = None
    if args.file is None:
        tmpdir = tempfile.mkdtemp(prefix="ds_aio_bench_")
        path = os.path.join(tmpdir, "blob.bin")
    else:
        path = args.file
    seed_handle = AsyncIOHandle()
    buf = seed_handle.new_cpu_locked_tensor(nbytes, torch.uint8)
    buf.fill_(1)
    seed_handle.sync_pwrite(buf, path)

    results = []
    try:
        for qd, bs in ((1, 1 << 20), (8, 1 << 20), (16, 1 << 20),
                       (16, 4 << 20)):
            h = AsyncIOHandle(block_size=bs, queue_depth=qd)
            tier = "io_uring" if h.uses_io_uring() else "threadpool"
            results.append(_row(h, buf, path, args.reps, tier=tier,
                                queue_depth=qd, block_kb=bs >> 10))
            print(json.dumps(results[-1]))
        for threads in (4, 8):
            h = AsyncIOHandle(thread_count=threads)
            if h.uses_io_uring():     # the blocking path on a thread pool
                h._lib.ds_aio_destroy(h._engine)
                h._engine = None
            results.append(_row(h, buf, path, args.reps, tier="threadpool",
                                threads=threads,
                                block_kb=h.get_block_size() >> 10))
            print(json.dumps(results[-1]))
    finally:
        seed_handle.free_cpu_locked_tensor(buf)
        if tmpdir:
            os.unlink(path)
            os.rmdir(tmpdir)
    return results


if __name__ == "__main__":
    main()
