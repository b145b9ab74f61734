"""Async file I/O for the NVMe swap (ZeRO-Infinity's aio engine).

Counterpart of the JAX package's ``ops/aio.py``: :class:`AsyncIOHandle`
has the reference handle's surface (``sync_pread`` / ``sync_pwrite``,
``async_pread`` / ``async_pwrite`` and ``wait``, ``new_cpu_locked_tensor``
/ ``free_cpu_locked_tensor``) over the raw-syscall io_uring engine of
``ops/csrc/host/aio.cpp``, built by ``ops/host_builder.py`` at first use:
an async transfer is cut into ``block_size`` submissions with
``queue_depth`` in flight, O_DIRECT where the buffer, length and offset
are 4 KiB aligned.  Where ``io_uring_setup`` is refused (a seccomp filter,
an old kernel) the async calls run the library's blocking ``pread`` /
``pwrite`` on a pool of ``thread_count`` threads, as the JAX package's
do; ``uses_io_uring()`` says which.  A failed build raises: there is no
pure-Python tier.

Buffers are CPU tensors (any dtype, contiguous).  A buffer that crosses
PCIe comes from ``new_cpu_locked_tensor``: on a machine with a card,
``torch`` pinned memory (``cudaHostAlloc``, page aligned), which must not
be ``mlock``-ed again; without one, the library's 4 KiB-aligned ``mlock``
buffer.
"""

import concurrent.futures as cf
import ctypes
from typing import Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch.ops import host_builder

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    "ds_pread": ([ctypes.c_char_p, _P, _L, _L, _I], _L),
    "ds_pwrite": ([ctypes.c_char_p, _P, _L, _L, _I], _L),
    "ds_aio_create": ([_I], _P),
    "ds_aio_submit_read": ([_P, ctypes.c_char_p, _P, _L, _L], _L),
    "ds_aio_submit_write": ([_P, ctypes.c_char_p, _P, _L, _L], _L),
    "ds_aio_drain": ([_P], _L),
    "ds_aio_inflight": ([_P], _L),
    "ds_aio_destroy": ([_P], None),
    "ds_alloc_pinned": ([_L], _P),
    "ds_free_pinned": ([_P, _L], None),
}


def _lib():
    return host_builder.load("aio", _SIGNATURES, ldflags=("-lpthread",))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_buffer(t):
    if not torch.is_tensor(t) or t.device.type != "cpu" or \
            not t.is_contiguous():
        raise ValueError("aio buffers must be contiguous CPU tensors")
    return t


class AsyncIOHandle:
    """The reference ``aio_handle``: one io_uring ring of ``queue_depth``
    (or, without io_uring, a pool of ``thread_count`` threads)."""

    def __init__(self, block_size=1048576, queue_depth=8, single_submit=False,
                 overlap_events=True, thread_count=4):
        self._block_size = block_size
        self._queue_depth = queue_depth
        self._thread_count = thread_count
        self._pool = None            # made on first use, without io_uring
        self._pending: List[cf.Future] = []
        self._inflight_bufs: List[torch.Tensor] = []
        self._reqs = 0               # async requests since the last wait()
        self._pinned: Dict[int, tuple] = {}   # id -> (ptr, nbytes)
        self._lib = _lib()
        self._engine = self._lib.ds_aio_create(queue_depth) or None

    def __del__(self):
        engine, self._engine = getattr(self, "_engine", None), None
        if engine is not None:
            self._lib.ds_aio_destroy(engine)

    def get_block_size(self):
        return self._block_size

    def get_queue_depth(self):
        return self._queue_depth

    def get_thread_count(self):
        return self._thread_count

    def uses_io_uring(self):
        return self._engine is not None

    # ---- the blocking core (sync calls, and async without io_uring) ----
    def _do_read(self, buffer, filename, offset=0):
        n = _nbytes(buffer)
        got = self._lib.ds_pread(filename.encode(), buffer.data_ptr(), n,
                                 offset, 0)
        if got != n:
            raise OSError(f"short read {got}/{n} from {filename}")
        return got

    def _do_write(self, buffer, filename, offset=0):
        n = _nbytes(buffer)
        put = self._lib.ds_pwrite(filename.encode(), buffer.data_ptr(), n,
                                  offset, 0)
        if put != n:
            raise OSError(f"short write {put}/{n} to {filename}")
        return put

    def sync_pread(self, buffer, filename, offset=0):
        return self._do_read(_host_buffer(buffer), filename, offset)

    def sync_pwrite(self, buffer, filename, offset=0):
        return self._do_write(_host_buffer(buffer), filename, offset)

    read = pread = sync_pread
    write = pwrite = sync_pwrite

    # ---- async calls ----------------------------------------------------
    def _submit_chunks(self, buf, filename, offset, write):
        """One transfer as ``block_size`` io_uring submissions, so one
        large tensor fills the queue."""
        submit = (self._lib.ds_aio_submit_write if write
                  else self._lib.ds_aio_submit_read)
        base, n, fname = buf.data_ptr(), _nbytes(buf), filename.encode()
        # keep the buffer alive before any chunk is in flight
        self._inflight_bufs.append(buf)
        self._reqs += 1
        pos = 0
        while pos < n:
            size = min(self._block_size, n - pos)
            rc = submit(self._engine, fname, base + pos, size, offset + pos)
            if rc < 0:
                raise OSError(-rc, f"io_uring submit failed for {filename}")
            pos += size

    def _submit(self, buffer, filename, offset, write):
        buf = _host_buffer(buffer)
        if self._engine is not None:
            self._submit_chunks(buf, filename, offset, write)
            return 0
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(max_workers=self._thread_count)
        self._pending.append(self._pool.submit(
            self._do_write if write else self._do_read, buf, filename,
            offset))
        return 0

    def async_pread(self, buffer, filename, offset=0):
        return self._submit(buffer, filename, offset, write=False)

    def async_pwrite(self, buffer, filename, offset=0):
        return self._submit(buffer, filename, offset, write=True)

    def wait(self):
        """Block until every async request is done; returns the number of
        requests (one per ``async_pread`` / ``async_pwrite`` call)."""
        n = 0
        if self._engine is not None:
            reqs, self._reqs = self._reqs, 0
            done = self._lib.ds_aio_drain(self._engine)
            self._inflight_bufs.clear()
            if done < 0:
                raise OSError(-done, "io_uring drain failed")
            n += reqs
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
            n += 1
        return n

    # ---- page-locked buffers --------------------------------------------
    def new_cpu_locked_tensor(self, num_elem, dtype=torch.float32):
        """A zeroed page-locked host tensor of ``num_elem`` elements:
        CUDA-pinned where a card is present, else the library's 4 KiB
        aligned ``mlock`` buffer."""
        num_elem = int(num_elem)
        if torch.cuda.is_available():
            return torch.zeros(num_elem, dtype=dtype, pin_memory=True)
        nbytes = num_elem * torch.empty((), dtype=dtype).element_size()
        ptr = self._lib.ds_alloc_pinned(max(nbytes, 1))
        if not ptr:
            raise MemoryError(f"ds_alloc_pinned({nbytes}) failed")
        raw = np.ctypeslib.as_array((ctypes.c_uint8 * max(nbytes, 1))
                                    .from_address(ptr))
        t = torch.from_numpy(raw[:nbytes]).view(dtype)
        self._pinned[id(t)] = (ptr, max(nbytes, 1))
        return t

    def free_cpu_locked_tensor(self, tensor):
        ptr, nbytes = self._pinned.pop(id(tensor), (0, 0))
        if ptr:
            self._lib.ds_free_pinned(ptr, nbytes)


def aio_read(buffer, filename, **kw):
    return AsyncIOHandle(**kw).sync_pread(buffer, filename)


def aio_write(buffer, filename, **kw):
    return AsyncIOHandle(**kw).sync_pwrite(buffer, filename)
