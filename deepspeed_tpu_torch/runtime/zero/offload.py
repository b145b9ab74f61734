"""ZeRO-Offload and ZeRO-Infinity's optimizer swap: the optimizer on the host.

Counterpart of the JAX package's ``runtime/zero/offload.py``
(``OptimizerStateSwapper``, ``HostOffloadOptimizer``) for one process.
The fp32 master and the optimizer's moments (Adam's two, Adagrad's one)
live in host RAM as flat pageable CPU tensors in the engine's flat layout
(one span a parameter); the card keeps the compute-dtype weights and the
gradient buffer, which is the saving: 12 bytes a parameter off the card
with Adam.  The update is the fused host C++ of ``ops/cpu_adam.py``, one
call a piece, over sub-groups of ``sub_group_size`` elements in flat
order.  With ``offload_optimizer.device == "nvme"`` the moments of each
sub-group live in swap files (``<nvme_path>/zero_stage_offload/rank0``,
under the temp dir -- ``$TMPDIR`` or ``/tmp`` -- without ``nvme_path``)
that :class:`OptimizerStateSwapper` streams through a ring of
``buffer_count`` pinned buffers: sub-group *i + 1*'s read is in flight
while *i* updates, and *i - 1*'s write-back drains behind both.

:meth:`HostOffloadOptimizer.step_streamed` is the engine's step, a
pipeline fed by the flat gradient buffer on the card.  Per piece of at
most :data:`PIPELINE_CHUNK` elements, in flat order: the gradients come
down in their own dtype (bf16 gradients cross PCIe at 2 bytes) on a copy
stream into a pinned staging buffer, two pieces ahead; the host widens
them to fp32 (fp32 ones are updated from the staging buffer itself),
times the clip coefficient; the host update runs (the GIL released); the updated master, cast to the compute dtype in a second
pinned buffer, goes up into the compute-dtype weights on another copy
stream, under the next piece's update.  The update is elementwise, so a
piece may be finer than a sub-group and the result is the same: the JAX
package stages the whole model's fp32 gradients on the host first, the
port only a few pieces, so host RAM stays at master + moments + a few
pieces.  Master and moments are pageable (pinning 100 GB can fail or
starve the host); only the staging buffers are pinned.

The rules copied from the JAX offload path: ``adamw_mode`` defaults on for
adamw, fusedadam and cpuadam; ``weight_decay`` defaults to 0; the step
count advances only on an applied step, and Adam runs at ``step_count``
(its bias correction); the clip coefficient multiplies the fp32 gradient
on the host; the moments are fp32 whatever ``moment_dtype`` says.
"""

import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.runtime.tiered_store import TieredStore
from deepspeed_tpu_torch.utils.logging import logger

SWAP_SUBDIR = "zero_stage_offload"
OFFLOAD_OPTIMIZERS = ("adam", "adamw", "fusedadam", "cpuadam", "adagrad")
# elements a pipeline piece holds at most: 64 MB of fp32 gradients on the
# host, 32 or 64 MB a pinned staging buffer
PIPELINE_CHUNK = 1 << 24
# pieces whose gradients are on their way down while the host updates one
D2H_DEPTH = 2


class OptimizerStateSwapper:
    """NVMe swap of per-sub-group optimizer moments through the tiered
    store's slots ``sg{g}_t{t}`` and a ring of ``buffer_count`` (at least
    2) pinned buffers: reads of a prefetched sub-group and write-backs are
    async on the store's reader and writer queues, waited for only when a
    buffer is needed again.  ``release()`` drains them and seals the
    directory with the manifest, so a torn swap file shows as
    ``partial`` under ``resilience.validate_tag``.  ``pipelined = False``
    makes every read and write synchronous (the measurement's baseline)."""

    def __init__(self, swap_dir: str, n_tensors: int,
                 subgroup_sizes: List[int], buffer_count: int = 4,
                 aio_config: Optional[dict] = None):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        self.n_tensors = n_tensors
        self.sizes = list(subgroup_sizes)
        self.pipelined = True
        self.store = TieredStore(name="optimizer_swap", nvme_dir=swap_dir,
                                 nvme_subdir=None, aio_config=aio_config)
        for g, size in enumerate(self.sizes):
            for t in range(n_tensors):
                self.store.register_swap(self._key(g, t), size)
        self._bufsize = max(self.sizes) if self.sizes else 0
        self.buffer_count = max(2, buffer_count)
        # a slot's buffers are made at its first use: fewer sub-groups
        # than slots leave the rest unmade
        self._buffers = [None] * self.buffer_count
        self._holds = [-1] * self.buffer_count   # sub-group a slot holds
        self._writing = set()     # slots with a write-back in flight
        self._initialized = [False] * len(self.sizes)

    @staticmethod
    def _key(group: int, tensor: int) -> str:
        return f"sg{group}_t{tensor}"

    # the store's queues under the swapper's names: a measurement may put
    # a slow stand-in here
    @property
    def _reader(self):
        return self.store._reader

    @_reader.setter
    def _reader(self, handle):
        self.store._reader = handle

    @property
    def _writer(self):
        return self.store._writer

    @_writer.setter
    def _writer(self, handle):
        self.store._writer = handle

    def _path(self, group: int, tensor: int) -> str:
        return self.store.path_for(self._key(group, tensor))

    def _slot(self, group: int):
        """(slot, its buffers) of sub-group ``group``."""
        slot = group % self.buffer_count
        if self._buffers[slot] is None:
            self._buffers[slot] = [self.store.alloc_pinned(self._bufsize)
                                   for _ in range(self.n_tensors)]
        return slot, self._buffers[slot]

    def swap_in(self, group: int, prefetch: bool = False):
        """The host buffers holding sub-group ``group``'s moments, zeros on
        first touch; ``prefetch``: the read is left in flight."""
        slot, bufs = self._slot(group)
        views = [b[:self.sizes[group]] for b in bufs]
        if self._holds[slot] == group:
            self.store.reader_wait()      # a prefetch into it has landed
            return views
        if slot in self._writing:
            self.store.writer_wait()      # its write-back has left
            self._writing.clear()
        if not self._initialized[group]:
            for v in views:
                v.zero_()
        else:
            for t, v in enumerate(views):
                self.store.read_into(self._key(group, t), v,
                                     async_op=prefetch and self.pipelined)
        self._holds[slot] = group
        return views

    def swap_out(self, group: int, sync: bool = False):
        slot, bufs = self._slot(group)
        if self._holds[slot] != group:
            raise RuntimeError(f"swap_out of sub-group {group}, which is "
                               f"not resident")
        sync = sync or not self.pipelined
        for t, buf in enumerate(bufs):
            self.store.write_from(self._key(group, t),
                                  buf[:self.sizes[group]], sync=sync)
        if not sync:
            self._writing.add(slot)
        self._initialized[group] = True

    def release(self):
        self.store.wait_all()
        self._writing.clear()
        self._holds = [-1] * self.buffer_count
        if any(self._initialized):
            self.store.commit()


class _HostTransfers:
    """The pipeline's transfers when the gradients are CPU tensors (the
    CPU tests): copies, and the same order of operations."""

    def __init__(self, grads, out, coef):
        self.grads, self.out, self.coef = grads, out, coef
        self.g32 = torch.empty(0, dtype=torch.float32)

    def fetch(self, i, lo, hi):
        if self.g32.numel() < hi - lo:
            self.g32 = torch.empty(hi - lo, dtype=torch.float32)
        g = self.g32[:hi - lo]
        g.copy_(self.grads[lo:hi])
        if self.coef is not None:
            g.mul_(self.coef)
        return g

    def upload(self, lo, hi, src):
        if self.out is not None:
            self.out[lo:hi].copy_(src)

    def finish(self):
        return {}


class _CudaTransfers:
    """The pipeline's transfers with the gradients and weights on the
    card, through the optimizer's pinned staging buffers: a ring of
    D2H_DEPTH + 1 for the gradients -- pieces i + 1 .. i + D2H_DEPTH come
    down on one copy stream while the host updates piece i, fp32 ones in
    place (the update reads the pinned buffer), bf16 ones widened into a
    host fp32 piece -- and two for the weights, whose H2D of piece i runs
    on another copy stream under the update of i + 1.  CUDA events time
    each copy."""

    def __init__(self, opt, grads, out, coef, pieces):
        self.grads, self.out, self.coef, self.pieces = grads, out, coef, \
            pieces
        size = max(hi - lo for lo, hi in pieces)
        self.down, self.up, self.g32 = opt._staging(size, grads.dtype,
                                                    out.dtype)
        cur = torch.cuda.current_stream(grads.device)
        self.d2h, self.h2d = opt._streams(grads.device)
        # the copies start after the backward and the last forward
        self.d2h.wait_stream(cur)
        self.h2d.wait_stream(cur)
        self.cur = cur
        self.down_done = [None] * len(self.down)
        self.up_done = [None] * len(self.up)
        self.timed = {"d2h": [], "h2d": []}
        self.waited = 0.0
        self.ups = 0
        for i in range(min(D2H_DEPTH, len(pieces))):
            self._issue_down(i)

    def _timed_copy(self, stream, kind, dst, src):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            dst.copy_(src, non_blocking=True)
            end.record(stream)
        self.timed[kind].append((start, end, dst.numel() *
                                 dst.element_size()))
        return end

    def _issue_down(self, i):
        lo, hi = self.pieces[i]
        j = i % len(self.down)
        self.down_done[j] = self._timed_copy(
            self.d2h, "d2h", self.down[j][:hi - lo], self.grads[lo:hi])

    def _wait(self, event):
        t0 = time.perf_counter()
        event.synchronize()
        self.waited += time.perf_counter() - t0

    def fetch(self, i, lo, hi):
        j = i % len(self.down)
        self._wait(self.down_done[j])
        # piece i - 1's buffer is free again: it takes piece i + D2H_DEPTH
        if i + D2H_DEPTH < len(self.pieces):
            self._issue_down(i + D2H_DEPTH)
        g = self.down[j][:hi - lo]
        if self.g32 is not None:
            g = self.g32[:hi - lo].copy_(g)
        if self.coef is not None:
            g.mul_(self.coef)
        return g

    def upload(self, lo, hi, src):
        j = self.ups % len(self.up)
        self.ups += 1
        if self.up_done[j] is not None:
            self._wait(self.up_done[j])
        stage = self.up[j][:hi - lo]
        stage.copy_(src)
        self.up_done[j] = self._timed_copy(self.h2d, "h2d",
                                           self.out[lo:hi], stage)

    def finish(self):
        # the next forward reads the new weights, and the gradient buffer
        # is zeroed, after every copy
        self.cur.wait_stream(self.h2d)
        self.cur.wait_stream(self.d2h)
        out = {"host_wait_s": self.waited}
        for kind, copies in self.timed.items():
            if copies:
                copies[-1][1].synchronize()
                ms = sum(s.elapsed_time(e) for s, e, _ in copies)
                nbytes = sum(n for _, _, n in copies)
                out[f"{kind}_ms"] = ms
                out[f"{kind}_bytes"] = nbytes
                out[f"{kind}_gbps"] = nbytes / ms / 1e6 if ms else 0.0
        return out


class HostOffloadOptimizer:
    """The offloaded optimizer over a flat fp32 ``master`` (a 1-D CPU
    tensor it takes over): Adam (adam, adamw, fusedadam, cpuadam) or
    Adagrad, with its moments on the host or swapped to NVMe per sub-group.
    ``step`` takes host fp32 gradients; the engine calls
    :meth:`step_streamed` with its gradient buffer on the card."""

    def __init__(self, master: torch.Tensor, zero_config,
                 opt_name: str = "adamw", opt_params: Optional[dict] = None,
                 rank: int = 0):
        opt_params = dict(opt_params or {})
        if master.dtype != torch.float32 or master.device.type != "cpu" or \
                master.dim() != 1:
            raise ValueError("the offload master is a 1-D fp32 CPU tensor")
        self.master = master
        self.opt_name = opt_name
        self.lr = float(opt_params.get("lr", 1e-3))
        betas = opt_params.get("betas", (0.9, 0.999))
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(opt_params.get("eps", 1e-8))
        self.weight_decay = float(opt_params.get("weight_decay", 0.0))
        self.adamw_mode = bool(opt_params.get(
            "adam_w_mode", opt_params.get(
                "adamw_mode", opt_name in ("adamw", "fusedadam", "cpuadam"))))
        self.step_count = 0
        self.rank = rank
        total = master.numel()
        sub = int(min(getattr(zero_config, "sub_group_size", 1 << 30) or
                      1 << 30, total)) or total
        self.subgroups: List[Tuple[int, int]] = [
            (lo, min(lo + sub, total)) for lo in range(0, total, sub)]
        self.n_moments = 1 if opt_name == "adagrad" else 2
        self.subgroup_updates = 0     # sub-group updates since construction
        self.last_step: Dict[str, float] = {}
        self._pinned = None           # the pipeline's staging buffers
        self._copy_streams = None
        oc = zero_config.offload_optimizer
        self.swapper = None
        if zero_config.offload_optimizer_device == "nvme":
            # the JAX package's /tmp, or $TMPDIR where it is set
            nvme_path = oc.nvme_path or tempfile.gettempdir()
            swap_dir = os.path.join(str(nvme_path), SWAP_SUBDIR,
                                    f"rank{rank}")
            self.swapper = OptimizerStateSwapper(
                swap_dir, self.n_moments,
                [hi - lo for lo, hi in self.subgroups],
                buffer_count=oc.buffer_count)
            logger.info(f"ZeRO-Infinity optimizer swap -> {swap_dir} "
                        f"({len(self.subgroups)} sub-groups)")
            self.moments = None
        else:
            self.moments = [torch.zeros(total, dtype=torch.float32)
                            for _ in range(self.n_moments)]

    # ------------------------------------------------------------------
    def _moments_of(self, gi, prefetch_next=True):
        """Sub-group ``gi``'s moment views (swapped in; the next one's read
        started)."""
        lo, hi = self.subgroups[gi]
        if self.swapper is None:
            return [m[lo:hi] for m in self.moments]
        moments = self.swapper.swap_in(gi)
        if prefetch_next and gi + 1 < len(self.subgroups):
            self.swapper.swap_in(gi + 1, prefetch=True)
        return moments

    def _update(self, lo, hi, grads, moments, lr):
        """The host update of master[lo:hi] from fp32 ``grads``, with
        ``moments`` the matching views."""
        p = self.master[lo:hi]
        if self.opt_name == "adagrad":
            cpu_adam.adagrad_update(p, grads, moments[0], lr=lr,
                                    eps=self.eps,
                                    weight_decay=self.weight_decay)
        else:
            st = cpu_adam.CPUAdamState(m=moments[0], v=moments[1],
                                       step=self.step_count - 1)
            cpu_adam.adam_update(p, grads, st, lr=lr, beta1=self.beta1,
                                 beta2=self.beta2, eps=self.eps,
                                 weight_decay=self.weight_decay,
                                 adamw_mode=self.adamw_mode)

    def step(self, flat_grads: torch.Tensor, lr: Optional[float] = None):
        """One step from host fp32 gradients (the flat layout)."""
        lr = self.lr if lr is None else float(lr)
        self.step_count += 1
        for gi, (lo, hi) in enumerate(self.subgroups):
            self._update(lo, hi, flat_grads[lo:hi], self._moments_of(gi), lr)
            self.subgroup_updates += 1
            if self.swapper is not None:
                self.swapper.swap_out(gi)
        if self.swapper is not None:
            self.swapper.release()

    def _pieces(self):
        """(sub-group, lo, hi) of every pipeline piece, in flat order."""
        return [(gi, lo, min(lo + PIPELINE_CHUNK, shi))
                for gi, (slo, shi) in enumerate(self.subgroups)
                for lo in range(slo, shi, PIPELINE_CHUNK)]

    def _staging(self, size, grad_dtype, out_dtype):
        """Pinned staging (D2H_DEPTH + 1 pieces of gradients, two of
        weights) and, for gradients other than fp32, the host fp32 piece
        they widen into; made once and kept."""
        key = (size, grad_dtype, out_dtype)
        if self._pinned is None or self._pinned[0] != key:
            def pinned(dtype):
                return torch.empty(size, dtype=dtype, pin_memory=True)
            self._pinned = (key, [pinned(grad_dtype)
                                  for _ in range(D2H_DEPTH + 1)],
                            [pinned(out_dtype) for _ in range(2)],
                            None if grad_dtype == torch.float32 else
                            torch.empty(size, dtype=torch.float32))
        return self._pinned[1:]

    def _streams(self, device):
        if self._copy_streams is None:
            self._copy_streams = (torch.cuda.Stream(device),
                                  torch.cuda.Stream(device))
        return self._copy_streams

    def step_streamed(self, grads: torch.Tensor, lr: Optional[float] = None,
                      clip_coef: Optional[float] = None,
                      out: Optional[torch.Tensor] = None):
        """One step fed by the flat gradient buffer ``grads`` (on the card,
        or a CPU tensor), pipelined piece by piece; the updated master goes
        into ``out`` (the compute-dtype weights) as each piece is done.
        ``last_step`` then holds the step's wall, update and wait seconds
        and, on the card, each copy direction's device ms and GB/s."""
        lr = self.lr if lr is None else float(lr)
        t_start = time.perf_counter()
        self.step_count += 1
        pieces = self._pieces()
        if grads.device.type == "cuda":
            xfer = _CudaTransfers(self, grads, out, clip_coef,
                                  [(lo, hi) for _, lo, hi in pieces])
        else:
            xfer = _HostTransfers(grads, out, clip_coef)
        swapped = self._swapped_bytes()
        update_s, moments, cur = 0.0, None, -1
        for i, (gi, lo, hi) in enumerate(pieces):
            g = xfer.fetch(i, lo, hi)
            if gi != cur:
                if cur >= 0 and self.swapper is not None:
                    self.swapper.swap_out(cur)
                moments, cur = self._moments_of(gi), gi
                self.subgroup_updates += 1
            slo = self.subgroups[gi][0]
            t0 = time.perf_counter()
            self._update(lo, hi, g, [m[lo - slo:hi - slo] for m in moments],
                         lr)
            update_s += time.perf_counter() - t0
            xfer.upload(lo, hi, self.master[lo:hi])
        if self.swapper is not None:
            if cur >= 0:
                self.swapper.swap_out(cur)
            self.swapper.release()
        stats = xfer.finish()
        if swapped is not None:
            read, written = self._swapped_bytes()
            stats.update(swap_read_bytes=read - swapped[0],
                         swap_write_bytes=written - swapped[1])
        self.last_step = dict(stats, update_s=update_s, pieces=len(pieces),
                              wall_s=time.perf_counter() - t_start)

    def _swapped_bytes(self):
        """(bytes read, bytes written) by the swapper so far; None
        without one."""
        if self.swapper is None:
            return None
        xfer = self.swapper.store._xfer
        return xfer["nvme_read"][0], xfer["nvme_write"][0]

    # ------------------------------------------------------------------
    # checkpoints: zero_offload_rank{rank}.npz, the JAX package's keys
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        if self.swapper is not None:
            moments = [torch.empty_like(self.master)
                       for _ in range(self.n_moments)]
            for gi, (lo, hi) in enumerate(self.subgroups):
                for m, v in zip(moments,
                                self._moments_of(gi, prefetch_next=False)):
                    m[lo:hi] = v
            self.swapper.release()
        else:
            moments = self.moments
        return {"master": self.master, "step": self.step_count,
                **{f"moment{i}": m for i, m in enumerate(moments)}}

    def load_state_dict(self, sd: Dict[str, Any]):
        master = torch.as_tensor(np.asarray(sd["master"]))
        if master.shape != self.master.shape:
            raise ValueError(
                f"offload master size mismatch: the checkpoint has "
                f"{master.shape[0]} elements, this optimizer expects "
                f"{self.master.shape[0]}")
        self.master.copy_(master)
        self.step_count = int(sd["step"])
        moments = [torch.as_tensor(np.asarray(sd[f"moment{i}"]))
                   for i in range(self.n_moments)]
        if self.swapper is not None:
            for gi, (lo, hi) in enumerate(self.subgroups):
                views = self.swapper.swap_in(gi)
                for v, m in zip(views, moments):
                    v.copy_(m[lo:hi])
                self.swapper.swap_out(gi, sync=True)
            self.swapper.release()
        else:
            for dst, src in zip(self.moments, moments):
                dst.copy_(src)

    def save(self, save_dir: str, tag: str):
        path = os.path.join(save_dir, tag)
        os.makedirs(path, exist_ok=True)
        sd = self.state_dict()
        np.savez(os.path.join(path, f"zero_offload_rank{self.rank}.npz"),
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in sd.items()})

    def load(self, load_dir: str, tag: str) -> bool:
        f = os.path.join(load_dir, tag, f"zero_offload_rank{self.rank}.npz")
        if not os.path.exists(f):
            return False
        with np.load(f) as z:
            self.load_state_dict({k: z[k] for k in z.files})
        return True
