"""Training-time parameter offload: ZeRO-Infinity's parameter stream.

Counterpart of the JAX package's ``runtime/zero/param_stream.py`` at world
size 1 (the reference's ``zero.Init(remote_device="cpu" / "nvme")``,
``partition_parameters.py:539``, with the prefetching coordinator of
``partitioned_param_coordinator.py:458``): the model's parameters live on
the host, in RAM or in NVMe-backed memmaps, and only the resident group
(embeddings, head, norms) and a window of ``buffer_count`` layers' working
sets are ever on the card.

* :class:`HostParamStore` keeps, per unit (``-1`` the resident group,
  ``0 .. L-1`` the layers), the fp32 master, the optimizer's moments
  (Adam's two, Adagrad's one), a compute-dtype mirror -- what goes up to
  the card -- and a gradient accumulator in the gradient dtype, each a
  plane of the tiered store (``runtime/tiered_store.register_plane``): 2-D
  ``[L, F]`` planes when every layer has one layout, one plane a layer
  otherwise.  A unit's flat order is its names sorted, the JAX tree's
  leaf order, split by the port's ``FlatLayout``.  The moments follow
  ``offload_optimizer.device`` and the rest ``offload_param.device``.
  At the accumulation boundary each unit's gradient sum is divided by gas,
  times the clip coefficient, fed to the host C++ Adam or Adagrad of
  ``ops/cpu_adam.py`` (the JAX store's order), and the unit's mirror is
  refreshed from its master.
* :class:`ParamStreamRunner` drives the step.  The forward runs each layer
  under ``torch.no_grad`` from its working set and stashes its input; the
  head's loss and its gradients come from ``torch.autograd.grad``; the
  backward walks the layers in reverse, re-runs each with grad on detached
  leaves and takes ``autograd.grad(x_out, (x_in, *weights), dx_out)`` --
  the stream's per-layer recompute is its activation checkpointing, so the
  flash forward runs twice a layer and the backward kernels once, as on
  the device path under remat.  Each program's gradients are unscaled in
  fp32 and stored in the gradient dtype while the cotangent chain stays
  scaled; under fp16 a finite flag stays on the card and is read once, at
  the boundary.  The tied head's and embedding's gradients are summed in
  fp32 before the cast.

On the card the uploads of layers ``l + 1 .. l + buffer_count - 1`` run on
a copy stream while layer ``l`` computes: a working set is allocated on
the compute stream, the copy stream waits for the compute stream's work
so far (the memory may have just been freed there) and the compute stream
waits for the copy's event before the first use -- or before the set is
dropped unused.  The mirrors come from page-locked memory (the cpu tier's
mirror plane is pinned in place, once) or, from NVMe memmaps, through a
ring of ``buffer_count`` pinned one-unit slots.  Each layer's gradients go
down on a second copy stream into a ring of ``buffer_count + 1`` pinned
slots (made at first use, never per step) and land in the host
accumulator ``buffer_count`` programs later; a unit's squared norm is
taken as its last gradient lands.  The boundary runs the host update on
the main thread and hands each updated unit the next step needs first
(the resident group, the pinned layers, the first window) to one worker
thread, whose copies run on the copy stream (``boundary_pipelined =
False``: the serial walk, the benchmark's ablation).  On the CPU (the
tests) the working sets are views of the mirror planes and nothing is
copied.

Not ported: the shardings of a mesh, ``comm_quant`` and the multi-host
gradient all-reduce (ROADMAP A8, A13); MoE list layers (A14); the
telemetry spans and gauges (A17), which the JAX runner emits only with
telemetry on -- the store's prefetch, transfer and eviction counters are
kept.
"""

import json
import math
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import cpu_adam
from deepspeed_tpu_torch.runtime.optimizers import FlatLayout
from deepspeed_tpu_torch.runtime.tiered_store import (PlacementPolicy,
                                                      TieredStore,
                                                      pinned_empty)
from deepspeed_tpu_torch.runtime.zero.config import OffloadDeviceEnum

STREAM_SUBDIR = "zero_param_stream"
STREAM_METHODS = ("stream_split", "stream_embed", "stream_layer",
                  "stream_head_loss")


def _chunked_sq(t: torch.Tensor, chunk: int = 1 << 24) -> float:
    """Sum of squares in fp32 chunks, added up in double (the JAX
    ``_chunked_sq``): a bf16 accumulator never becomes a whole fp32
    copy."""
    flat = t.reshape(-1)
    total = 0.0
    for i in range(0, flat.numel(), chunk):
        c = flat[i:i + chunk].float()
        total += float(torch.dot(c, c))
    return total


class UnitLayout:
    """One unit's flat layout: its tensors by name, in sorted order (the
    JAX tree's leaf order), over the port's :class:`FlatLayout`."""

    def __init__(self, tree: Dict[str, torch.Tensor]):
        self.names = sorted(tree)
        self.shapes = [tuple(tree[n].shape) for n in self.names]
        self.flat = FlatLayout([math.prod(s) for s in self.shapes],
                               list(range(len(self.names))), "cpu")
        self.total = self.flat.numel

    def flatten(self, tree, out: torch.Tensor) -> torch.Tensor:
        for name, view in zip(self.names, self.flat.views(out)):
            view.copy_(tree[name].detach().reshape(-1))
        return out

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: v.view(s) for n, v, s in
                zip(self.names, self.flat.views(flat), self.shapes)}


class HostParamStore:
    """The host master, moments, mirror and gradient accumulator of the
    resident group (unit ``-1``) and of each layer.  ``pin``: page-lock
    the RAM mirrors in place (the runner on the card, ``nvme_dir`` None);
    ``moments_nvme_dir``: where the moments go (default: the param
    state's tier)."""

    FOLLOW_PARAM_TIER = "__follow_param_tier__"

    def __init__(self, resident, layers: List[Dict[str, torch.Tensor]],
                 opt_params: Optional[dict] = None, opt_name: str = "adamw",
                 compute_dtype=torch.bfloat16, nvme_dir: Optional[str] = None,
                 grad_dtype=torch.float32,
                 moments_nvme_dir=FOLLOW_PARAM_TIER, pin: bool = False):
        opt_params = dict(opt_params or {})
        betas = opt_params.get("betas", (0.9, 0.999))
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(opt_params.get("eps", 1e-8))
        self.weight_decay = float(opt_params.get("weight_decay", 0.0))
        self.adamw_mode = bool(opt_params.get(
            "adam_w_mode", opt_params.get(
                "adamw_mode", opt_name in ("adamw", "fusedadam", "cpuadam"))))
        self.opt_name = opt_name
        self.n_moments = 1 if opt_name == "adagrad" else 2
        self.step_count = 0
        self.update_s = 0.0           # host update seconds since reset
        self._sq_cache: Dict[int, float] = {}
        self.compute_dtype = compute_dtype
        self.grad_dtype = grad_dtype
        self.nvme_dir = nvme_dir
        self.moments_nvme_dir = (nvme_dir
                                 if moments_nvme_dir == self.FOLLOW_PARAM_TIER
                                 else moments_nvme_dir)
        mdir = self.moments_nvme_dir
        self.n_layers = len(layers)
        self.pinned = bool(pin and nvme_dir is None)
        self.tiered = TieredStore(name="param_stream",
                                  policy=PlacementPolicy(default_tier="host"))

        def plane(name, shape, dtype, d, pin=False):
            return self.tiered.register_plane(name, shape, dtype,
                                              nvme_dir=d, pin=pin)

        self.res_layout = UnitLayout(resident)
        R = self.res_layout.total
        self.res_master = plane("res_master", R, torch.float32, nvme_dir)
        self.res_layout.flatten(resident, self.res_master)
        self.res_moments = [plane(f"res_m{i}", R, torch.float32, mdir)
                            for i in range(self.n_moments)]
        self.res_gacc = plane("res_gacc", R, grad_dtype, nvme_dir)
        self.res_mirror = plane("res_mirror", R, compute_dtype, nvme_dir,
                                self.pinned)
        self.res_mirror.copy_(self.res_master)

        layouts = [UnitLayout(t) for t in layers]
        l0 = layouts[0]
        # equal names AND per-tensor shapes, not just equal totals: layer
        # 0's layout would unflatten other shapes into wrong views
        self.homogeneous = all(lay.names == l0.names and
                               lay.shapes == l0.shapes
                               for lay in layouts[1:])
        L = self.n_layers
        if self.homogeneous:
            self.layouts = [l0] * L
            F = l0.total
            self.masters = plane("layer_master", (L, F), torch.float32,
                                 nvme_dir)
            self.moments = [plane(f"layer_m{i}", (L, F), torch.float32, mdir)
                            for i in range(self.n_moments)]
            self.mirrors = plane("layer_mirror", (L, F), compute_dtype,
                                 nvme_dir, self.pinned)
            self.gaccs = plane("layer_gacc", (L, F), grad_dtype, nvme_dir)
        else:
            self.layouts = layouts
            self.masters = [plane(f"layer{l}_master", lay.total,
                                  torch.float32, nvme_dir)
                            for l, lay in enumerate(layouts)]
            self.moments = [[plane(f"layer{l}_m{i}", lay.total,
                                   torch.float32, mdir)
                             for l, lay in enumerate(layouts)]
                            for i in range(self.n_moments)]
            self.mirrors = [plane(f"layer{l}_mirror", lay.total,
                                  compute_dtype, nvme_dir, self.pinned)
                            for l, lay in enumerate(layouts)]
            self.gaccs = [plane(f"layer{l}_gacc", lay.total, grad_dtype,
                                nvme_dir)
                          for l, lay in enumerate(layouts)]
        for l, t in enumerate(layers):
            self.layouts[l].flatten(t, self.masters[l])
            self.mirrors[l].copy_(self.masters[l])

    # -- accessors -----------------------------------------------------
    def layout(self, l: int) -> UnitLayout:
        return self.res_layout if l < 0 else self.layouts[l]

    def master(self, l: int) -> torch.Tensor:
        return self.res_master if l < 0 else self.masters[l]

    def mirror(self, l: int) -> torch.Tensor:
        """Unit ``l``'s compute-dtype mirror, flat: what goes up."""
        return self.res_mirror if l < 0 else self.mirrors[l]

    def gacc(self, l: int) -> torch.Tensor:
        return self.res_gacc if l < 0 else self.gaccs[l]

    def _moms(self, l: int):
        if l < 0:
            return self.res_moments
        return [m[l] for m in self.moments]

    def unit_numel(self) -> int:
        """The largest unit's element count."""
        return max([self.res_layout.total] +
                   [lay.total for lay in self.layouts])

    def num_params(self) -> int:
        return self.res_layout.total + sum(l.total for l in self.layouts)

    # -- gradient accumulation -----------------------------------------
    def accumulate(self, l: int, flat: torch.Tensor, first: bool):
        """Unit ``l``'s accumulator = ``flat`` (``first``) or += it, in
        the accumulator's dtype."""
        g = self.gacc(l)
        if first:
            g.copy_(flat)
        else:
            g.add_(flat.to(g.dtype))

    def zero_grads(self):
        self._sq_cache.clear()
        self.res_gacc.zero_()
        if self.homogeneous:
            self.gaccs.zero_()
        else:
            for g in self.gaccs:
                g.zero_()

    def cache_unit_sq(self, l: int):
        """Unit ``l``'s squared-norm share, taken as its last gradient
        lands (under the later units' copies), so the boundary does not
        read every accumulator again."""
        self._sq_cache[l] = _chunked_sq(self.gacc(l))

    def grad_sq_norm(self) -> float:
        """The squared global norm of the accumulated gradients."""
        return sum(self._sq_cache[l] if l in self._sq_cache
                   else _chunked_sq(self.gacc(l))
                   for l in range(-1, self.n_layers))

    # -- the update ----------------------------------------------------
    def begin_step(self):
        self.step_count += 1

    def apply_unit(self, l: int, lr: float, clip_coef: Optional[float],
                   gas: int):
        """The host Adam or Adagrad on unit ``l``'s master from its
        accumulated sum divided by ``gas``, times ``clip_coef``; then the
        mirror refreshed and the accumulator zeroed (the JAX order)."""
        acc = self.gacc(l)
        g = acc.float()
        if gas > 1:
            g = g / float(gas)
        if clip_coef is not None:
            g = g * float(clip_coef)
        if g is acc:       # an fp32 accumulator, unscaled: keep it intact
            g = g.clone()
        p = self.master(l)
        moms = self._moms(l)
        t0 = time.perf_counter()
        if self.opt_name == "adagrad":
            cpu_adam.adagrad_update(p, g, moms[0], lr=lr, eps=self.eps,
                                    weight_decay=self.weight_decay)
        else:
            cpu_adam.adam_update(
                p, g, cpu_adam.CPUAdamState(m=moms[0], v=moms[1],
                                            step=self.step_count - 1),
                lr=lr, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                weight_decay=self.weight_decay, adamw_mode=self.adamw_mode)
        self.update_s += time.perf_counter() - t0
        self.mirror(l).copy_(p)
        acc.zero_()
        self._sq_cache.pop(l, None)

    # -- checkpoint ----------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        out = {"step": self.step_count, "res_master": self.res_master}
        for i, m in enumerate(self.res_moments):
            out[f"res_m{i}"] = m
        if self.homogeneous:
            out["masters"] = self.masters
            for i, m in enumerate(self.moments):
                out[f"m{i}"] = m
        else:
            for l in range(self.n_layers):
                out[f"master{l}"] = self.masters[l]
                for i in range(self.n_moments):
                    out[f"m{i}_{l}"] = self.moments[i][l]
        return out

    def load_state_dict(self, sd, load_optimizer_states: bool = True):
        def t(x):
            return torch.as_tensor(np.asarray(x))
        if load_optimizer_states:
            self.step_count = int(sd["step"])
            for i, m in enumerate(self.res_moments):
                m.copy_(t(sd[f"res_m{i}"]))
        self.res_master.copy_(t(sd["res_master"]))
        self.res_mirror.copy_(self.res_master)
        if self.homogeneous:
            self.masters.copy_(t(sd["masters"]))
            if load_optimizer_states:
                for i, m in enumerate(self.moments):
                    m.copy_(t(sd[f"m{i}"]))
        else:
            for l in range(self.n_layers):
                self.masters[l].copy_(t(sd[f"master{l}"]))
                if load_optimizer_states:
                    for i in range(self.n_moments):
                        self.moments[i][l].copy_(t(sd[f"m{i}_{l}"]))
        for l in range(self.n_layers):
            self.mirrors[l].copy_(self.masters[l])


class _WorkingSet:
    """A unit's tensors on the card (by name) and the event of the copy
    that filled them; the compute stream waits for it once."""

    def __init__(self, tensors, done=None):
        self.tensors = tensors
        self.done = done

    def wait(self):
        if self.done is not None:
            torch.cuda.current_stream().wait_event(self.done)
            self.done = None
        return self.tensors


class ParamStreamRunner:
    """Drives the streamed step for an engine whose model has the
    layer-stream contract (``stream_split`` / ``stream_embed`` /
    ``stream_layer`` / ``stream_head_loss``, ``models/transformer.py``).
    ``named``: the parameters by module name, host tensors (or the
    module's own), which the store copies."""

    def __init__(self, model, named, config, device,
                 compute_dtype=torch.bfloat16, grad_accum_dtype=torch.float32,
                 opt_name: str = "adamw", opt_params: Optional[dict] = None,
                 backend: str = "auto"):
        for meth in STREAM_METHODS:
            if not hasattr(model, meth):
                raise ValueError(
                    "offload_param needs a layer-streamable model (a "
                    f"CausalTransformerLM-style class with {meth}); got "
                    f"{type(model).__name__}.  For non-streamable models "
                    "use offload_optimizer only.")
        self.model = model
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.backend = backend
        self.compute_dtype = compute_dtype
        zc = config.zero_config
        pc, oc = zc.offload_param, zc.offload_optimizer
        # the param state follows offload_param.device, the moments
        # offload_optimizer.device (the param tier when it is unset)
        base_dir = None
        if OffloadDeviceEnum.nvme in (zc.offload_param_device,
                                      zc.offload_optimizer_device):
            nvme_path = (pc.nvme_path if pc and pc.nvme_path else
                         (oc.nvme_path if oc and oc.nvme_path else
                          tempfile.gettempdir()))
            base_dir = os.path.join(str(nvme_path), STREAM_SUBDIR, "rank0")
        nvme_dir = (base_dir
                    if zc.offload_param_device == OffloadDeviceEnum.nvme
                    else None)
        if zc.offload_optimizer_device == OffloadDeviceEnum.nvme:
            moments_dir = base_dir
        elif zc.offload_optimizer_device == OffloadDeviceEnum.cpu:
            moments_dir = None
        else:
            moments_dir = nvme_dir
        self.buffer_count = max(2, int(getattr(pc, "buffer_count", 2) or 2))
        resident, layers = model.stream_split(named)
        self.n_layers = len(layers)
        self.resident_layers = min(
            int(getattr(pc, "resident_layers", 0) or 0), self.n_layers)
        self.store = HostParamStore(
            resident, layers, opt_params=opt_params, opt_name=opt_name,
            compute_dtype=compute_dtype, nvme_dir=nvme_dir,
            grad_dtype=grad_accum_dtype, moments_nvme_dir=moments_dir,
            pin=self.on_card)
        self.windows = getattr(model.config, "local_attn_pattern", None)
        self.boundary_pipelined = True     # the benchmark's ablation knob
        self._pool: Optional[ThreadPoolExecutor] = None
        self._holders: list = []           # page-locked slot rings
        self._stage_ring = None            # NVMe mirrors -> the card
        self._grad_ring = None             # gradients -> the host
        self._copies = {"h2d": [], "d2h": []}
        if self.on_card:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._dev: Dict[int, _WorkingSet] = {}     # the streamed window
        self._pinned: Dict[int, _WorkingSet] = {}  # resident_layers
        self._res = self._upload_unit(-1)
        self._upload_pinned()
        self.last_step: Dict[str, float] = {}

    # -- placement -----------------------------------------------------
    def _xfer_pool(self) -> ThreadPoolExecutor:
        """One worker for the boundary's uploads: the host update keeps
        the main thread (and OpenMP's full width) while the worker issues
        the copies of units already updated."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="param_stream_xfer")
        return self._pool

    def _ring(self, n_slots, dtype):
        return {"slots": [pinned_empty(self.store.unit_numel(), dtype,
                                       self._holders)
                          for _ in range(n_slots)],
                "done": [None] * n_slots, "next": 0}

    @staticmethod
    def _take(ring):
        """The ring's next slot, once the copy that last used it is
        done."""
        i = ring["next"] % len(ring["slots"])
        ring["next"] += 1
        if ring["done"][i] is not None:
            ring["done"][i].synchronize()
        return i, ring["slots"][i]

    def _timed_copy(self, stream, kind, dst, src):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            start.record(stream)
            dst.copy_(src, non_blocking=True)
            end.record(stream)
        self._copies[kind].append((start, end,
                                   dst.numel() * dst.element_size()))
        return end

    def _upload_unit(self, l: int) -> _WorkingSet:
        """Unit ``l``'s mirror on the device (the resident group for -1).
        On the CPU: views of the mirror plane."""
        host = self.store.mirror(l)
        layout = self.store.layout(l)
        if not self.on_card:
            return _WorkingSet(layout.unflatten(host))
        with torch.cuda.device(self.device):   # the boundary's worker too
            return self._upload_to_card(host, layout)

    def _upload_to_card(self, host, layout) -> _WorkingSet:
        t0 = time.perf_counter()
        # allocated on the compute stream, written on the copy stream
        # once the compute stream's work so far (the last user of this
        # memory) is done
        buf = torch.empty(host.numel(), dtype=host.dtype, device=self.device)
        ready = torch.cuda.Event()
        ready.record()
        self._h2d.wait_event(ready)
        slot = None
        if not self.store.pinned:
            if self._stage_ring is None:
                self._stage_ring = self._ring(self.buffer_count,
                                              self.compute_dtype)
            slot, stage = self._take(self._stage_ring)
            src = stage[:host.numel()]
            src.copy_(host)
        else:
            src = host
        done = self._timed_copy(self._h2d, "h2d", buf, src)
        if slot is not None:
            self._stage_ring["done"][slot] = done
        self.store.tiered.note_transfer(
            "h2d", host.numel() * host.element_size(),
            time.perf_counter() - t0)
        return _WorkingSet(layout.unflatten(buf), done)

    def _upload_pinned(self):
        for l in range(self.resident_layers):
            self._pinned[l] = self._upload_unit(l)

    @property
    def resident_dev(self) -> Dict[str, torch.Tensor]:
        """The resident group on the device (the compute stream waits for
        its upload)."""
        return self._res.wait()

    def _ensure(self, l: int, use: bool = False):
        """Layer ``l``'s working set: its upload is issued unless one is
        in flight -- call early to prefetch, late (``use``) to compute;
        ``use`` books a prefetch hit or a demand miss and makes the
        compute stream wait for the copy."""
        if l < 0 or l >= self.n_layers:
            return None
        if l < self.resident_layers:
            if use:
                self.store.tiered.note_prefetch(True)
                return self._pinned[l].wait()
            return None
        if use:
            self.store.tiered.note_prefetch(l in self._dev)
        if l not in self._dev:
            self._dev[l] = self._upload_unit(l)
        return self._dev[l].wait() if use else None

    def _evict(self, keep):
        """Drop the streamed working sets not in ``keep``; the compute
        stream first waits for a copy never waited for, so their memory
        is not reused under it."""
        keep = set(keep)
        dropped = [l for l in self._dev if l not in keep]
        for l in dropped:
            self._dev.pop(l).wait()
        if dropped:
            self.store.tiered.note_eviction(len(dropped))

    # -- programs ------------------------------------------------------
    def _window(self, l):
        return self.windows[l] if self.windows else None

    def _unscale(self, g, scale):
        """Gradient -> fp32 / scale -> the gradient dtype."""
        if scale is None:
            return g.to(self.store.grad_dtype)
        return (g.float() / scale).to(self.store.grad_dtype)

    def _flat_grads(self, grads, total, scale):
        """One unit's gradients as one flat tensor in the gradient dtype
        (unscaled under fp16)."""
        dtype = torch.float32 if scale is not None else self.store.grad_dtype
        flat = torch.empty(total, dtype=dtype, device=self.device)
        torch.cat([g.reshape(-1) for g in grads], out=flat)
        if scale is not None:
            flat = flat.div_(scale).to(self.store.grad_dtype)
        return flat

    @staticmethod
    def _leaves(tensors):
        return {k: v.detach().requires_grad_() for k, v in tensors.items()}

    def _head(self, x, mb, scale):
        """Loss of the head and its gradients: (ce, the resident group's
        unscaled gradients by name -- None where the head reads none --,
        dx, still scaled)."""
        res = self._leaves(self.resident_dev)
        names = list(res)
        xl = x.detach().requires_grad_()
        with torch.enable_grad():
            ce = self.model.stream_head_loss(res, xl, mb)
            grads = torch.autograd.grad(
                ce, [res[n] for n in names] + [xl],
                grad_outputs=None if scale is None else scale,
                allow_unused=True)
        dres = {n: (None if g is None else self._unscale(g, scale))
                for n, g in zip(names, grads[:-1])}
        return ce.detach(), dres, grads[-1]

    def _layer_bwd(self, l, params, x_in, positions, dx, scale):
        """Layer ``l`` recomputed with grad and its VJP: (dx_in, the
        layer's flat unscaled gradients)."""
        layout = self.store.layout(l)
        leaves = self._leaves(params)
        xin = x_in.detach().requires_grad_()
        with torch.enable_grad():
            out = self.model.stream_layer(leaves, xin, positions,
                                          window=self._window(l),
                                          attn_backend=self.backend)
            grads = torch.autograd.grad(
                out, [xin] + [leaves[n] for n in layout.names], dx)
        return grads[0], self._flat_grads(grads[1:], layout.total, scale)

    def _embed_bwd(self, mb, dx, scale):
        res = self._leaves(self.resident_dev)
        names = list(res)
        with torch.enable_grad():
            x0, _ = self.model.stream_embed(res, mb)
            grads = torch.autograd.grad(x0, [res[n] for n in names], dx,
                                        allow_unused=True)
        return {n: (None if g is None else self._unscale(g, scale))
                for n, g in zip(names, grads)}

    def _resident_flat(self, dres_h, dres_e):
        """The resident group's gradients in its flat order: the head's
        and the embedding's, summed in fp32 before the cast (the tied
        table's two parts)."""
        layout = self.store.res_layout
        gdt = self.store.grad_dtype
        parts = []
        for name, shape in zip(layout.names, layout.shapes):
            a, b = dres_h.get(name), dres_e.get(name)
            if a is None and b is None:
                g = torch.zeros(shape, dtype=gdt, device=self.device)
            elif a is None or b is None:
                g = a if b is None else b
            else:
                g = (a.float() + b.float()).to(gdt)
            parts.append(g.reshape(-1))
        return torch.cat(parts)

    # -- gradients to the host -----------------------------------------
    def _start_d2h(self, flat):
        """``flat`` on its way to a pinned slot: (host view, copy event);
        on the CPU the tensor itself."""
        if not self.on_card:
            return flat, None
        if self._grad_ring is None:
            self._grad_ring = self._ring(self.buffer_count + 1,
                                         self.store.grad_dtype)
        i, slot = self._take(self._grad_ring)
        ready = torch.cuda.Event()
        ready.record()
        self._d2h.wait_event(ready)
        host = slot[:flat.numel()]
        done = self._timed_copy(self._d2h, "d2h", host, flat)
        self._grad_ring["done"][i] = done
        # the compute stream frees flat; the copy must read it first
        flat.record_stream(self._d2h)
        return host, done

    # -- the step ------------------------------------------------------
    def train_step(self, micro_batches, gas: int, lr: float, loss_scale,
                   fp16: bool, clip: Optional[float]):
        """One optimizer step over the ``gas`` micro-batches (on the
        device).  Returns (mean loss, a device scalar; grad norm;
        overflow), the JAX runner's triple."""
        t_start = time.perf_counter()
        self.store.update_s = 0.0
        self._copies = {"h2d": [], "d2h": []}
        tstats = self.store.tiered.stats()
        land_wait = 0.0
        L, bc = self.n_layers, self.buffer_count
        scale = (torch.tensor(float(loss_scale), dtype=torch.float32,
                              device=self.device) if fp16 else None)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        pending = []            # (unit, host gradients, copy event, last)
        landed = set()

        def flush(keep):
            nonlocal land_wait
            while len(pending) > keep:
                unit, host, done, last = pending.pop(0)
                if done is not None:
                    t0 = time.perf_counter()
                    done.synchronize()
                    land_wait += time.perf_counter() - t0
                self.store.accumulate(unit, host, unit not in landed)
                landed.add(unit)
                if last:
                    # the unit's last gradient: its norm share now, under
                    # the copies of the units still to land
                    self.store.cache_unit_sq(unit)

        def send(unit, flat, last):
            nonlocal finite
            if fp16:
                finite = finite & torch.isfinite(flat).all()
            host, done = self._start_d2h(flat)
            pending.append((unit, host, done, last))

        for m, mb in enumerate(micro_batches):
            last = m == gas - 1
            with torch.no_grad():
                x, positions = self.model.stream_embed(self.resident_dev, mb)
                stash = [None] * L
                self._ensure(0)
                for l in range(L):
                    for k in range(1, bc):   # prefetch under compute
                        self._ensure(l + k)
                    params = self._ensure(l, use=True)
                    stash[l] = x
                    x = self.model.stream_layer(params, x, positions,
                                                window=self._window(l),
                                                attn_backend=self.backend)
                    self._evict(range(l, l + bc))
            ce, dres_h, dx = self._head(x, mb, scale)
            loss_sum = loss_sum + ce
            if fp16:
                finite = finite & torch.isfinite(dx).all()
            for l in range(L - 1, -1, -1):
                for k in range(1, bc):
                    self._ensure(l - k)
                params = self._ensure(l, use=True)
                dx, flat = self._layer_bwd(l, params, stash[l], positions,
                                           dx, scale)
                stash[l] = None
                send(l, flat, last)
                flush(bc)
                self._evict(range(l - bc + 1, l + 1))
            dres_e = self._embed_bwd(mb, dx, scale)
            send(-1, self._resident_flat(dres_h, dres_e), last)
            flush(0 if last else bc)

        # ---- the boundary: overflow, norm and clip, the host update ----
        overflow = bool(~finite) if fp16 else False
        grad_norm = 0.0
        t_b = time.perf_counter()
        if overflow:
            self.store.zero_grads()
        else:
            grad_norm = math.sqrt(self.store.grad_sq_norm()) / gas
            clip_coef = None
            if clip and clip > 0 and grad_norm > clip:
                clip_coef = clip / (grad_norm + 1e-6)
            self._apply_boundary(lr, clip_coef, gas,
                                 pipelined=self.boundary_pipelined)
        t_end = time.perf_counter()
        after = self.store.tiered.stats()
        self.last_step = dict(
            self._copy_stats(), wall_s=t_end - t_start,
            boundary_s=t_end - t_b, update_s=self.store.update_s,
            land_wait_s=land_wait,
            prefetch_hits=after["prefetch_hits"] - tstats["prefetch_hits"],
            prefetch_misses=(after["prefetch_misses"] -
                             tstats["prefetch_misses"]))
        return loss_sum / gas, grad_norm, overflow

    def _copy_stats(self):
        """Each direction's bytes, device ms and GB/s this step (CUDA
        events around every copy); nothing on the CPU."""
        out = {}
        for kind, copies in self._copies.items():
            if copies:
                copies[-1][1].synchronize()
                ms = sum(s.elapsed_time(e) for s, e, _ in copies)
                nbytes = sum(n for _, _, n in copies)
                out.update({f"{kind}_bytes": nbytes, f"{kind}_ms": ms,
                            f"{kind}_gbps": nbytes / ms / 1e6 if ms else
                            0.0})
        return out

    def _apply_boundary(self, lr: float, clip_coef: Optional[float],
                        gas: int, pipelined: bool = True):
        """The host update of every unit, then the units the next step
        needs first uploaded: the resident group, the pinned layers and
        the first window.  ``pipelined``: the update on the main thread,
        each updated unit's upload on the worker, under the next unit's
        update; else the serial walk."""
        L = self.n_layers
        self.store.begin_step()
        self._evict(())                    # every working set is stale
        first = [l for l in range(L)
                 if l < self.resident_layers or l < self.buffer_count]
        if not pipelined:
            self.store.apply_unit(-1, lr, clip_coef, gas)
            self._res = self._upload_unit(-1)
            for l in range(L):
                self.store.apply_unit(l, lr, clip_coef, gas)
            self._upload_pinned()
            for l in first:
                self._ensure(l)            # the next step's first window
            return
        ex = self._xfer_pool()
        self.store.apply_unit(-1, lr, clip_coef, gas)
        res = ex.submit(self._upload_unit, -1)
        ups = []
        for l in range(L):
            self.store.apply_unit(l, lr, clip_coef, gas)
            if l in first:
                ups.append((l, ex.submit(self._upload_unit, l)))
        self._res = res.result()
        for l, fut in ups:
            if l < self.resident_layers:
                self._pinned[l] = fut.result()
            else:
                self._dev[l] = fut.result()

    # -- eval ----------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self, batch):
        """The loss of one batch (on the device) through the stream, a
        device scalar."""
        bc = self.buffer_count
        x, positions = self.model.stream_embed(self.resident_dev, batch)
        for l in range(self.n_layers):
            for k in range(1, bc):
                self._ensure(l + k)
            x = self.model.stream_layer(self._ensure(l, use=True), x,
                                        positions, window=self._window(l),
                                        attn_backend=self.backend)
            self._evict(range(l, l + bc))
        return self.model.stream_head_loss(self.resident_dev, x, batch)

    # -- state ---------------------------------------------------------
    def named_params(self, dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Every parameter by module name, host copies of the master."""
        store = self.store
        resident = {n: v.to(dtype).clone() for n, v in
                    store.res_layout.unflatten(store.res_master).items()}
        layers = [{n: v.to(dtype).clone() for n, v in
                   store.layouts[l].unflatten(store.masters[l]).items()}
                  for l in range(self.n_layers)]
        return self.model.stream_join(resident, layers)

    def params_tree(self):
        """The fp32 params in the JAX layout (numpy leaves, the layers
        stacked)."""
        from deepspeed_tpu_torch.models.convert import stack_layers
        return stack_layers({n: t.numpy()
                             for n, t in self.named_params().items()})

    @staticmethod
    def _leaf_meta(layout: UnitLayout) -> List[dict]:
        """Path, shape and dtype of each of a unit's tensors in its flat
        order: the structure ``checkpoint/zero_to_fp32`` rebuilds the tree
        from (every parameter of the port's model is floating)."""
        return [{"path": [n], "shape": list(s), "float": True,
                 "dtype": "float32"}
                for n, s in zip(layout.names, layout.shapes)]

    def save(self, save_dir: str, tag: str):
        """``zero_param_stream_rank0.npz`` (masters, moments, step) and its
        ``.meta.json`` structure sidecar into ``save_dir/tag``."""
        path = os.path.join(save_dir, tag)
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "zero_param_stream_rank0.npz"),
                 **{k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in self.store.state_dict().items()})
        store = self.store
        meta = {"homogeneous": store.homogeneous, "n_layers": store.n_layers,
                "stacked": True, "layers_key": "layers",
                "resident": self._leaf_meta(store.res_layout)}
        if store.homogeneous:
            meta["layer"] = self._leaf_meta(store.layouts[0])
        else:
            meta["layer_list"] = [self._leaf_meta(lay)
                                  for lay in store.layouts]
        with open(os.path.join(path, "zero_param_stream_rank0.meta.json"),
                  "w") as f:
            json.dump(meta, f)

    def load(self, load_dir: str, tag: str,
             load_optimizer_states: bool = True) -> bool:
        """Restore the host masters (and the moments and step count with
        ``load_optimizer_states``), then the card's copies.  False when
        the tag has no sidecar."""
        f = os.path.join(load_dir, tag, "zero_param_stream_rank0.npz")
        if not os.path.exists(f):
            return False
        with np.load(f) as z:
            self.store.load_state_dict(
                {k: z[k] for k in z.files},
                load_optimizer_states=load_optimizer_states)
        self._evict(())
        self._res = self._upload_unit(-1)
        self._upload_pinned()
        return True
