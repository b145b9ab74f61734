"""The tiered store's NVMe swap surface (ZeRO-Infinity's optimizer swap).

Counterpart of the part of the JAX package's ``runtime/tiered_store.py``
that the optimizer swapper (``runtime/zero/offload.py``) goes through: a
:class:`TieredStore` catalogs named swap slots (``register_swap``), each a
file ``<key>.bin`` in its directory, which the swapper's own pinned ring
buffers read and write in place (``read_into`` / ``write_from``) through
two aio queues, a reader and a writer, so a write-back of sub-group *i*
overlaps the update of *i + 1*.  ``commit`` seals the directory with the
checkpoint protocol's self-digested manifest and commit marker
(``runtime/resilience.py``; both written tmp -> fsync -> atomic rename),
so ``resilience.validate_tag`` and ``checkpoint/fsck`` classify a swap
directory as they do a tag: a torn file is ``partial``, a missing marker
``no_marker``.  Every transfer lands in the accounting ``stats`` reads
(bytes and seconds by path).

The rest of the JAX store -- ``put`` / ``fetch`` / ``evict``, the host and
HBM budgets, :class:`PlacementPolicy`, int8 payloads and
:class:`PrefetchEngine` -- comes with the parameter stream and raises
naming ROADMAP A12b; ``publish_gauges`` raises naming A17 (the telemetry
registry is not ported).  The gauge names stay as the frozen vocabulary.
"""

import json
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime import resilience

#: The tier chain, fastest first.
TIERS = ("hbm", "host", "nvme")

#: Subdirectory under ``nvme_dir`` holding one tag dir per store.
STORE_SUBDIR = "ds_tiered"

# the JAX store's frozen gauge vocabulary of the tiered-memory plane
TIER_GAUGES = (
    "tier/hbm_bytes",
    "tier/host_bytes",
    "tier/nvme_bytes",
    "tier/prefetch_hits",
    "tier/prefetch_misses",
    "tier/evictions",
    "tier/writebacks",
    "tier/h2d_gbps",
    "tier/d2h_gbps",
    "tier/nvme_read_gbps",
    "tier/nvme_write_gbps",
    "tier/quant_bytes_saved",
)

_PARAM_STREAM = "ROADMAP A12b: the parameter stream and the rest of the " \
    "tiered store"


def _unported(what):
    raise NotImplementedError(f"{what} is not ported yet ({_PARAM_STREAM})")


def _sanitize(key: str) -> str:
    """A file-name-safe entry key."""
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in key)


class PlacementPolicy:
    """Per-tensor tier placement: comes with the parameter stream."""

    def __init__(self, *args, **kwargs):
        _unported("PlacementPolicy (per-tensor tier placement)")


class PrefetchEngine:
    """Schedule-driven prefetch: comes with the parameter stream."""

    def __init__(self, *args, **kwargs):
        _unported("PrefetchEngine (schedule-driven prefetch)")


class TieredStore:
    """Named NVMe swap slots under ``nvme_dir`` (``nvme_dir /
    STORE_SUBDIR / name``; ``nvme_subdir=None``: ``nvme_dir`` itself, the
    optimizer swap's flat layout).  ``fsync``: commit fsyncs the files and
    the directory."""

    def __init__(self, name: str = "store", nvme_dir: Optional[str] = None,
                 host_budget_bytes: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 aio_config: Optional[dict] = None, fsync: bool = False,
                 nvme_subdir: Optional[str] = STORE_SUBDIR):
        if host_budget_bytes or hbm_budget_bytes:
            _unported("the tiered store's host and HBM budgets")
        self.name = str(name)
        self.fsync = fsync
        self._dir = None
        if nvme_dir is not None:
            self._dir = (os.path.join(str(nvme_dir), nvme_subdir, self.name)
                         if nvme_subdir else str(nvme_dir))
            os.makedirs(self._dir, exist_ok=True)
        # key -> (numel, dtype)
        self._slots: Dict[str, Tuple[int, torch.dtype]] = {}
        self._reader = AsyncIOHandle(**(aio_config or {}))
        self._writer = AsyncIOHandle(**(aio_config or {}))
        self._sealed = False
        # cumulative transfer accounting: kind -> [bytes, seconds]
        self._xfer = {k: [0, 0.0] for k in
                      ("h2d", "d2h", "nvme_read", "nvme_write")}
        self._counts = {"prefetch_hits": 0, "prefetch_misses": 0,
                        "evictions": 0, "writebacks": 0,
                        "quant_bytes_saved": 0}

    # -- paths -------------------------------------------------------------
    @property
    def nvme_path(self) -> Optional[str]:
        return self._dir

    def path_for(self, key: str) -> str:
        if self._dir is None:
            raise ValueError(f"tiered store {self.name!r}: an NVMe slot "
                             f"needs a directory (none configured)")
        return os.path.join(self._dir, f"{_sanitize(key)}.bin")

    # -- transfer accounting ------------------------------------------------
    def _account(self, kind: str, nbytes: int, dur_s: float):
        rec = self._xfer[kind]
        rec[0] += int(nbytes)
        rec[1] += max(dur_s, 1e-9)

    def publish_gauges(self):
        raise NotImplementedError("the tier/* gauges go to the telemetry "
                                  "registry, which is not ported yet "
                                  "(ROADMAP A17)")

    def note_prefetch(self, hit: bool, n: int = 1):
        self._counts["prefetch_hits" if hit else "prefetch_misses"] += int(n)

    def note_transfer(self, kind: str, nbytes: int, dur_s: float):
        """Book a transfer a client ran itself (h2d / d2h / nvme_read /
        nvme_write)."""
        self._account(kind, nbytes, dur_s)

    def note_eviction(self, n: int = 1):
        self._counts["evictions"] += int(n)

    def note_writeback(self, n: int = 1):
        self._counts["writebacks"] += int(n)

    def tier_bytes(self) -> Dict[str, int]:
        """Bytes by tier: every swap slot is an NVMe entry."""
        occ = {t: 0 for t in TIERS}
        for numel, dtype in self._slots.values():
            occ["nvme"] += numel * torch.empty((), dtype=dtype).element_size()
        return occ

    def stats(self) -> Dict[str, object]:
        out = {f"{t}_bytes": b for t, b in self.tier_bytes().items()}
        out.update(self._counts)
        for kind, (nbytes, secs) in self._xfer.items():
            out[f"{kind}_gbps"] = round(nbytes / secs / 1e9, 6) if nbytes \
                else 0.0
        hits = self._counts["prefetch_hits"]
        misses = self._counts["prefetch_misses"]
        out["prefetch_hit_rate"] = (round(hits / (hits + misses), 4)
                                    if hits + misses else None)
        out["entries"] = len(self._slots)
        return out

    # -- the swapper's seam -------------------------------------------------
    def register_swap(self, key: str, numel: int,
                      dtype=torch.float32) -> str:
        """Catalog an NVMe swap slot of ``numel`` elements, streamed through
        the caller's pinned buffers; returns its file's path."""
        self._slots[key] = (int(numel), dtype)
        return self.path_for(key)

    def read_into(self, key: str, view: torch.Tensor, async_op=False):
        """Slot ``key`` -> the caller's host buffer; an async read is done
        at :meth:`reader_wait`."""
        path = self.path_for(key)
        t0 = time.perf_counter()
        if async_op:
            self._reader.async_pread(view, path)
        else:
            self._reader.sync_pread(view, path)
        self._account("nvme_read", view.numel() * view.element_size(),
                      time.perf_counter() - t0)

    def write_from(self, key: str, view: torch.Tensor, sync=True):
        """The caller's host buffer -> slot ``key``, rewritten in place (the
        hot path: the next :meth:`commit` restores durability)."""
        path = self.path_for(key)
        t0 = time.perf_counter()
        if sync:
            self._writer.sync_pwrite(view, path)
        else:
            self._writer.async_pwrite(view, path)
        self._account("nvme_write", view.numel() * view.element_size(),
                      time.perf_counter() - t0)
        self._counts["writebacks"] += 1
        self._sealed = False

    def reader_wait(self):
        return self._reader.wait()

    def writer_wait(self):
        return self._writer.wait()

    def alloc_pinned(self, numel: int, dtype=torch.float32) -> torch.Tensor:
        return self._reader.new_cpu_locked_tensor(int(numel), dtype)

    # -- what comes with the parameter stream ---------------------------------
    def put(self, key, value, tier=None):
        _unported("TieredStore.put")

    def fetch(self, key, device=False):
        _unported("TieredStore.fetch")

    def evict(self, key, writeback=None):
        _unported("TieredStore.evict")

    # -- durability: manifest + marker ----------------------------------------
    def commit(self, global_step: int = 0) -> Optional[str]:
        """Seal the directory with the checkpoint protocol's manifest and
        commit marker, in place; returns it (None without one)."""
        if self._dir is None:
            return None
        self._writer.wait()
        entries = [{"key": key, "quantized": False, "mapped": False,
                    "leaves": [{"sub": "", "shape": [numel],
                                "dtype": str(dtype).replace("torch.", ""),
                                "files": [os.path.basename(
                                    self.path_for(key))]}]}
                   for key, (numel, dtype) in self._slots.items()]
        manifest = resilience.build_manifest(
            {}, tag=self.name, global_step=global_step,
            extra={"tiered_store": {
                "name": self.name,
                "policy": {"default_tier": "nvme", "quantize": False,
                           "quant_block": 256, "read_only": False},
                "entries": entries}})
        manifest["files"] = resilience._payload_files(self._dir)
        manifest["digest"] = resilience._manifest_digest(manifest)
        resilience.atomic_write_text(
            os.path.join(self._dir, resilience.MANIFEST_NAME),
            json.dumps(manifest), fsync=self.fsync)
        resilience.atomic_write_text(
            os.path.join(self._dir, resilience.COMMIT_MARKER),
            manifest["digest"], fsync=self.fsync)
        if self.fsync:
            resilience.fsync_tree(self._dir)
        self._sealed = True
        return self._dir

    def validate(self):
        """fsck of the directory: ``(status, manifest)`` from
        ``resilience.validate_tag``."""
        if self._dir is None:
            return resilience.MISSING, None
        return resilience.validate_tag(self._dir)

    # -- teardown -----------------------------------------------------------
    def wait_all(self):
        self._reader.wait()
        self._writer.wait()

    def release(self):
        """Drain the I/O; the files (and the manifest, once committed)
        stay."""
        self.wait_all()

    def destroy(self):
        """Release, then delete the directory and every file in it."""
        self.release()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
        self._slots = {}

    def keys(self) -> List[str]:
        return list(self._slots)

    def __contains__(self, key: str) -> bool:
        return key in self._slots

    def __len__(self) -> int:
        return len(self._slots)
