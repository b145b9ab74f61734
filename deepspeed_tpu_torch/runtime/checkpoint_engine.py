"""Checkpoint engines: how a tag's payload is written and read.

Counterpart of ``deepspeed_tpu/runtime/checkpoint_engine.py``
(``CheckpointEngine``: create / save / load / commit; a sync engine and an
async Nebula-style one; ``get_checkpoint_engine(config)``).  The JAX
engines write an orbax tree under ``<tag>/state``; the port imports
neither JAX nor orbax, so its payload is numpy's:

* one ``.npy`` per state buffer -- the fp32 master, m and v as flat
  buffers and the device scalars (Adam's applied count, the loss-scale
  state, the skipped count) as 0-dim arrays -- named by the buffer's
  keystr by the universal format's rule (:func:`_safe`)
  (``master.npy``, ``loss_scale_cur_scale.npy``);
* ``layout.json``: which parameter lies where in the flat buffers (name,
  offset, shape), the compute dtype, and each buffer's file, shape and
  dtype;
* ``client_state.json``, under the JAX engine's keys.

The tag directory around it -- ``latest``, the ``.tmp`` twin, the
manifest, the commit marker -- is the JAX package's protocol
(``runtime/resilience.py``).  Weights cross between the two frameworks
through the universal format (``checkpoint/universal_checkpoint.py``).

``save`` first copies every buffer to host memory (pinned, when the
buffer is on the card; the copies are kept for the next save or load),
then writes the files: the sync engine before it returns, the async
engine on a background thread, which ``commit`` joins -- so the durable
protocol's commit marker never precedes the payload.  ``load`` reads every
file into host memory and checks it before the caller copies anything to
the card, so a torn payload leaves the engine's state as it was.
"""

import json
import os
import re
import threading
import time
from abc import ABC, abstractmethod

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.resilience import flatten_with_keystr
from deepspeed_tpu_torch.utils.logging import log_dist, logger

LAYOUT_NAME = "layout.json"
CLIENT_STATE_NAME = "client_state.json"
PAYLOAD_FORMAT = "deepspeed_tpu_torch"
PAYLOAD_VERSION = 1


def _safe(key: str) -> str:
    """A keystr as a file name (the JAX universal format's rule)."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", key).strip("_")


def buffer_file(key):
    """The payload file of the buffer at keystr ``key``."""
    return _safe(key) + ".npy"


def unflatten(flat, template):
    """The nested dict shaped like ``template`` (dicts only) whose leaves
    are ``flat[keystr]``, keeping only the keys ``flat`` has."""
    out = {}
    for key, _ in flatten_with_keystr(template):
        if key not in flat:
            continue
        parts = key[2:-2].split("']['")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = flat[key]
    return out


def read_npy_into(path, out):
    """Read the ``.npy`` at ``path`` into the host tensor ``out`` (its
    shape and dtype must match the file's), with no intermediate copy."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if major == 1
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        want = out.numpy()
        if tuple(shape) != tuple(want.shape) or dtype != want.dtype or \
                fortran:
            raise ValueError(f"{path}: {dtype}{list(shape)} in the file, "
                             f"{want.dtype}{list(want.shape)} expected")
        view = memoryview(want.reshape(-1).view(np.uint8))
        n = f.readinto(view)
        if n != want.nbytes:
            raise OSError(f"{path}: short read, {n} of {want.nbytes} "
                          f"bytes")


class CheckpointEngine(ABC):
    """Writes and reads one tag's payload.  ``state``: a nested dict of
    tensors (the training engine's named buffers)."""

    def __init__(self, config_params=None):
        self._staging = {}   # keystr -> host tensor, reused across calls
        self.last_timing = {}

    def create(self, tag):
        log_dist(f"checkpoint tag {tag}", ranks=[0])

    def _host(self, key, like):
        """The host buffer for ``key``, shaped like ``like``: pinned when
        ``like`` lives on the card, kept for later saves and loads."""
        buf = self._staging.get(key)
        pin = like.device.type == "cuda"
        if buf is None or buf.shape != like.shape or \
                buf.dtype != like.dtype or buf.is_pinned() != pin:
            self._staging.pop(key, None)
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=pin)
            self._staging[key] = buf
        return buf

    def release(self):
        """Drop the host buffers (the next save or load allocates them
        anew)."""
        self.wait()
        self._staging = {}

    def _stage(self, state):
        """Copy every leaf of ``state`` to its host buffer; returns
        ``[(keystr, host tensor)]`` once the copies are done."""
        staged, on_card = [], False
        for key, leaf in flatten_with_keystr(state):
            host = self._host(key, leaf)
            host.copy_(leaf.detach(), non_blocking=True)
            on_card = on_card or leaf.device.type == "cuda"
            staged.append((key, host))
        if on_card:
            torch.cuda.synchronize()
        return staged

    @staticmethod
    def _write_files(path, staged):
        for key, host in staged:
            np.save(os.path.join(path, buffer_file(key)), host.numpy(),
                    allow_pickle=False)

    @staticmethod
    def _write_json(path, name, obj):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f, default=str)

    def save(self, state, save_dir, tag, client_state=None, layout=None):
        """Write ``state`` as tag ``tag`` under ``save_dir``; ``layout``:
        the engine's description of its flat buffers (``layout.json``).
        Returns the staged host copies (``[(keystr, tensor)]``)."""
        self.wait()
        t0 = time.perf_counter()
        path = os.path.join(os.path.abspath(save_dir), tag)
        os.makedirs(path, exist_ok=True)
        staged = self._stage(state)
        t_staged = time.perf_counter()
        layout = dict(layout or {}, format=PAYLOAD_FORMAT,
                      version=PAYLOAD_VERSION,
                      buffers={k: {"file": buffer_file(k),
                                   "shape": list(h.shape),
                                   "dtype": str(h.numpy().dtype)}
                               for k, h in staged})
        self._write_json(path, LAYOUT_NAME, layout)
        if client_state is not None:
            self._write_json(path, CLIENT_STATE_NAME, client_state)
        nbytes = sum(h.numel() * h.element_size() for _, h in staged)
        self.last_timing = {"bytes": nbytes, "staged_s": t_staged - t0}
        self._write_payload(path, staged, t0)
        return staged

    @abstractmethod
    def _write_payload(self, path, staged, t0):
        ...

    def load(self, state, load_dir, tag, keys=None):
        """Read tag ``tag``'s buffers into host tensors shaped like the
        leaves of ``state`` (only the keystrs in ``keys`` when given).
        Returns ``(host state as a nested dict, client_state)``; nothing of
        ``state`` is written."""
        self.wait()
        t0 = time.perf_counter()
        path = os.path.join(os.path.abspath(load_dir), tag)
        flat = {}
        for key, leaf in flatten_with_keystr(state):
            if keys is not None and key not in keys:
                continue
            host = self._host(key, leaf)
            read_npy_into(os.path.join(path, buffer_file(key)), host)
            flat[key] = host
        client_state = {}
        cs_path = os.path.join(path, CLIENT_STATE_NAME)
        if os.path.exists(cs_path):
            with open(cs_path) as f:
                client_state = json.load(f)
        nbytes = sum(h.numel() * h.element_size() for h in flat.values())
        self.last_timing = {"bytes": nbytes,
                            "read_s": time.perf_counter() - t0}
        return unflatten(flat, state), broadcast_client_state(client_state)

    def wait(self):
        """Block until a background write is done (re-raising its
        error)."""

    def commit(self, tag):
        self.wait()
        return True


class SyncCheckpointEngine(CheckpointEngine):
    """Writes the payload before ``save`` returns."""

    def _write_payload(self, path, staged, t0):
        self._write_files(path, staged)
        self.last_timing["written_s"] = time.perf_counter() - t0


class AsyncCheckpointEngine(CheckpointEngine):
    """Nebula-style: ``save`` returns once the buffers are on the host; a
    background thread writes the files and ``commit`` (or the next save
    or load) waits for it."""

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._thread = None
        self._error = None

    def _write_payload(self, path, staged, t0):
        def run():
            try:
                self._write_files(path, staged)
                self.last_timing["written_s"] = time.perf_counter() - t0
            except BaseException as exc:   # re-raised by wait()
                self._error = exc
        self._thread = threading.Thread(target=run, name="ds-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc


def broadcast_client_state(client_state):
    """Rank 0's ``client_state`` on every rank: the identity at world size
    1 (the multi-rank broadcast is ROADMAP A8)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        raise NotImplementedError("client_state broadcast over ranks is not "
                                  "ported yet (ROADMAP A8)")
    return client_state


_ENGINE_NAMES = {
    "sync": SyncCheckpointEngine,
    "orbax": SyncCheckpointEngine,
    "torch": SyncCheckpointEngine,
    "async": AsyncCheckpointEngine,
    "nebula": AsyncCheckpointEngine,
}

_engine = None


def _engine_cls_from_config(config_params):
    name = "sync"
    if hasattr(config_params, "checkpoint_config"):   # DeepSpeedConfig
        name = getattr(config_params.checkpoint_config, "engine", "sync")
    elif isinstance(config_params, dict):
        name = config_params.get("checkpoint", {}).get("engine", "sync")
    cls = _ENGINE_NAMES.get(str(name).lower())
    if cls is None:
        logger.warning(f"unknown checkpoint engine {name!r}; using sync")
        cls = SyncCheckpointEngine
    return cls


def get_checkpoint_engine(config_params=None):
    """The process-wide checkpoint engine, as in the JAX package: with
    ``config_params`` (a DeepSpeedConfig or a config dict) the class comes
    from ``checkpoint.engine`` and the cached engine is rebuilt when the
    requested class differs; with none, the current engine (or a sync
    one)."""
    global _engine
    if config_params is not None:
        cls = _engine_cls_from_config(config_params)
        if type(_engine) is not cls:
            if _engine is not None:
                _engine.release()
            _engine = cls(config_params)
    elif _engine is None:
        _engine = SyncCheckpointEngine(config_params)
    return _engine
