"""Fault-tolerance layer: durable checkpoints, retries, preemption handling,
divergence detection and a deterministic fault-injection harness.

Counterpart of ``deepspeed_tpu/runtime/resilience.py``, whose on-disk
protocol it keeps bit for bit, so that either package's tools read the
other's tag directories:

* **Durable checkpoints** -- :class:`CheckpointTransaction` writes a tag
  into the dot-prefixed sibling ``.{tag}.tmp``, then writes
  ``ds_manifest.json`` (self-digested: sha256 over its canonical JSON) and
  the ``.ds_commit`` marker carrying that digest, fsyncs the tree and
  renames it into place.  :func:`validate_tag` classifies a tag as
  committed / no_marker / bad_manifest / partial / legacy / missing.
* **Retry with exponential backoff and seeded jitter** --
  :class:`RetryPolicy` draws its jitter from ``random.Random(0xD5)``, the
  JAX package's stream, so both give the same delays; :func:`retry_io`.
* **Preemption** -- :class:`PreemptionHandler` turns SIGTERM / SIGINT into
  a flag the engine polls at step boundaries.
* **Divergence sentinel** -- :class:`DivergenceSentinel` takes the loss
  and the overflow flag as device tensors and reads them back in ONE copy
  every ``interval`` steps, so it adds no per-step synchronisation.
* **Fault injection** -- :class:`FaultInjector`, every site of the JAX
  package's frozen list, and :func:`poison_tree` over torch tensors.

Where the JAX payload is an orbax tree, the port's is its named state
buffers (``runtime/checkpoint_engine.py``): a manifest leaf's ``path`` is
the JAX ``keystr`` of the buffer's place in a nested dict
(``['loss_scale']['cur_scale']``) and its ``dtype`` the numpy name.

The port has no telemetry plane yet (ROADMAP A17): every function takes
``telemetry=None`` and, without one, logs.  The event names the JAX
package emits are frozen here in :data:`FAULT_EVENTS` and
:data:`CKPT_EVENTS` for A17 to wire in.
"""

import hashlib
import json
import os
import random
import shutil
import signal
import threading
import time
import zlib

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

# on-disk protocol names (the JAX package's docs/resilience.md layout)
COMMIT_MARKER = ".ds_commit"
MANIFEST_NAME = "ds_manifest.json"
TMP_SUFFIX = ".tmp"
MANIFEST_VERSION = 1

# tag-dir validation statuses
COMMITTED = "committed"      # marker + manifest present and consistent
NO_MARKER = "no_marker"      # manifest but no (or torn) commit marker
BAD_MANIFEST = "bad_manifest"  # unparseable / digest-mismatched manifest
PARTIAL = "partial"          # manifest-listed payload missing or truncated
LEGACY = "legacy"            # pre-resilience checkpoint (no protocol files)
MISSING = "missing"          # no such tag directory

# the frozen event vocabulary of the JAX package's telemetry (``fault``
# kind, then ``meta`` kind), emitted here only when a telemetry object is
# passed in
FAULT_EVENTS = ("fault/retry", "fault/preempt_requested", "fault/preempted",
                "fault/divergence", "fault/auto_restore",
                "fault/ckpt_fallback")
CKPT_EVENTS = ("ckpt/gc", "ckpt/committed")


def fault_event(telemetry, name, step=None, attrs=None):
    """One ``fault`` event through ``telemetry`` when given, else a log
    line."""
    assert name in FAULT_EVENTS, name
    if telemetry is not None:
        telemetry.fault(name, step=step, attrs=attrs or {})
    else:
        logger.info(f"{name} step={step} {attrs or {}}")


def meta_event(telemetry, name, attrs=None):
    """One ``meta`` event through ``telemetry`` when given, else a log
    line."""
    assert name in CKPT_EVENTS, name
    if telemetry is not None:
        telemetry.emit("meta", name, attrs=attrs or {})
    else:
        logger.info(f"{name} {attrs or {}}")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint tag failed validation (marker / manifest / payload)."""


class TrainingPreempted(RuntimeError):
    """Raised at a step boundary after a preemption signal was handled
    (emergency checkpoint written)."""


class DivergenceError(RuntimeError):
    """Raised when the divergence sentinel trips and the configured action
    is ``halt`` (or auto-restore is impossible)."""


# ----------------------------------------------------------------------
# retry with exponential backoff + jitter
# ----------------------------------------------------------------------
class RetryPolicy:
    """Exponential backoff with deterministic jitter (the JAX package's
    seed, so a faulted run sleeps the same delays in both).  ``sleep_fn``
    is injectable for tests."""

    def __init__(self, max_retries=3, backoff_secs=0.5, backoff_max_secs=30.0,
                 jitter=0.25, sleep_fn=time.sleep, seed=0xD5):
        self.max_retries = max(0, int(max_retries))
        self.backoff_secs = float(backoff_secs)
        self.backoff_max_secs = float(backoff_max_secs)
        self.jitter = float(jitter)
        self.sleep_fn = sleep_fn
        self._rng = random.Random(seed)

    @classmethod
    def from_config(cls, rc, sleep_fn=time.sleep):
        return cls(max_retries=rc.max_retries,
                   backoff_secs=rc.retry_backoff_secs,
                   backoff_max_secs=rc.retry_backoff_max_secs,
                   jitter=rc.retry_jitter, sleep_fn=sleep_fn)

    def delay(self, attempt):
        """Backoff for retry ``attempt`` (1-based): ``base * 2^(a-1)``
        capped at ``backoff_max_secs``, stretched by up to ``jitter``."""
        base = min(self.backoff_max_secs,
                   self.backoff_secs * (2.0 ** (attempt - 1)))
        return base * (1.0 + self.jitter * self._rng.random())


def retry_io(fn, policy, telemetry=None, op="io", injector=None, site=None,
             cleanup=None):
    """Run ``fn`` with bounded retries under ``policy``.  ``injector`` /
    ``site`` put the fault injector in front of every attempt (configured
    failures are consumed by the retries, as a flaky filesystem's would
    be); ``cleanup`` runs after every failed attempt, the last included."""
    attempt = 0
    while True:
        try:
            if injector is not None and site is not None:
                injector.check(site)
            return fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:
            attempt += 1
            if cleanup is not None:
                try:
                    cleanup()
                except Exception as ce:
                    logger.warning(f"{op}: cleanup after failure raised {ce}")
            if attempt > policy.max_retries:
                logger.error(f"{op}: failed after {policy.max_retries} "
                             f"retries: {exc!r}")
                raise
            delay = policy.delay(attempt)
            logger.warning(f"{op}: attempt {attempt}/{policy.max_retries} "
                           f"failed ({exc!r}); retrying in {delay:.2f}s")
            fault_event(telemetry, "fault/retry",
                        attrs={"op": op, "attempt": attempt,
                               "max_retries": policy.max_retries,
                               "error": repr(exc)[:200],
                               "delay_s": round(delay, 3)})
            if delay > 0:
                policy.sleep_fn(delay)


# ----------------------------------------------------------------------
# deterministic fault injection
# ----------------------------------------------------------------------
_EXC_TABLE = {
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "CheckpointCorruptError": CheckpointCorruptError,
}

# the JAX package's frozen site list (``check`` on any other name counts
# and never fires).  The port consults ckpt_save, ckpt_load and fs
# (training checkpoints) and serve_step, serve_sample and page_alloc
# (serving); dataloader_next waits for the prefetcher (ROADMAP A17), the
# fleet and wire sites for the fleet (A11).
FAULT_SITES = ("ckpt_save", "ckpt_load", "fs", "dataloader_next",
               "serve_step", "serve_sample", "page_alloc",
               "replica_kill", "route_dispatch",
               "page_migrate", "migrate_commit",
               "wire_send", "wire_recv", "wire_delay", "rpc_timeout")


class FaultInjector:
    """Deterministic, config- and test-driven fault injection.

    Spec (the ``resilience.fault_injection`` block)::

        {"ckpt_save": {"fail_times": 2, "exc": "OSError"},
         "fs":        {"delay_secs": 0.01},
         "poison_grads_at": [5]}

    Each site keeps a 0-based invocation counter: ``fail_times: N`` fails
    the first N calls, ``fail_at: [i, ...]`` the calls with those indices,
    ``delay_secs`` sleeps before every call, ``exc`` / ``msg`` name the
    exception and its message.  ``poison_grads_at`` lists engine steps
    whose gradients are poisoned (float batch inputs, else the weights the
    step computes with, NaN-filled).  The counters are lock-protected.
    """

    def __init__(self, spec=None):
        spec = dict(spec or {})
        self.poison_steps = set(int(s) for s in
                                spec.pop("poison_grads_at", []) or [])
        self._spec = {site: dict(cfg) for site, cfg in spec.items()}
        self._lock = threading.Lock()
        self._counts = {}
        self._poisoned = set()

    @classmethod
    def from_config(cls, fault_injection):
        if not fault_injection:
            return None
        return cls(fault_injection)

    def calls(self, site):
        with self._lock:
            return self._counts.get(site, 0)

    def check(self, site):
        """Consume one invocation of ``site``; sleeps and/or raises per the
        spec.  Unknown sites count but never fire."""
        cfg = self._spec.get(site)
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
        if not cfg:
            return
        delay = float(cfg.get("delay_secs", 0) or 0)
        if delay > 0:
            time.sleep(delay)
        fail = idx < int(cfg.get("fail_times", 0) or 0)
        if idx in set(cfg.get("fail_at", []) or []):
            fail = True
        if fail:
            exc_cls = _EXC_TABLE.get(str(cfg.get("exc", "OSError")), OSError)
            raise exc_cls(cfg.get("msg",
                                  f"injected fault at {site}[{idx}]"))

    def poison_grads(self, step):
        """True exactly once for each step listed in ``poison_grads_at``."""
        step = int(step)
        with self._lock:
            if step in self.poison_steps and step not in self._poisoned:
                self._poisoned.add(step)
                return True
        return False

    def reset(self):
        with self._lock:
            self._counts = {}
            self._poisoned = set()


def poison_tree(tree):
    """NaN-fill every floating leaf of ``tree`` (dicts, lists and tuples of
    torch tensors or numpy arrays), in place for tensors.  Returns
    ``(tree, n_leaves_poisoned)``."""
    count = 0

    def visit(x):
        nonlocal count
        if isinstance(x, dict):
            return {k: visit(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(visit(v) for v in x)
        if torch.is_tensor(x) and x.is_floating_point():
            count += 1
            with torch.no_grad():
                return x.fill_(float("nan"))
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            count += 1
            return np.full_like(x, np.nan)
        return x
    out = visit(tree)
    return out, count


# ----------------------------------------------------------------------
# named leaves (the JAX keystr of a nested dict)
# ----------------------------------------------------------------------
def keystr(path):
    """``jax.tree_util.keystr`` of a path of dict keys / sequence
    indices: ``('loss_scale', 'cur_scale')`` -> ``['loss_scale']
    ['cur_scale']``."""
    return "".join(f"[{k!r}]" for k in path)


def flatten_with_keystr(tree, prefix=()):
    """``[(keystr, leaf)]`` in the JAX flattening order (dict keys sorted,
    sequences in order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_keystr(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_keystr(v, prefix + (i,))
        return out
    return [(keystr(prefix), tree)]


def dtype_name(x):
    """The numpy name of a tensor's or array's dtype (``float32``)."""
    if torch.is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    return str(getattr(x, "dtype", type(x).__name__))


def host_bytes(x):
    """A contiguous host numpy view of ``x``'s bytes (a device tensor is
    copied to the host first)."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.device.type != "cpu":
            x = x.cpu()
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.ascontiguousarray(np.asarray(x))


def leaf_crc32(leaf):
    """crc32 of the leaf's host bytes (the JAX package's checksum)."""
    return zlib.crc32(host_bytes(leaf)) & 0xFFFFFFFF


# ----------------------------------------------------------------------
# durable checkpoint protocol
# ----------------------------------------------------------------------
def _fsync_path(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_tree(root):
    """fsync every file under ``root``, then every directory bottom-up, so
    the rename that follows publishes persisted bytes."""
    for dirpath, _, filenames in os.walk(root, topdown=False):
        for fn in filenames:
            try:
                _fsync_path(os.path.join(dirpath, fn))
            except OSError:
                pass
        try:
            _fsync_path(dirpath)
        except OSError:
            pass


def atomic_write_text(path, text, fsync=True):
    """Write ``text`` to ``path`` through a tmp file and an atomic rename
    (the ``latest`` pointer is never seen half-written)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        try:
            _fsync_path(os.path.dirname(os.path.abspath(path)))
        except OSError:
            pass


def _manifest_digest(body):
    """sha256 over the canonical JSON of the manifest body (the digest
    field excluded)."""
    data = {k: v for k, v in body.items() if k != "digest"}
    blob = json.dumps(data, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _leaf_entries(state, checksum=False):
    """Manifest leaf records of ``state`` (a nested dict of tensors or
    arrays): keystr path, shape, dtype and, on request, the crc32 of the
    host bytes (a copy to the host per device leaf: the cost
    ``resilience.checksum`` asks for)."""
    entries = []
    for path, leaf in flatten_with_keystr(state):
        rec = {"path": path, "shape": list(np.shape(leaf)),
               "dtype": dtype_name(leaf)}
        if checksum:
            rec["crc32"] = leaf_crc32(leaf)
        entries.append(rec)
    return entries


def build_manifest(state, tag, global_step, checksum=False, extra=None):
    """The manifest body (the payload file list is added at commit, when
    the payload is on disk)."""
    body = {"version": MANIFEST_VERSION,
            "tag": str(tag),
            "global_step": int(global_step),
            "created": round(time.time(), 6),
            "leaves": _leaf_entries(state, checksum=checksum),
            "checksum": bool(checksum)}
    if extra:
        body.update(extra)
    return body


def _payload_files(tag_dir):
    """Relative paths and sizes of everything in the tag dir except the
    protocol files themselves."""
    skip = {COMMIT_MARKER, MANIFEST_NAME}
    files = []
    for dirpath, _, filenames in os.walk(tag_dir):
        for fn in filenames:
            rel = os.path.relpath(os.path.join(dirpath, fn), tag_dir)
            if rel in skip:
                continue
            files.append({"path": rel,
                          "bytes": os.path.getsize(
                              os.path.join(dirpath, fn))})
    files.sort(key=lambda f: f["path"])
    return files


class CheckpointTransaction:
    """Write-to-tmp -> fsync -> marker -> atomic rename for one tag.

    Writers target ``tmp_tag``, a dot-prefixed sibling directory that tag
    scans skip.  ``commit()`` records the payload files and sizes in the
    manifest, writes ``ds_manifest.json`` and the ``.ds_commit`` marker
    carrying its digest, fsyncs the tree and renames ``.{tag}.tmp`` to
    ``{tag}``.  A crash at any point leaves the previous committed tag
    intact or an ignorable tmp dir.  ``barrier_fn`` brackets the steps
    across ranks (world size 1 here: ROADMAP A8).
    """

    def __init__(self, save_dir, tag, is_coordinator=True, barrier_fn=None,
                 fsync=True):
        self.save_dir = os.path.abspath(save_dir)
        self.tag = str(tag)
        self.tmp_tag = f".{self.tag}{TMP_SUFFIX}"
        self.is_coordinator = is_coordinator
        self.barrier_fn = barrier_fn
        self.fsync = fsync

    @property
    def tmp_path(self):
        return os.path.join(self.save_dir, self.tmp_tag)

    @property
    def final_path(self):
        return os.path.join(self.save_dir, self.tag)

    def begin(self):
        """Clear a stale tmp dir of a failed attempt and make a fresh
        one."""
        if self.is_coordinator:
            if os.path.isdir(self.tmp_path):
                shutil.rmtree(self.tmp_path, ignore_errors=True)
            os.makedirs(self.tmp_path, exist_ok=True)
        if self.barrier_fn is not None:
            self.barrier_fn()
        return self

    def commit(self, manifest):
        """Publish the tmp dir as ``tag``.  ``manifest`` is the body from
        :func:`build_manifest`; the payload file list is added here."""
        if self.barrier_fn is not None:
            self.barrier_fn()
        if self.is_coordinator:
            manifest = dict(manifest)
            manifest["files"] = _payload_files(self.tmp_path)
            manifest["digest"] = _manifest_digest(manifest)
            with open(os.path.join(self.tmp_path, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            with open(os.path.join(self.tmp_path, COMMIT_MARKER), "w") as f:
                f.write(manifest["digest"])
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            if self.fsync:
                fsync_tree(self.tmp_path)
            # replacing an existing tag: move it aside first (os.replace
            # cannot swap non-empty directories atomically)
            if os.path.isdir(self.final_path):
                old = f"{self.final_path}.replaced.{os.getpid()}"
                os.replace(self.final_path, old)
                shutil.rmtree(old, ignore_errors=True)
            os.replace(self.tmp_path, self.final_path)
            if self.fsync:
                try:
                    _fsync_path(self.save_dir)
                except OSError:
                    pass
        if self.barrier_fn is not None:
            self.barrier_fn()
        return self.final_path

    def abort(self):
        """Remove the tmp dir (between retries and on final failure)."""
        if self.is_coordinator and os.path.isdir(self.tmp_path):
            shutil.rmtree(self.tmp_path, ignore_errors=True)


def validate_tag(tag_dir):
    """Classify one tag directory: ``(status, manifest_or_None)``.
    :data:`COMMITTED` means marker and manifest agree and every
    manifest-listed payload file exists at its recorded size."""
    if not os.path.isdir(tag_dir):
        return MISSING, None
    marker_path = os.path.join(tag_dir, COMMIT_MARKER)
    manifest_path = os.path.join(tag_dir, MANIFEST_NAME)
    has_marker = os.path.exists(marker_path)
    has_manifest = os.path.exists(manifest_path)
    if not has_marker and not has_manifest:
        return LEGACY, None
    if not has_manifest:
        return BAD_MANIFEST, None
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("digest") != _manifest_digest(manifest):
            return BAD_MANIFEST, None
    except (ValueError, OSError):
        return BAD_MANIFEST, None
    if not has_marker:
        return NO_MARKER, manifest
    try:
        with open(marker_path) as f:
            marker_digest = f.read().strip()
    except OSError:
        return NO_MARKER, manifest
    if marker_digest != manifest.get("digest"):
        return NO_MARKER, manifest
    for rec in manifest.get("files", []):
        p = os.path.join(tag_dir, rec["path"])
        if not os.path.exists(p) or os.path.getsize(p) != rec["bytes"]:
            return PARTIAL, manifest
    return COMMITTED, manifest


def scan_tags(root):
    """Every non-tmp tag dir under ``root`` with its status,
    ``[(tag, status, manifest)]``, newest first (manifest ``global_step``
    descending, then mtime descending)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        path = os.path.join(root, name)
        if name.startswith(".") or not os.path.isdir(path):
            continue
        status, manifest = validate_tag(path)
        out.append((name, status, manifest))

    def key(item):
        step = (item[2] or {}).get("global_step", -1)
        try:
            mtime = os.path.getmtime(os.path.join(root, item[0]))
        except OSError:
            mtime = 0.0
        return (step, mtime)
    out.sort(key=key, reverse=True)
    return out


def verify_restored(state, manifest):
    """Per-leaf checksum check of a restored ``state`` against the
    manifest (only when it carries checksums); raises
    :class:`CheckpointCorruptError` at the first mismatch."""
    if not manifest or not manifest.get("checksum"):
        return True
    by_path = {r["path"]: r for r in manifest.get("leaves", [])}
    for key, leaf in flatten_with_keystr(state):
        rec = by_path.get(key)
        if rec is None or "crc32" not in rec:
            continue
        got = leaf_crc32(leaf)
        if got != rec["crc32"]:
            raise CheckpointCorruptError(
                f"leaf {key}: checksum mismatch (manifest "
                f"{rec['crc32']:#010x}, restored {got:#010x})")
    return True


def gc_tags(root, keep_last, protect=(), telemetry=None):
    """Retention: keep the newest ``keep_last`` COMMITTED tags and delete
    the rest, and stale tmp dirs.  Tags that are not committed are never
    deleted (they are evidence; ``checkpoint/fsck`` reports them); tags in
    ``protect`` are always kept."""
    if keep_last <= 0:
        return []
    removed = []
    committed = [t for t, s, _ in scan_tags(root) if s == COMMITTED]
    for tag in committed[keep_last:]:
        if tag in protect:
            continue
        shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
        removed.append(tag)
        logger.info(f"checkpoint GC: removed {tag} (keep_last={keep_last})")
    for name in os.listdir(root):
        if name.startswith(".") and name.endswith(TMP_SUFFIX):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    if removed:
        meta_event(telemetry, "ckpt/gc",
                   {"removed": removed, "keep_last": keep_last})
    return removed


# ----------------------------------------------------------------------
# preemption handling
# ----------------------------------------------------------------------
class PreemptionHandler:
    """SIGTERM / SIGINT -> a flag the engine polls at step boundaries.

    The handler only sets the flag and logs; the engine writes the
    emergency checkpoint at the next boundary.  A second signal restores
    the previous handlers and re-delivers itself, so a double Ctrl-C still
    kills the process."""

    def __init__(self, telemetry=None, signals=(signal.SIGTERM,
                                                signal.SIGINT)):
        self.telemetry = telemetry
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._prev = {}
        self._installed = False

    def install(self):
        try:
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            self._installed = True
        except ValueError:
            # signal.signal works only in the main thread: manual
            # request() only
            logger.warning("preemption handler: not in main thread; "
                           "signals not hooked (manual request() only)")
        return self

    def uninstall(self):
        if self._installed:
            for sig, prev in self._prev.items():
                try:
                    signal.signal(sig, prev)
                except (ValueError, TypeError):
                    pass
            self._prev = {}
            self._installed = False

    def _on_signal(self, signum, frame):
        if self._requested.is_set():
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.request(signum=signum)

    def request(self, signum=None):
        """Flag a preemption (the signal handler, or a test)."""
        self._requested.set()
        logger.warning(
            f"preemption requested (signal={signum}); emergency checkpoint "
            "at the next step boundary")
        if self.telemetry is not None:
            fault_event(self.telemetry, "fault/preempt_requested",
                        attrs={"signal": int(signum)
                               if signum is not None else None})

    @property
    def requested(self):
        return self._requested.is_set()

    def clear(self):
        self._requested.clear()


# ----------------------------------------------------------------------
# divergence sentinel
# ----------------------------------------------------------------------
def _host_values(refs):
    """Python floats of ``refs`` (0-dim tensors, numpy or Python scalars)
    with ONE device-to-host copy for the device tensors among them."""
    out = [None] * len(refs)
    dev_idx = [i for i, r in enumerate(refs)
               if torch.is_tensor(r) and r.device.type != "cpu"]
    if dev_idx:
        stacked = torch.stack([refs[i].detach().reshape(()).double()
                               for i in dev_idx]).cpu().tolist()
        for i, v in zip(dev_idx, stacked):
            out[i] = v
    for i, r in enumerate(refs):
        if out[i] is None:
            out[i] = float(r.item() if torch.is_tensor(r) else np.asarray(r))
    return out


class DivergenceSentinel:
    """Non-finite loss or K consecutive fp16 overflow skips -> trip.

    The engine ``push()``es each step's loss and overflow flag as device
    tensors (no sync); once ``interval`` are pending, ``poll()`` copies
    them to the host in one transfer and evaluates them in order.
    ``poll()`` returns the configured action ("halt" / "restore") once
    per trip."""

    def __init__(self, max_consecutive_skips=0, check_nonfinite=True,
                 interval=1, action="halt", telemetry=None):
        self.max_consecutive_skips = int(max_consecutive_skips)
        self.check_nonfinite = bool(check_nonfinite)
        self.interval = max(1, int(interval))
        self.action = action
        self.telemetry = telemetry
        self._pending = []      # [(step, loss_or_None, overflow_or_None)]
        self._skip_streak = 0
        self.tripped = False
        self.reason = None
        self.trip_step = None
        self._delivered = False

    def push(self, step, loss=None, overflow=None):
        if self.tripped:
            return
        self._pending.append((int(step), loss, overflow))

    def _evaluate(self, step, loss_f, overflow_b):
        if overflow_b is not None and self.max_consecutive_skips > 0:
            self._skip_streak = self._skip_streak + 1 if overflow_b else 0
            if self._skip_streak >= self.max_consecutive_skips:
                self._trip(step, "overflow_streak",
                           {"consecutive_skips": self._skip_streak})
                return
        if self.check_nonfinite and loss_f is not None and \
                not np.isfinite(loss_f):
            self._trip(step, "nonfinite_loss", {"loss": repr(loss_f)})

    def _trip(self, step, reason, attrs):
        self.tripped = True
        self.reason = reason
        self.trip_step = int(step)
        logger.error(f"divergence sentinel tripped at step {step}: {reason} "
                     f"{attrs} (action={self.action})")
        fault_event(self.telemetry, "fault/divergence", step=int(step),
                    attrs=dict(attrs, reason=reason, action=self.action))

    def poll(self, force=False):
        """Fetch and evaluate the pending observations when due.  Returns
        the action exactly once after a trip, else None."""
        if not self.tripped and self._pending and \
                (force or len(self._pending) >= self.interval):
            batch, self._pending = self._pending, []
            refs = [v for _, loss, ovf in batch for v in (loss, ovf)
                    if v is not None]
            host = iter(_host_values(refs))
            for step, loss, ovf in batch:
                loss_f = float(next(host)) if loss is not None else None
                ovf_b = bool(next(host)) if ovf is not None else None
                self._evaluate(step, loss_f, ovf_b)
                if self.tripped:
                    break
        if self.tripped and not self._delivered:
            self._delivered = True
            return self.action
        return None

    def reset(self):
        """Re-arm after a successful auto-restore."""
        self._pending = []
        self._skip_streak = 0
        self.tripped = False
        self.reason = None
        self.trip_step = None
        self._delivered = False
