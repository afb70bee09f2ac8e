"""Preemption-safe training and transient-fault retry (counterpart of
`mxnet_tpu/resilience.py`).

  * **atomic verified checkpoints** — `write_checkpoint(directory,
    writer, step, fingerprint)` lets `writer(tmpdir)` write the payload
    into `<directory>.tmp-<pid>`, adds a `manifest.json` with each
    file's size and CRC32, the step and the caller's fingerprint,
    fsyncs, and renames the directory into place (an existing
    checkpoint there is moved aside to `<directory>.tmp-old` first and
    removed after; `_recover_displaced` puts it back after a crash
    between the two renames). A kill mid-save leaves a `*.tmp-*`
    directory that nothing lists. `verify_checkpoint` re-checks sizes
    and checksums (`CheckpointCorruptError`), `check_fingerprint`
    rejects a checkpoint of another trainer (`MeshMismatchError`).
  * **CheckpointManager** — keep-last-N checkpoints of one trainer under
    `base_dir/step_<n>`; `restore_latest` walks newest to oldest and
    falls back past corrupt ones. `manager_for`, `on_trainer_init`
    (auto-resume under the `resume` knob) and `on_step` (periodic save,
    fault injection, the preemption exit) are the trainer's hooks.
  * **graceful preemption** — `install()` registers a SIGTERM/SIGINT
    handler that only sets a flag; the trainer finishes the in-flight
    step, saves, and raises `PreemptedExit` with `EXIT_PREEMPTED` (83).
    A failed final save exits 128 + the signal instead
    (`_finalize_preemption`). A second signal restores the previous
    handlers and re-delivers itself.
  * **RetryPolicy** — exponential backoff + jitter + retryable-exception
    classification, copied from the JAX package. The server runs every
    batched dispatch under one; `CheckpointManager` every save and
    restore.
  * **fault injection** — `FaultInjector`, driven by the `fault_inject`
    knob in the JAX package's spec grammar. The trainer fires
    `sigterm@step:N` and `kill@step:N` at the step boundary,
    `oom@step:N` at the step's dispatch (`memsafe.
    SimulatedResourceExhausted`) and `corrupt_ckpt@step:N` after that
    step's checkpoint is written; serving consumes `slow_client:ms`,
    `burst:N@step:K` and `cancel@req:N` (`Server._fire_faults`). The
    other kinds of the grammar (stall_input, exc, shrink, grow, hang,
    corrupt_grad, stall_heartbeat, kill_replica, wedge_replica,
    slow_replica) parse, but no port code fires them yet.

Disabled (the default) the trainer hook is one module-bool check, no
signal handler is installed, and `ShardedTrainer.save_states` writes
its payload without a manifest. `enable()` arms the hooks and the
injector, `install()` adds the signal handlers, `uninstall()` undoes
both. The `resilience` knob installs at import.

One process: the port trains on one device, so the JAX package's
multi-host branch (the writer running against the final directory, the
manifest written by process 0) is not here. The JAX package's
telemetry, diagnostics, goodput and guard hooks, elastic reshape and
estimator checkpoints are not ported yet.
"""
from __future__ import annotations

import json
import os
import random as _pyrandom
import shutil
import signal as _signal
import sys
import threading
import time
import zlib

from . import config as _config

__all__ = [
    "enable", "disable", "enabled", "install", "uninstall", "preempted",
    "clear_preempted", "RetryPolicy", "CheckpointCorruptError",
    "MeshMismatchError", "PreemptedExit", "EXIT_PREEMPTED",
    "write_checkpoint", "verify_checkpoint", "list_checkpoints",
    "check_fingerprint", "trainer_fingerprint", "CheckpointManager",
    "manager_for", "on_trainer_init", "on_step", "FaultInjector",
    "fault_point", "restart_count", "last_resume"]

# "preempted: state saved, exiting on request": outside the shell's
# (126..128+N) and the common errno ranges, so a supervisor can tell it
# from a crash
EXIT_PREEMPTED = 83

_lock = threading.RLock()
_enabled = False          # the fast-path bool: hook sites check ONLY this
_installed = False        # signal handlers chained
_prev_handlers = {}
_preempt = {"flag": False, "signum": None}
_injector = None          # FaultInjector parsed from the fault_inject knob
_resume_info = None       # {"path", "step", "fallbacks"} of the last restore

_KINDS = ("sigterm", "kill", "corrupt_ckpt", "stall_input", "exc", "shrink",
          "grow", "oom", "hang", "corrupt_grad", "stall_heartbeat",
          "slow_client", "burst", "cancel", "kill_replica", "wedge_replica",
          "slow_replica")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification (torn write, checksum mismatch,
    missing manifest or entry). Managed restores fall back to the newest
    previous good checkpoint instead of propagating this."""


class MeshMismatchError(RuntimeError):
    """A verified checkpoint was written for another trainer than the one
    restoring it (its fingerprint differs). Carries `.mismatch` ({key:
    (checkpoint, current)})."""

    def __init__(self, message, mismatch=None):
        super().__init__(message)
        self.mismatch = dict(mismatch or {})


class PreemptedExit(SystemExit):
    """SystemExit raised after the final preemption checkpoint; carries
    EXIT_PREEMPTED so the process exit code says "saved and evicted"."""

    def __init__(self, message="", code=EXIT_PREEMPTED):
        super().__init__(code)
        self.message = message


# ---------------------------------------------------------------------------
# enable / install
# ---------------------------------------------------------------------------

def enabled():
    """True when the hooks are armed (hook sites read the module global
    `_enabled` directly; this accessor is the public spelling)."""
    return _enabled


def enable():
    """Parse the `fault_inject` knob and arm the hooks (periodic
    checkpoint, fault injection, resume) WITHOUT touching signal
    handlers: `install()` adds those."""
    global _enabled, _injector
    with _lock:
        _injector = FaultInjector.from_config()
        _enabled = True


def disable():
    global _enabled, _injector
    with _lock:
        _enabled = False
        _injector = None


def install(signals=(_signal.SIGTERM, _signal.SIGINT)):
    """`enable()` plus a preemption handler on `signals` that only sets a
    flag: the in-flight step finishes, a final checkpoint is written at
    the step boundary, and the process exits EXIT_PREEMPTED. Signal
    handlers can only be set from the main thread; elsewhere this arms
    the hooks alone. Idempotent."""
    global _installed
    enable()
    with _lock:
        if not _installed:
            for sig in signals:
                try:
                    _prev_handlers[sig] = _signal.signal(sig, _on_signal)
                except (ValueError, OSError):
                    pass           # not the main thread
            _installed = True
    return _installed


def uninstall():
    """Undo install(): restore the previous signal handlers, disarm the
    hooks, drop the preemption flag and the last resume record."""
    global _resume_info
    with _lock:
        if _installed:
            _restore_handlers()
        _resume_info = None
        clear_preempted()
    disable()


def _on_signal(signum, frame):
    # first signal: set a flag, nothing else (saving from the signal
    # frame could write half-updated state); the trainer checks it at the
    # next step boundary. A second signal restores the previous handlers
    # and re-delivers itself, so a process with no step boundary in sight
    # stays terminable.
    if _preempt["flag"]:
        print("mx.resilience: second signal — restoring default handlers "
              "and terminating without a final checkpoint", file=sys.stderr)
        _restore_handlers()
        os.kill(os.getpid(), signum)
        return
    _preempt["flag"] = True
    _preempt["signum"] = signum
    print(f"mx.resilience: signal {signum} received — finishing the "
          "in-flight step, then checkpointing and exiting "
          f"{EXIT_PREEMPTED} (send again to terminate immediately)",
          file=sys.stderr)


def _restore_handlers():
    global _installed
    for sig, h in list(_prev_handlers.items()):
        try:
            _signal.signal(sig, h if h is not None else _signal.SIG_DFL)
        except (ValueError, OSError):
            pass
    _prev_handlers.clear()
    _installed = False


def preempted():
    """True once a preemption signal arrived (sticky until
    clear_preempted(); training loops break on it)."""
    return _preempt["flag"]


def clear_preempted():
    _preempt["flag"] = False
    _preempt["signum"] = None


def restart_count():
    """How many times a supervisor has relaunched this process
    (`MXNET_TPU_RESTART_COUNT`; 0 on the first launch)."""
    try:
        return int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        return 0


def last_resume():
    """{"path", "step", "fallbacks"} of the most recent successful restore
    in this process (None before any)."""
    return dict(_resume_info) if _resume_info else None


def _process_index():
    """This process's rank without starting anything: the launcher's
    environment first, then an initialised torch.distributed group."""
    for var in ("RANK", "DMLC_WORKER_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:
            pass
    return 0


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Exponential backoff + full jitter + retryable-exception
    classification.

    `max_attempts` counts TOTAL tries (1 = no retry). A non-retryable
    exception propagates immediately; a retryable one sleeps
    `backoff_s * 2^k` (capped at `max_backoff_s`, jittered by ±`jitter`
    fraction) and tries again. `call(fn, ..., abort=...)` stops early —
    re-raising the last failure — when the abort callable turns true."""

    #: transient by default: filesystem/network hiccups and timeouts.
    #: A CUDA error is a RuntimeError and is never among them.
    DEFAULT_RETRYABLE = (OSError, ConnectionError, TimeoutError)

    def __init__(self, max_attempts=None, backoff_s=None, max_backoff_s=None,
                 jitter=0.25, retryable=None, sleep=time.sleep, rng=None):
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else _config.get("retry_max_attempts"))
        self.backoff_s = float(backoff_s if backoff_s is not None
                               else _config.get("retry_backoff_s"))
        self.max_backoff_s = float(max_backoff_s if max_backoff_s is not None
                                   else _config.get("retry_max_backoff_s"))
        self.jitter = float(jitter)
        self.retryable = tuple(retryable) if retryable is not None \
            else self.DEFAULT_RETRYABLE
        self._sleep = sleep
        self._rng = rng or _pyrandom.Random()

    def is_retryable(self, exc):
        return isinstance(exc, self.retryable)

    def delay(self, attempt):
        """Backoff before try `attempt+2` (attempt is the 0-based index of
        the try that just failed)."""
        base = min(self.backoff_s * (2.0 ** attempt), self.max_backoff_s)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, base)

    def call(self, fn, *args, site="generic", abort=None, on_retry=None,
             **kwargs):
        """Run fn(*args, **kwargs) under this policy. `on_retry(exc,
        attempt, delay)` observes each retry; `abort()` true stops the
        loop early, re-raising the last exception."""
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not self.is_retryable(e) \
                        or attempt + 1 >= self.max_attempts:
                    raise
                if abort is not None and abort():
                    raise
                delay = self.delay(attempt)
                if on_retry is not None:
                    on_retry(e, attempt, delay)
                else:
                    print(f"mx.resilience: retrying {site} after "
                          f"{type(e).__name__}: {e} (attempt "
                          f"{attempt + 2}/{self.max_attempts}, "
                          f"backoff {delay:.2f}s)", file=sys.stderr)
                self._sleep(delay)
                attempt += 1


# ---------------------------------------------------------------------------
# atomic verified checkpoints
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"
_TMP_MARK = ".tmp-"


def _file_crc(path, _bufsize=1 << 24):
    """Streaming CRC32 of one file (torn-write detection, not
    cryptography)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_bufsize)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _walk_files(root):
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            yield os.path.relpath(full, root), full


def write_checkpoint(directory, writer, step=0, fingerprint=None):
    """Atomic verified checkpoint write: `writer(tmpdir)` writes the
    payload; then a manifest.json with each file's size and CRC32, the
    step and the caller's fingerprint is written, everything is fsynced,
    and the temp directory is renamed to `directory` (an existing
    checkpoint there is replaced: moved aside first, removed after). A
    crash leaves the previous checkpoint, a recoverable `*.tmp-old`
    displacement, or an ignorable `*.tmp-<pid>` directory, never a
    half-written checkpoint that restore would trust. Returns the
    directory."""
    directory = os.path.abspath(str(directory))
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = directory + _TMP_MARK + str(os.getpid())
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        writer(tmp)
        _write_manifest(tmp, step, fingerprint)
        if os.path.exists(directory):
            # rename over a non-empty directory is not atomic: move the
            # old one aside, remove it once the new one is in place
            old = directory + _TMP_MARK + "old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(directory, old)
            os.rename(tmp, directory)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _dir_fsync(parent)
    fault_point("ckpt", step=step, path=directory)
    return directory


def _write_manifest(directory, step, fingerprint):
    manifest = {"schema": 2, "step": int(step), "ts": time.time(),
                "fingerprint": fingerprint or {}, "files": {}}
    for rel, full in _walk_files(directory):
        if rel == _MANIFEST:
            continue
        manifest["files"][rel] = {"size": os.path.getsize(full),
                                  "crc32": _file_crc(full)}
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def _recover_displaced(base_dir):
    """Undo a crash caught between write_checkpoint's two renames: a
    `step_X.tmp-old` directory whose `step_X` is missing IS the last good
    checkpoint; rename it back before anyone lists or removes any."""
    try:
        entries = os.listdir(str(base_dir))
    except (FileNotFoundError, NotADirectoryError):
        return
    suffix = _TMP_MARK + "old"
    for name in entries:
        if not (name.startswith(_STEP_PREFIX) and name.endswith(suffix)):
            continue
        final = os.path.join(str(base_dir), name[:-len(suffix)])
        if not os.path.exists(final):
            try:
                os.rename(os.path.join(str(base_dir), name), final)
                print(f"mx.resilience: recovered displaced checkpoint "
                      f"{final} (crash during a same-step rewrite)",
                      file=sys.stderr)
            except OSError:
                pass


def _dir_fsync(path):
    """fsync a directory so the rename itself is durable (best effort)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def verify_checkpoint(directory):
    """Verify a managed checkpoint: manifest present, every entry present
    with matching size and CRC32. Returns the manifest dict; raises
    CheckpointCorruptError naming the first bad file."""
    directory = str(directory)
    mpath = os.path.join(directory, _MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointCorruptError(
            f"{directory}: no {_MANIFEST} — torn write or not a managed "
            "checkpoint") from None
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"{directory}: unreadable {_MANIFEST}: {e}") from None
    for rel, info in manifest.get("files", {}).items():
        full = os.path.join(directory, rel)
        if not os.path.exists(full):
            raise CheckpointCorruptError(f"{directory}: missing file {rel}")
        size = os.path.getsize(full)
        if size != info.get("size"):
            raise CheckpointCorruptError(
                f"{directory}: {rel} is {size} bytes, manifest says "
                f"{info.get('size')}")
        crc = _file_crc(full)
        if crc != info.get("crc32"):
            raise CheckpointCorruptError(
                f"{directory}: {rel} checksum {crc:#010x} != manifest "
                f"{info.get('crc32', 0):#010x} (corrupt)")
    return manifest


def check_fingerprint(manifest, expected, directory=""):
    """Reject a checkpoint written for another trainer. Compares only the
    keys both fingerprints carry, so new fields stay compatible."""
    got = manifest.get("fingerprint") or {}
    bad = {k: (got.get(k), v) for k, v in (expected or {}).items()
           if k in got and got[k] != v}
    if bad:
        detail = ", ".join(f"{k}: checkpoint={g!r} current={c!r}"
                           for k, (g, c) in sorted(bad.items()))
        raise MeshMismatchError(
            f"checkpoint {directory or '<dir>'} was written for a different "
            f"topology ({detail}; checkpoint fingerprint {got!r}, current "
            f"{expected!r}); restore it on the original configuration",
            mismatch=bad)


def trainer_fingerprint(trainer):
    """The identity a trainer checkpoint is only valid for: the trainer
    class and its param mode (the port trains on one device: no mesh
    shape). Written into the manifest at save, compared at a verified
    restore."""
    fp = {"trainer": type(trainer).__name__}
    mode = getattr(trainer, "param_mode", None)
    if mode is not None:
        fp["param_mode"] = mode
    return fp


def list_checkpoints(base_dir):
    """Step-numbered managed checkpoints under base_dir, oldest first:
    [(step, path)]. `*.tmp-*` leftovers of killed saves are excluded."""
    out = []
    try:
        entries = os.listdir(str(base_dir))
    except (FileNotFoundError, NotADirectoryError):
        return out
    for name in entries:
        if not name.startswith(_STEP_PREFIX) or _TMP_MARK in name:
            continue
        try:
            step = int(name[len(_STEP_PREFIX):])
        except ValueError:
            continue
        out.append((step, os.path.join(str(base_dir), name)))
    return sorted(out)


class CheckpointManager:
    """Keep-last-N atomic verified checkpoints of one trainer under
    `base_dir/step_<n>`.

    `trainer` is anything with save_states / load_states / num_update
    (ShardedTrainer). Saves run under the checkpoint-I/O RetryPolicy
    through the trainer's save_states (atomic and verified while
    resilience is enabled); `restore_latest` walks newest to oldest,
    verifying checksums and the fingerprint, falling back past corrupt
    checkpoints; after each save the ones beyond `keep` are removed."""

    def __init__(self, trainer, base_dir, keep=None, policy=None):
        self.trainer = trainer
        self.base_dir = os.path.abspath(str(base_dir))
        self.keep = int(keep if keep is not None
                        else _config.get("checkpoint_keep"))
        self.policy = policy or RetryPolicy()
        self._last_saved_step = None

    def _step_dir(self, step):
        return os.path.join(self.base_dir, f"{_STEP_PREFIX}{step:010d}")

    def save(self, force=False):
        """Checkpoint the trainer's current step. Skips (returns None) if
        that step is already saved, unless `force`."""
        step = int(self.trainer.num_update)
        if not force and self._last_saved_step == step:
            return None
        path = self._step_dir(step)
        self.policy.call(self.trainer.save_states, path,
                         site="checkpoint-io")
        self._last_saved_step = step
        self._gc()
        return path

    def _gc(self):
        """Keep the newest `keep` complete checkpoints; remove older ones
        and stale tmp leftovers (killed mid-save, older than 5 minutes).
        Displaced `*.tmp-old` checkpoints are recovered first so the
        cleanup can never eat the last good copy."""
        if self.keep <= 0:
            return
        _recover_displaced(self.base_dir)
        for _step, path in list_checkpoints(self.base_dir)[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)
        try:
            for name in os.listdir(self.base_dir):
                full = os.path.join(self.base_dir, name)
                if _TMP_MARK in name and \
                        time.time() - os.path.getmtime(full) > 300:
                    shutil.rmtree(full, ignore_errors=True)
        except OSError:
            pass

    def restore_latest(self, max_step=None):
        """Restore the newest checkpoint that verifies, falling back past
        torn or corrupt ones. Returns the restored step, or None when no
        usable checkpoint exists. Checkpoints above `max_step` are
        skipped. A fingerprint mismatch raises: older checkpoints would
        mismatch the same way."""
        _recover_displaced(self.base_dir)
        fallbacks = 0
        for step, path in reversed(list_checkpoints(self.base_dir)):
            if max_step is not None and step > max_step:
                continue
            try:
                self.restore(path)
            except CheckpointCorruptError as e:
                fallbacks += 1
                print(f"mx.resilience: rejecting checkpoint: {e} — "
                      "falling back to the previous one", file=sys.stderr)
                continue
            _note_resume(path, step, fallbacks)
            return step
        return None

    def restore(self, path):
        """Verify and load one checkpoint directory. While resilience is
        enabled the trainer's load_states verifies (checksums once); used
        standalone, the manager verifies here."""
        if not os.path.exists(os.path.join(str(path), _MANIFEST)):
            raise CheckpointCorruptError(
                f"{path}: no {_MANIFEST} — torn write or not a managed "
                "checkpoint")
        if not _enabled:
            manifest = verify_checkpoint(path)
            check_fingerprint(manifest, trainer_fingerprint(self.trainer),
                              str(path))
        self.policy.call(self.trainer.load_states, path,
                         site="checkpoint-io")
        self._last_saved_step = int(self.trainer.num_update)
        return path

    def last_saved_path(self):
        """Path of this manager's most recent save (None before any)."""
        if self._last_saved_step is None:
            return None
        return self._step_dir(self._last_saved_step)


def _note_resume(path, step, fallbacks=0):
    global _resume_info
    _resume_info = {"path": path, "step": int(step),
                    "fallbacks": int(fallbacks)}
    print(f"mx.resilience: resumed from {path} (step {step}"
          + (f", {fallbacks} corrupt checkpoint(s) skipped" if fallbacks
             else "") + ")", file=sys.stderr)


# ---------------------------------------------------------------------------
# trainer hooks (ShardedTrainer calls these only while enabled)
# ---------------------------------------------------------------------------

def manager_for(trainer, base_dir=None):
    """Get or create the CheckpointManager of a trainer (None when no
    checkpoint directory is configured). Kept ON the trainer, so the
    manager lives exactly as long as the trainer."""
    base_dir = base_dir or _config.get("checkpoint_dir")
    if not base_dir:
        return None
    mgr = getattr(trainer, "_resilience_mgr", None)
    if mgr is None or os.path.abspath(str(base_dir)) != mgr.base_dir:
        mgr = CheckpointManager(trainer, base_dir)
        trainer._resilience_mgr = mgr
    return mgr


def on_trainer_init(trainer):
    """Called at ShardedTrainer construction while enabled: auto-resume
    per the `resume` knob ("auto": the newest verified checkpoint under
    checkpoint_dir; a path: that checkpoint, verified). Returns the
    restored step or None."""
    resume = _config.get("resume")
    if not resume:
        return None
    if not getattr(trainer, "_ready", True):
        print("mx.resilience: trainer has deferred-shape parameters — "
              "auto-resume skipped (run one step, then load_states "
              "explicitly)", file=sys.stderr)
        return None
    if resume == "auto":
        mgr = manager_for(trainer)
        if mgr is None:
            return None
        return mgr.restore_latest()
    mgr = CheckpointManager(trainer, os.path.dirname(
        os.path.abspath(resume)) or ".")
    mgr.restore(resume)
    _note_resume(resume, int(trainer.num_update))
    return int(trainer.num_update)


def on_step(trainer):
    """The per-step hook (called only while enabled): the periodic
    checkpoint FIRST (so a same-step fault resumes past itself), then
    fault injection, then the preemption flag: the in-flight step has
    finished, so write a final checkpoint and exit EXIT_PREEMPTED."""
    step = int(trainer.num_update)
    mgr = manager_for(trainer)
    every = _config.get("checkpoint_every_n_steps")
    if mgr is not None and every > 0 and step % every == 0:
        mgr.save()
    if _injector is not None:
        _injector.fire("step", step=step)
    if _preempt["flag"]:
        _finalize_preemption(mgr, step)


def _finalize_preemption(mgr, step):
    signum = _preempt["signum"]
    path = None
    save_failed = False
    if mgr is not None:
        try:
            # a step the periodic hook just wrote is still THE final state
            path = mgr.save() or mgr.last_saved_path()
        except Exception as e:         # noqa: BLE001 — still exit, loudly
            save_failed = True
            print(f"mx.resilience: final preemption checkpoint failed: {e}",
                  file=sys.stderr)
    if save_failed:
        # EXIT_PREEMPTED means "state saved": a failed final save exits
        # with the fatal-signal code instead
        code = 128 + int(signum or _signal.SIGTERM)
        print(f"mx.resilience: preempted (signal {signum}) but the final "
              f"checkpoint FAILED — exiting {code}, resume will use the "
              "last periodic checkpoint", file=sys.stderr)
        raise SystemExit(code)
    msg = (f"mx.resilience: preempted (signal {signum}) — "
           + (f"checkpoint saved at step {step} ({path}); " if path
              else "no checkpoint_dir configured; ")
           + f"exiting {EXIT_PREEMPTED}")
    print(msg, file=sys.stderr)
    raise PreemptedExit(msg)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class FaultInjector:
    """Deterministic fault injection driven by the `fault_inject` knob.

    Spec grammar (comma-separated list), as in the JAX package:
      slow_client:200       — the request STREAM consumer stalls 200 ms
                              per token (consumed by Request.stream at
                              its first read); the scheduler's
                              throughput must not care
      burst:8@step:3        — at scheduler step 3 the server fires its
                              on_burst hook with 8 — a deterministic load
                              spike driving the shed / backpressure paths
      cancel@req:2          — cancel request id 2 at the next scheduler
                              step (append @step:N to pick the step) —
                              the mid-generation cancellation drill
      sigterm@step:5        — SIGTERM to this process after step 5
                              completes (the graceful-preemption path)
      kill@step:3           — SIGKILL after step 3 (rank death)
      corrupt_ckpt@step:4   — flip a byte of the checkpoint written at
                              step 4, AFTER its manifest: restore must
                              detect it
      oom@step:3            — a synthetic out-of-memory at the dispatch
                              of step 3, before the step touches any
                              state (memsafe.SimulatedResourceExhausted):
                              repeat the spec to fail the retries too
                              and walk further rungs of the ladder
      stall_input, exc, shrink, grow, hang, corrupt_grad,
      stall_heartbeat, kill_replica, wedge_replica, slow_replica
                            — parsed, not fired by any port code yet
    Any spec may append @rank:N to fire on that rank only. Specs fire at
    most once, and only on the FIRST launch (MXNET_TPU_RESTART_COUNT=0)
    unless @every_restart is appended."""

    def __init__(self, specs):
        self._specs = list(specs)

    @classmethod
    def from_config(cls):
        raw = _config.get("fault_inject")
        if not raw:
            return None
        return cls.parse(raw)

    @classmethod
    def parse(cls, raw):
        specs = []
        for part in str(raw).split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split("@")
            kind, _, arg = fields[0].partition(":")
            spec = {"kind": kind, "arg": arg, "step": None, "rank": None,
                    "req": None, "every_restart": False, "fired": False}
            for field in fields[1:]:
                k, _, v = field.partition(":")
                if k == "step":
                    spec["step"] = int(v)
                elif k == "rank":
                    spec["rank"] = int(v)
                elif k == "req":
                    spec["req"] = int(v)
                elif k == "every_restart":
                    spec["every_restart"] = True
                else:
                    raise ValueError(
                        f"fault_inject: unknown qualifier {field!r} in "
                        f"{part!r}")
            if spec["kind"] not in _KINDS:
                raise ValueError(
                    f"fault_inject: unknown fault {spec['kind']!r} in "
                    f"{part!r} (know: {', '.join(_KINDS)})")
            specs.append(spec)
        return cls(specs)

    def _armed(self, spec, kind, rank):
        return not spec["fired"] and spec["kind"] == kind \
            and (spec["rank"] is None or spec["rank"] == rank) \
            and (spec["every_restart"] or restart_count() == 0)

    def fire(self, point, step=None, path=None):
        """Run every armed spec that matches this fault point: "step" (a
        trainer step boundary), "dispatch" (a step about to run, nothing
        touched yet) or "ckpt" (a checkpoint just written at `path`)."""
        rank = _process_index()
        for spec in self._specs:
            if not self._armed(spec, spec["kind"], rank):
                continue
            kind = spec["kind"]
            due = spec["step"] is None or step == spec["step"]
            if point == "step" and kind in ("sigterm", "kill") and due:
                spec["fired"] = True
                self._fire_process_fault(kind, step)
            elif point == "dispatch" and kind == "oom" and due:
                spec["fired"] = True
                print(f"mx.resilience: fault injection: synthetic "
                      f"out-of-memory at dispatch of step {step} (rank "
                      f"{rank})", file=sys.stderr)
                from . import memsafe as _memsafe
                raise _memsafe.SimulatedResourceExhausted(step=step)
            elif point == "ckpt" and kind == "corrupt_ckpt" and due:
                spec["fired"] = True
                self.corrupt_checkpoint(path)

    @staticmethod
    def _fire_process_fault(kind, step):
        print(f"mx.resilience: fault injection: {kind} at step {step} "
              f"(rank {_process_index()})", file=sys.stderr)
        sys.stderr.flush()
        os.kill(os.getpid(), _signal.SIGTERM if kind == "sigterm"
                else _signal.SIGKILL)

    @staticmethod
    def corrupt_checkpoint(path):
        """Flip a byte in the middle of the largest payload file of a
        written checkpoint WITHOUT touching its manifest: the torn-write
        or bit-rot case verify_checkpoint must catch."""
        if not path or not os.path.isdir(path):
            return
        target, size = None, -1
        for rel, full in _walk_files(path):
            if rel == _MANIFEST:
                continue
            s = os.path.getsize(full)
            if s > size:
                target, size = full, s
        if target is None or size == 0:
            return
        with open(target, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(1)
            f.seek(size // 2)
            f.write(bytes([chunk[0] ^ 0xFF if chunk else 0xFF]))
        print(f"mx.resilience: fault injection: corrupted {target}",
              file=sys.stderr)

    def take(self, kind, step=None, ready=None):
        """Pop one armed spec of `kind` for a caller that implements the
        fault itself (the serving scheduler: burst, cancel). Honors @rank
        and the one-shot / first-launch-only disarm rules; a spec with
        @step:N fires only when `step` matches, a step-less spec fires
        at the first opportunity. `ready(spec)` False leaves the spec
        ARMED instead of consuming it — how a step-less cancel@req:N
        waits for request N to exist rather than burning itself on an
        idle scheduler tick. Returns {"arg", "req"} or None."""
        rank = _process_index()
        for spec in self._specs:
            if not self._armed(spec, kind, rank):
                continue
            if spec["step"] is not None and step != spec["step"]:
                continue
            if ready is not None and not ready(spec):
                continue
            spec["fired"] = True
            return {"arg": spec["arg"] or "", "req": spec["req"]}
        return None

    def consume(self, kind):
        """Pop one armed spec of `kind` (honoring @rank targeting and
        the one-shot / first-launch-only disarm rules) and return its
        arg string, or None. How point-less specs like slow_client reach
        the code that implements them."""
        rank = _process_index()
        for spec in self._specs:
            if self._armed(spec, kind, rank):
                spec["fired"] = True
                return spec["arg"] or ""
        return None


def fault_point(point, step=None, path=None):
    """The hook production code calls: does anything only while enabled
    AND a fault_inject spec is armed (the common case is one None
    check)."""
    inj = _injector
    if inj is not None and _enabled:
        inj.fire(point, step=step, path=path)


if _config.get("resilience"):
    install()
