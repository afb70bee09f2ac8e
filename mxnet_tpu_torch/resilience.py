"""Transient-fault retry and fault injection (the part of
`mxnet_tpu/resilience.py` that serving reads).

  * **RetryPolicy** — exponential backoff + jitter + retryable-exception
    classification, copied from the JAX package. The server runs every
    batched dispatch under one.
  * **FaultInjector** — deterministic faults driven by the
    `fault_inject` knob, in the JAX package's spec grammar. Serving
    consumes three kinds: `slow_client:ms` (`Request.stream`),
    `burst:N@step:K` and `cancel@req:N` (`Server._fire_faults`). Every
    other kind of the grammar (sigterm, kill, corrupt_ckpt, stall_input,
    exc, shrink, grow, oom, hang, corrupt_grad, stall_heartbeat,
    kill_replica, wedge_replica, slow_replica) parses to the same
    structure, but no port code fires it yet: the checkpoint, trainer,
    guard and fleet layers that arm them are not ported (ROADMAP).

`enable()` parses the knob into the module's injector and arms it;
`disable()` disarms it. Disabled (the default) costs the serving hook
sites one module-bool check. The JAX package's checkpoints, preemption
handling and `install()` signal handlers are not in the port.
"""
from __future__ import annotations

import os
import random as _pyrandom
import sys
import threading
import time

from . import config as _config

__all__ = ["enable", "disable", "enabled", "RetryPolicy", "FaultInjector",
           "restart_count"]

_lock = threading.RLock()
_enabled = False          # the fast-path bool: hook sites check ONLY this
_injector = None          # FaultInjector parsed from the fault_inject knob

_KINDS = ("sigterm", "kill", "corrupt_ckpt", "stall_input", "exc", "shrink",
          "grow", "oom", "hang", "corrupt_grad", "stall_heartbeat",
          "slow_client", "burst", "cancel", "kill_replica", "wedge_replica",
          "slow_replica")


def enabled():
    """True when fault injection is armed (hook sites read the module
    global `_enabled` directly; this accessor is the public spelling)."""
    return _enabled


def enable():
    """Parse the `fault_inject` knob and arm the hook sites."""
    global _enabled, _injector
    with _lock:
        _injector = FaultInjector.from_config()
        _enabled = True


def disable():
    global _enabled, _injector
    with _lock:
        _enabled = False
        _injector = None


def restart_count():
    """How many times a supervisor has relaunched this process
    (`MXNET_TPU_RESTART_COUNT`; 0 on the first launch)."""
    try:
        return int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        return 0


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
      sigterm, kill, corrupt_ckpt, stall_input, exc, shrink, grow, oom,
      hang, corrupt_grad, stall_heartbeat, kill_replica, wedge_replica,
      slow_replica          — parsed, not fired by any port code yet
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
