"""Misc utilities (counterpart of `mxnet_tpu/util.py`; reference:
python/mxnet/util.py). Numpy-mode toggles are the 2.x line and out of
scope for this 1.x-surface build — `is_np_array` reports False so
shared scripts can branch."""
from __future__ import annotations

import functools
import os
import time

__all__ = ["makedirs", "is_np_array", "use_np", "getenv", "setenv",
           "fmt_bytes", "now_us", "perf_to_us", "epoch_unix_ns"]

# The process-wide monotonic trace epoch: ONE (perf_counter, wall-clock)
# anchor pair, captured together at first import, shared by mx.profiler's
# chrome-trace events, mx.telemetry's event mirror, and mx.trace's span
# records — so a merged timeline never mixes clocks with different zero
# points. epoch_unix_ns() maps the monotonic zero back to wall time, which
# is how tools/trace_report.py aligns per-rank span files onto one axis.
_EPOCH_PC_NS = time.perf_counter_ns()
_EPOCH_UNIX_NS = time.time_ns()


def now_us():
    """Microseconds since the shared monotonic trace epoch."""
    return (time.perf_counter_ns() - _EPOCH_PC_NS) / 1e3


def perf_to_us(t):
    """Map a raw time.perf_counter() reading (seconds) onto the shared
    microsecond epoch, so timestamps captured before a record call lands
    on the same axis as now_us()."""
    return t * 1e6 - _EPOCH_PC_NS / 1e3


def epoch_unix_ns():
    """Wall-clock time (ns since the unix epoch) at the monotonic epoch's
    zero point: absolute_ns = epoch_unix_ns() + round(ts_us * 1000)."""
    return _EPOCH_UNIX_NS


def fmt_bytes(n, show_raw=False):
    """Human-readable byte count: '1.50 GiB', or with show_raw
    '1.50 GiB (1610612736 bytes)' — shared by mx.memsafe error messages
    and mx.check findings so the two subsystems format identically."""
    n = int(n)
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            human = f"{n / div:.2f} {unit}"
            return f"{human} ({n} bytes)" if show_raw else human
    return f"{n} bytes" if show_raw else f"{n} B"


def makedirs(d):
    """mkdir -p (the reference kept this for py2 compat; harmless)."""
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def is_np_array():
    """Numpy-semantics mode is the MXNet 2.x line — always False here."""
    return False


def use_np(func):
    """2.x numpy-mode decorator: accepted and returned unchanged (ops
    here already follow numpy-style broadcasting)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return func(*args, **kwargs)
    return wrapper


def getenv(name):
    """Reference MXGetEnv facade."""
    return os.environ.get(name)


def setenv(name, value):
    """Reference MXSetEnv facade."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)
