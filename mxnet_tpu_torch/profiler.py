"""Profiler facade (counterpart of `mxnet_tpu/profiler.py`; reference:
`src/profiler/profiler.cc`, `python/mxnet/profiler.py`).

The reference profiler timestamps every engine op on its device lane and
dumps chrome://tracing JSON plus aggregate per-op tables. This module
keeps the `mx.profiler` frontend — host-side named scopes, events,
markers and counters collected into chrome://tracing JSON — and adds the
card's lane from `torch.profiler`:

  * `set_state("run")` in a process that already uses the card
    (`torch.cuda.is_initialized()`) also starts a `torch.profiler`
    session with CPU and CUDA activities; `set_state("stop")` ends it and
    folds every kernel, memcpy and memset the card ran into the event
    buffer as complete ('X') events with `cat` "kernel", the kernel's
    CUDA name, its device time and its stream (`tid`). The port's
    kernels, launched through ctypes, show by their CUDA names
    (`flash_fwd_...`, `lamb_pass1_...`). With `aggregate_stats` set,
    their counts and times join the aggregate table. `pause()` pauses
    the host scopes only: the card's lane covers run to stop.
  * `start_jax_trace(logdir)` / `stop_jax_trace()` keep the JAX
    package's names for the device trace of a region: they run one
    `torch.profiler` session (CPU and CUDA activities) and write its
    chrome trace to `<logdir>/trace.json`. They trace the card, not JAX.

Timestamps of the host lane sit on the shared monotonic epoch of `util`
(the one telemetry and trace use); the card's events are placed on it by
the session's start, so both lanes share one timeline.
"""
from __future__ import annotations

import json
import os
import threading

from . import _locklint
from . import util as _util

__all__ = [
    "set_config", "set_state", "start", "stop", "pause", "resume",
    "dump", "dumps", "get_summary", "Domain", "Scope", "scope", "Task",
    "Frame",
    "Event", "Counter", "Marker", "start_jax_trace", "stop_jax_trace",
    "jax_trace_dir", "device_events",
]

_lock = _locklint.make_lock("profiler.records")
_config = {
    "filename": "profile.json",
    "aggregate_stats": False,
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "continuous_dump": False,
}
_state = {"running": False, "paused": False}
_events = []            # chrome-trace event dicts (ts in µs)
_agg = {}               # name -> [count, total_us, min_us, max_us]
_session = None         # (torch.profiler.profile, start in epoch µs)


def _now_us():
    # the SHARED monotonic epoch (util): profiler scopes,
    # telemetry counter mirrors, and mx.trace spans all timestamp against
    # the same zero point, so merged timelines align without clock math
    return _util.now_us()


def set_config(**kwargs):
    """Configure the profiler (reference C API: MXSetProcessProfilerConfig)."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise ValueError(f"unknown profiler config keys: {sorted(unknown)}")
    _config.update(kwargs)


def set_state(state="stop"):
    """'run' or 'stop' (reference: MXSetProcessProfilerState). In a
    process that uses the card, 'run' also starts the card's lane and
    'stop' folds its kernels into the event buffer (module docstring)."""
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    running = state == "run"
    if running and not _state["running"]:
        _start_session()
    elif not running and _state["running"]:
        _stop_session()
    _state["running"] = running
    _state["paused"] = False


def _cuda_in_use():
    import torch
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _start_session():
    global _session
    if _session is not None or not _cuda_in_use():
        return
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = _now_us()
    prof.start()
    _session = (prof, t0)


def _stop_session():
    """End the card's session and fold its device events into the
    buffer (and the aggregate table when configured)."""
    global _session
    if _session is None:
        return
    import torch
    prof, t0 = _session
    _session = None
    torch.cuda.synchronize()
    prof.stop()
    pid = os.getpid()
    for ev in device_events(prof):
        _record({"name": ev["name"], "ph": "X", "ts": t0 + ev["start_us"],
                 "dur": ev["dur_us"], "pid": pid, "tid": ev["stream"],
                 "cat": "kernel"}, ev["name"], dur_us=ev["dur_us"])


def device_events(prof):
    """The card's events of a finished `torch.profiler` session: one dict
    per kernel, memcpy or memset ({"name", "start_us", "dur_us",
    "stream"}), start relative to the session's start, in launch
    order."""
    import torch
    out = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start = ev.time_range.start
        out.append({"name": ev.name, "start_us": start,
                    "dur_us": ev.time_range.end - start,
                    "stream": int(getattr(ev, "device_resource_id", 0)
                                  or 0)})
    out.sort(key=lambda e: e["start_us"])
    return out


def start():
    set_state("run")


def stop():
    set_state("stop")


def pause():
    _state["paused"] = True


def resume():
    _state["paused"] = False


def _active():
    return _state["running"] and not _state["paused"]


def _record(ev, name, dur_us=None):
    with _lock:
        _events.append(ev)
        if dur_us is not None and _config["aggregate_stats"]:
            s = _agg.get(name)
            if s is None:
                _agg[name] = [1, dur_us, dur_us, dur_us]
            else:
                s[0] += 1
                s[1] += dur_us
                s[2] = min(s[2], dur_us)
                s[3] = max(s[3], dur_us)


def dump(finished=True, filename=None):
    """Write collected events as chrome://tracing JSON
    (reference: MXDumpProfile → chrome tracing format). With
    `aggregate_stats` configured, the per-scope aggregate table rides
    along under an "aggregateStats" key (chrome://tracing ignores unknown
    top-level keys), mirroring the reference's AggregateStats dump."""
    path = filename or _config["filename"]
    with _lock:
        # events and aggregates drain in ONE critical section: a scope
        # exiting between two separate locks would land its aggregate row
        # in this file but its trace event in the next, and the two tables
        # in one dump would disagree
        events = list(_events)
        if finished:
            _events.clear()
        agg = _agg_rows(reset=finished) if _config["aggregate_stats"] \
            else None
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if agg is not None:
        doc["aggregateStats"] = agg
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _agg_rows(reset):
    """Copy (and optionally clear) the aggregate table. Caller holds
    _lock. Values are COPIED — a concurrent Scope.__exit__ updates
    [count, total, min, max] fields one by one, so handing out the live
    lists (as dumps() once did) let a reader see count incremented before
    total, i.e. rows whose avg undercuts min."""
    rows = {name: {"count": s[0],
                   "total_ms": s[1] / 1e3,
                   "min_ms": s[2] / 1e3,
                   "max_ms": s[3] / 1e3,
                   "avg_ms": s[1] / s[0] / 1e3}
            for name, s in _agg.items()}
    if reset:
        _agg.clear()
    return dict(sorted(rows.items(), key=lambda kv: -kv[1]["total_ms"]))


def get_summary(reset=False):
    """Aggregate per-scope stats as structured rows, total-time
    descending (reference: AggregateStats::DumpTable in
    `src/profiler/aggregate_stats.cc`). With reset=True the read and the
    clear are one atomic critical section, so no update between them can
    be lost."""
    with _lock:
        return _agg_rows(reset=reset)


def dumps(reset=False):
    """Aggregate per-name stats table (reference: AggregateStats::Dump).
    Snapshot + optional reset are atomic (see get_summary)."""
    rows = get_summary(reset=reset)
    lines = [f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
             f"{'Max(ms)':>10}{'Avg(ms)':>10}"]
    for name, r in rows.items():
        lines.append(f"{name:<40}{r['count']:>8}{r['total_ms']:>12.3f}"
                     f"{r['min_ms']:>10.3f}{r['max_ms']:>10.3f}"
                     f"{r['avg_ms']:>10.3f}")
    return "\n".join(lines)


class Domain:
    """Named grouping of profiler objects (reference: profiler.Domain)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(name, domain=self)

    def new_counter(self, name, value=None):
        c = Counter(name, domain=self)
        if value is not None:
            c.set_value(value)
        return c

    def new_marker(self, name):
        return Marker(name, domain=self)


class Scope:
    """Timed region context manager; appears as a complete ('X') event."""

    def __init__(self, name, domain=None):
        self.name = name
        self.domain = domain
        self._t0 = None

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        if self._t0 is None or not _active():
            return False
        t1 = _now_us()
        dur = t1 - self._t0
        _record({
            "name": self.name, "ph": "X", "ts": self._t0, "dur": dur,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "cat": self.domain.name if self.domain else "host",
        }, self.name, dur_us=dur)
        return False

    start = __enter__

    def stop(self):
        self.__exit__(None, None, None)


scope = Scope      # mx.profiler.scope('name') usage
Task = Scope       # Tasks/Frames are host-timed regions too
Frame = Scope


class Event(Scope):
    """Instantaneous or timed event; `mark()` drops an instant event."""

    def mark(self):
        if _active():
            _record({
                "name": self.name, "ph": "i", "ts": _now_us(), "s": "p",
                "pid": os.getpid(), "tid": threading.get_ident(),
                "cat": self.domain.name if self.domain else "host",
            }, self.name)


class Counter:
    """Named counter series (reference: profiler.Counter)."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.domain = domain
        self._value = value

    def _emit(self):
        if _active():
            _record({
                "name": self.name, "ph": "C", "ts": _now_us(),
                "pid": os.getpid(),
                "args": {self.name: self._value},
            }, self.name)

    def set_value(self, value):
        self._value = value
        self._emit()

    def increment(self, delta=1):
        self._value += delta
        self._emit()

    def decrement(self, delta=1):
        self._value -= delta
        self._emit()


class Marker:
    """Instant marker (reference: profiler.Marker)."""

    def __init__(self, name, domain=None):
        self.name = name
        self.domain = domain

    def mark(self, scope="process"):
        if _active():
            _record({
                "name": self.name, "ph": "i", "ts": _now_us(),
                "s": {"process": "p", "global": "g", "thread": "t"}.get(scope, "p"),
                "pid": os.getpid(), "tid": threading.get_ident(),
            }, self.name)


# --- the device trace of a region: one torch.profiler session --------------

# torch.profiler holds one session per process; this module tracks its
# target dir so a second concurrent start is refused instead of
# corrupting the live session
_jax_trace_dir = None
_jax_trace_prof = None


def start_jax_trace(logdir):
    """Start a device trace of the card (`torch.profiler`, CPU and CUDA
    activities) whose chrome trace `stop_jax_trace()` writes to
    `<logdir>/trace.json`; the name is the JAX package's. Raises
    RuntimeError when a trace session is already live — the slot is
    reserved under the module lock before the (slow) start call."""
    global _jax_trace_dir, _jax_trace_prof
    import torch
    with _lock:
        if _jax_trace_dir is not None:
            raise RuntimeError(
                f"a device trace is already recording to {_jax_trace_dir!r}")
        _jax_trace_dir = str(logdir)
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _jax_trace_prof = prof
    except BaseException:
        with _lock:
            _jax_trace_dir = None
        raise


def stop_jax_trace():
    """Stop the device trace and write `<logdir>/trace.json`; returns its
    path."""
    global _jax_trace_dir, _jax_trace_prof
    try:
        prof, logdir = _jax_trace_prof, _jax_trace_dir
        if prof is None:
            raise RuntimeError("no device trace is recording")
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        return path
    finally:
        with _lock:
            _jax_trace_dir = None
            _jax_trace_prof = None


def jax_trace_dir():
    """Target directory of the live device trace (None when none is
    recording)."""
    return _jax_trace_dir
