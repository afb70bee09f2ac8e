"""mx.diagnostics — flight recorder, hang/NaN watchdog, and crash
post-mortem (counterpart of `mxnet_tpu/diagnostics.py`).

`mx.telemetry` answers "how fast is this run" while it is healthy; this
module answers "why did it die". Four pieces:

  * **flight recorder** — a bounded ring buffer of the last N step records
    (step id, loss, lr, grad-norm, input shapes, key telemetry counters,
    active scope). One deque append per step.
  * **watchdog** — a daemon thread that fires when no step completes within
    `watchdog_deadline_s`, naming the last-entered scope ("stuck in
    sharded_step(dispatch) @ step 1203"), dumping all-thread stacks and a
    post-mortem. One fire per stall; re-arms on the next completed step.
  * **NaN/Inf sentinel** — opt-in (`nan_sentinel`) finiteness check on
    loss / grad-norm in the trainers; a non-finite value triggers a
    post-mortem dump and raises `NonFiniteError`.
  * **post-mortem writer** — `faulthandler` + `sys.excepthook` + `atexit`
    integration that dumps ring buffer, telemetry registry, config
    snapshot, device-memory watermarks (`torch.cuda.memory_stats`), the
    mx.guard and mx.goodput sections when those are armed, and the tail
    of the profiler's event buffer to
    `diagnostics_dir/<rank>/postmortem.json`.

No observer initialises CUDA: the memory poll reads the card only where
this process already initialised it (`torch.cuda.is_initialized()`), so
an excepthook, the watchdog or a post-mortem in a process that never
touched the card (a forked DataLoader worker) stays off it.

Fork safety: in a forked child the watchdog is gone (a thread does not
survive fork) and its module slot is cleared (`os.register_at_fork`), so
a worker neither waits on it nor starts one; `install()` in a process
the port marked as a forked worker (`context.refuse_card`) starts no
watchdog.

Cost model: DISABLED (the default) is the production fast path — every
entry point checks one module-level bool and returns; no ring allocation,
no watchdog thread, no locks. Enable with `mx.diagnostics.install()` /
`MXNET_TPU_DIAGNOSTICS=1`.

Note: `postmortem.json` is written with Python's JSON dialect (bare NaN /
Infinity literals allowed) so a non-finite watermark can never lose the
dump; `json.load` reads it back.
"""
from __future__ import annotations

import atexit
import collections
import faulthandler
import json
import math
import os
import sys
import threading
import time
import traceback

import torch

from . import _locklint
from . import config
from . import telemetry as _telemetry

__all__ = [
    "enable", "disable", "enabled", "reset", "install", "uninstall",
    "record_step", "record_event", "annotate_step", "records",
    "ring_tail", "scope",
    "Watchdog", "arm_watchdog", "disarm_watchdog", "notify_progress",
    "suspend_watchdog",
    "NonFiniteError", "sentinel_check", "grad_global_norm",
    "memory_watermarks", "dump", "postmortem_path",
]

_lock = _locklint.make_rlock("diagnostics.ring")
_enabled = False                  # the fast-path bool; see enable()/disable()
_ring = None                      # deque(maxlen=ring_size); None while disabled
_installed = False
_prev_excepthook = None
_atexit_registered = False
_dump_history = []                # (reason, ts) of every dump this process
_dir_override = None              # install(diagnostics_dir=...) argument
_rank_override = None
_faulthandler_file = None         # kept referenced so GC can't close it
_watchdog = None
_current_scope = ("", 0.0, None)  # (name, entered_at_monotonic, step)
_last_mem_sample = 0.0
_MEM_SAMPLE_INTERVAL = 1.0        # seconds between device memory_stats polls


class NonFiniteError(FloatingPointError):
    """Raised by the NaN/Inf sentinel after writing a post-mortem dump."""


# shared framework-wide series, hoisted so the per-step ring digest reads
# bare floats instead of going through the registry lock each step
_M_COMPILE_TOTAL = _telemetry.counter("compile_total")
_M_RECOMPILE_TOTAL = _telemetry.counter("recompile_total")


def enabled():
    """True when the flight recorder is on (hot paths read the module
    global `_enabled` directly — this accessor is the public spelling)."""
    return _enabled


def enable(ring_size=None):
    """Turn the flight recorder on (allocates the ring buffer)."""
    global _enabled, _ring
    with _lock:
        size = int(ring_size or config.get("diagnostics_ring_size"))
        if _ring is None or _ring.maxlen != size:
            _ring = collections.deque(_ring or (), maxlen=size)
        _enabled = True


def disable():
    """Stop recording. The ring survives for inspection; reset() drops it."""
    global _enabled
    _enabled = False


def reset():
    """Drop recorded state (tests and run boundaries). While disabled the
    ring itself is released, restoring the zero-allocation fast path."""
    global _ring
    with _lock:
        if _ring is not None:
            _ring.clear()
            if not _enabled:
                _ring = None
        del _dump_history[:]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def record_step(step, loss=None, lr=None, grad_norm=None, shapes=None,
                **extra):
    """Append one step record to the ring and feed the watchdog. No-op
    while diagnostics is disabled (single bool check)."""
    ring = _ring if _enabled else None
    if ring is None:
        return
    rec = {"ts": time.time(), "kind": "step", "step": step}
    if loss is not None:
        rec["loss"] = loss
    if lr is not None:
        rec["lr"] = lr
    if grad_norm is not None:
        rec["grad_norm"] = grad_norm
    if shapes is not None:
        rec["shapes"] = [list(s) for s in shapes]
    if _current_scope[0]:
        rec["scope"] = _current_scope[0]
    # compact telemetry digest: bare counter reads, no registry lock — the
    # full snapshot() goes into the post-mortem, not every ring entry
    rec["telemetry"] = {
        "compile_total": _M_COMPILE_TOTAL.value,
        "recompile_total": _M_RECOMPILE_TOTAL.value,
    }
    _gp = sys.modules.get(__package__ + ".goodput")
    if _gp is not None and _gp._enabled and _gp._t_enable is not None:
        # bare dict reads, no accountant lock — same compact-digest
        # discipline as the telemetry counters above
        _el = time.perf_counter() - _gp._t_enable
        if _el > 0:
            _good = sum((_gp._totals or {}).get(c, 0.0) for c in _gp.GOOD)
            rec["goodput_fraction"] = round(min(1.0, _good / _el), 4)
    rec.update(extra)
    with _lock:
        # appends share the readers' lock: records() list()s the deque and
        # a concurrent lockless append would raise "deque mutated during
        # iteration" inside the watchdog's dump, killing its thread
        ring.append(rec)
    _maybe_sample_memory()
    notify_progress(step)


def record_event(kind, **payload):
    """Append a non-step record (compile/recompile/custom) to the ring."""
    ring = _ring if _enabled else None
    if ring is None:
        return
    ev = {"ts": time.time(), "kind": kind}
    ev.update(payload)
    with _lock:
        ring.append(ev)


def annotate_step(step, **fields):
    """Merge fields into the most recent ring record for `step`. Lets a
    second observer of the same step (e.g. the estimator handler adding
    the loss to the Trainer's record) enrich it instead of appending a
    near-duplicate that halves effective ring coverage. Returns False —
    caller should record_step instead — when no such record exists."""
    ring = _ring if _enabled else None
    if ring is None:
        return False
    with _lock:
        for rec in reversed(ring):
            if rec.get("kind") == "step" and rec.get("step") == step:
                rec.update(fields)
                return True
    return False


def records(kind=None):
    """Recorded ring entries, oldest first ([] while never enabled)."""
    with _lock:
        evs = list(_ring) if _ring is not None else []
    return [e for e in evs if kind is None or e.get("kind") == kind]


def ring_tail(n=8):
    """The newest `n` flight-ring records, oldest first ([] while the
    recorder is off) — the bounded slice mx.scope's /statusz serves.
    Records are COPIED under the lock (and only the requested tail, not
    the whole ring): annotate_step() mutates the newest live record,
    and handing a reference to an HTTP thread's json.dumps would race
    that update (torn record, or RuntimeError mid-iteration)."""
    n = int(n)
    if n <= 0:
        return []
    out = []
    with _lock:
        if _ring is not None:
            for rec in reversed(_ring):
                out.append(dict(rec))
                if len(out) >= n:
                    break
    out.reverse()
    return out


# ---------------------------------------------------------------------------
# scope tracking (what the watchdog names when a step never completes)
# ---------------------------------------------------------------------------

def _scope_begin(name, step=None):
    global _current_scope
    _current_scope = (name, time.monotonic(), step)


def _scope_end():
    global _current_scope
    _current_scope = ("", 0.0, None)


class scope:
    """Context manager marking a region the watchdog can name: a hang
    inside it reports "stuck in <name> @ step <step>"."""

    def __init__(self, name, step=None):
        self.name = name
        self.step = step

    def __enter__(self):
        if _enabled:
            _scope_begin(self.name, self.step)
        return self

    def __exit__(self, *exc):
        if _enabled:
            _scope_end()
        return False


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

class Watchdog:
    """Fires when no progress notification arrives within `deadline_s`.

    `clock` and `interval` are injectable for deterministic tests: the
    poll thread sleeps `interval` real seconds but all deadline math uses
    `clock()`. `_check()` is the synchronous decision step (tests call it
    directly). One fire per stall: after firing, the watchdog stays quiet
    until the next notify() re-arms it."""

    def __init__(self, deadline_s, on_fire=None, clock=time.monotonic,
                 interval=None, armed=True):
        self.deadline = float(deadline_s)
        self.clock = clock
        self.interval = interval if interval is not None else \
            min(max(self.deadline / 4.0, 0.05), 1.0)
        self.on_fire = on_fire
        self.fired = 0
        self.last_message = None
        self._last = clock()
        self._last_step = None
        # armed=False starts the watchdog DORMANT: the first notify() arms
        # it, so a minutes-long startup (kernel builds, data prep) before
        # any step completes can never read as a stall
        self._armed = armed
        self._suspended = 0
        self._stop = threading.Event()
        self._thread = None

    def notify(self, step=None, arm=True):
        """Progress: restart the idle clock. `arm=False` defers an armed
        deadline without waking a DORMANT one (progress before the first
        step must not arm it)."""
        self._last = self.clock()
        if step is not None:
            self._last_step = step
        if arm:
            self._armed = True

    def suspend(self):
        """Enter a legitimate long non-step region (checkpoint write,
        kernel build): the deadline cannot fire until the matching
        resume(). Nestable (counted)."""
        self._suspended += 1

    def resume(self):
        """Leave a suspended region; the suspended time does not count
        against the deadline (the idle clock restarts at resume)."""
        self._suspended = max(0, self._suspended - 1)
        if self._suspended == 0:
            self._last = self.clock()

    def _check(self):
        """One poll: returns True iff the deadline fired this call."""
        if self._suspended:
            return False
        idle = self.clock() - self._last
        if idle <= self.deadline or not self._armed:
            return False
        self._armed = False
        self.fired += 1
        name = _current_scope[0]
        where = f"stuck in {name}" if name else "no active scope"
        step = _current_scope[2] if _current_scope[2] is not None \
            else self._last_step
        msg = (f"mx.diagnostics watchdog: no step completed in {idle:.1f}s "
               f"(deadline {self.deadline:.1f}s) — {where} @ step {step}")
        self.last_message = msg
        print(msg, file=sys.stderr)
        if self.on_fire is not None:
            self.on_fire(msg)
        else:
            _dump_thread_stacks()
            try:
                dump(reason="watchdog", note=msg)
            except Exception:
                pass  # a hung run with an unwritable dir still gets stderr
        return True

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="mx-diagnostics-watchdog", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self._check()
            except Exception as e:
                # the watchdog must outlive any single bad poll — a dead
                # thread means hang detection silently gone for the run
                print(f"mx.diagnostics watchdog: check failed: {e}",
                      file=sys.stderr)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def _in_forked_worker():
    """True in a process the port marked as a forked worker (it refuses
    the card: `context.refuse_card`); the watchdog never starts there."""
    ctx = sys.modules.get(__package__ + ".context")
    return ctx is not None and ctx._refused is not None


def _after_fork_in_child():
    """A forked child has no watchdog thread (threads do not survive
    fork): clear the slot so nothing waits on, stops or notifies the
    parent's dead copy."""
    global _watchdog
    _watchdog = None


os.register_at_fork(after_in_child=_after_fork_in_child)


def arm_watchdog(deadline_s=None, **kwargs):
    """Start (or restart) the module watchdog. deadline_s defaults to the
    `watchdog_deadline_s` knob; 0 means no watchdog (returns None)."""
    global _watchdog
    if deadline_s is None:
        deadline_s = config.get("watchdog_deadline_s")
    disarm_watchdog()
    if not deadline_s or float(deadline_s) <= 0:
        return None
    with _lock:
        _watchdog = Watchdog(deadline_s, **kwargs).start()
    return _watchdog


def disarm_watchdog():
    global _watchdog
    with _lock:
        w, _watchdog = _watchdog, None
    if w is not None:
        w.stop()


def notify_progress(step=None):
    w = _watchdog
    if w is not None:
        w.notify(step)


class suspend_watchdog:
    """Context manager for a NAMED legitimate long non-step region — a
    multi-GB checkpoint write — during which neither the module watchdog
    nor mx.guard's step deadline may fire (a long save is progress, not
    a hang). The deadline restarts
    its idle clock at exit, so a save just under the deadline can't
    trip it one poll later. Doubles as a diagnostics scope: a REAL hang
    *inside* the region still gets named by the post-mortem ("stuck in
    checkpoint.save @ step N") even though the timers stay quiet. Cheap
    enough for the disabled fast path: two module-global reads when
    nothing is armed."""

    def __init__(self, name, step=None):
        self.name = name
        self.step = step
        self._dogs = ()
        self._scoped = False

    def __enter__(self):
        dogs = []
        w = _watchdog
        if w is not None:
            dogs.append(w)
        g = sys.modules.get(__package__ + ".guard")
        if g is not None:
            d = g._deadline
            if d is not None:
                dogs.append(d)
        self._dogs = tuple(dogs)
        for d in self._dogs:
            d.suspend()
        if _enabled:
            self._scoped = True
            _scope_begin(self.name, self.step)
        return self

    def __exit__(self, *exc):
        if self._scoped:
            _scope_end()
        for d in self._dogs:
            d.resume()
        return False


def _dump_thread_stacks():
    """All-thread stacks to <rank dir>/watchdog_stacks.txt (the hang
    evidence faulthandler can produce without any signal plumbing)."""
    try:
        d = _rank_dir()
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "watchdog_stacks.txt"), "a") as f:
            f.write(f"=== watchdog fire at {time.time():.3f} ===\n")
            faulthandler.dump_traceback(file=f, all_threads=True)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# NaN/Inf sentinel
# ---------------------------------------------------------------------------

def _scalar(value):
    """Host float of an NDArray / tensor / numpy array / python number
    (mean over non-scalar inputs): one device-to-host copy."""
    import numpy as np
    v = getattr(value, "_t", value)
    if isinstance(v, torch.Tensor):
        v = v.detach()
        v = (v if v.dim() == 0 else v.double().mean()).item()
    arr = np.asarray(v, dtype=np.float64)
    return float(arr) if arr.ndim == 0 else float(np.mean(arr))


def sentinel_check(value, what="loss", step=None):
    """Return `value` as a host float; on NaN/Inf write a post-mortem and
    raise NonFiniteError. The host fetch is the cost of the check — which
    is why the sentinel is opt-in (`nan_sentinel`)."""
    if value is None:
        return None
    v = _scalar(value)
    if math.isfinite(v):
        return v
    note = f"non-finite {what} at step {step}: {v}"
    try:
        dump(reason="nan", note=note)
    except OSError:
        pass
    raise NonFiniteError(
        f"{note} — post-mortem at {postmortem_path()!r}; rerun under "
        "torch.autograd.detect_anomaly() for op-level NaN location")


def grad_global_norm(params):
    """Global L2 norm over the parameters' gradients (float32
    accumulate): device math + one host fetch; None when no gradients
    exist. `params` are Parameters (the gradient is `.grad`), NDArrays or
    tensors (taken as the gradients themselves)."""
    total = None
    for p in params:
        g = p.grad if isinstance(p, torch.nn.Parameter) else p
        if callable(g):
            try:
                g = g()
            except RuntimeError:
                continue  # grad_req='null' or uninitialized
        g = getattr(g, "_t", g)
        if g is None:
            continue
        s = g.detach().float().square().sum()
        total = s if total is None else total + s.to(total.device)
    return float(total.sqrt()) if total is not None else None


# ---------------------------------------------------------------------------
# device-memory watermarks
# ---------------------------------------------------------------------------

_M_DEV_IN_USE = _telemetry.gauge(
    "device_bytes_in_use", "per-device bytes currently allocated by the "
    "caching allocator (torch.cuda.memory_stats; absent on the CPU)")
_M_DEV_PEAK = _telemetry.gauge(
    "device_peak_bytes_in_use", "per-device peak allocated bytes — the OOM "
    "headroom watermark")
_M_HOST_RSS = _telemetry.gauge(
    "host_peak_rss_mb", "peak resident set size of this process (MiB)")


def _cuda_devices_if_initialized():
    """The CUDA device indices ONLY when this process already initialised
    CUDA — an excepthook, the watchdog or a post-mortem never makes the
    first CUDA call (in a forked worker that call would fail, and it
    costs seconds anywhere)."""
    if not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def memory_watermarks():
    """Per-card memory stats (`torch.cuda.memory_stats`,
    `max_memory_allocated`) plus the host peak-RSS fallback (always
    present, so CPU-only runs still get a memory trajectory). Also
    publishes the telemetry gauges when telemetry is enabled; never
    initialises CUDA (see _cuda_devices_if_initialized)."""
    out = []
    for i in _cuda_devices_if_initialized():
        stats = torch.cuda.memory_stats(i)
        name = f"cuda:{i}"
        rec = {"device": name,
               "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                             0)),
               "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
               "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                               0)),
               "bytes_limit": int(torch.cuda.get_device_properties(
                   i).total_memory),
               "num_ooms": int(stats.get("num_ooms", 0))}
        out.append(rec)
        _M_DEV_IN_USE.labels(device=name).set(rec["bytes_in_use"])
        _M_DEV_PEAK.labels(device=name).set(rec["peak_bytes_in_use"])
    try:
        rss_mb = host_peak_rss_mb()
        out.append({"device": "host", "peak_rss_mb": round(rss_mb, 1)})
        _M_HOST_RSS.set(rss_mb)
    except Exception:
        pass
    return out


def host_peak_rss_mb():
    """Peak resident set size of this process in MiB (the single home of
    the platform-sensitive ru_maxrss units)."""
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "darwin":
        peak //= 1024  # ru_maxrss is bytes on macOS, KiB on Linux
    return peak / 1024.0


def _maybe_sample_memory():
    global _last_mem_sample
    now = time.monotonic()
    if now - _last_mem_sample < _MEM_SAMPLE_INTERVAL:
        return
    _last_mem_sample = now
    memory_watermarks()


# ---------------------------------------------------------------------------
# crash post-mortem
# ---------------------------------------------------------------------------

def _rank():
    if _rank_override is not None:
        return _rank_override
    for var in ("RANK", "DMLC_WORKER_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _base_dir():
    return _dir_override or config.get("diagnostics_dir")


def _rank_dir():
    return os.path.join(_base_dir(), str(_rank()))


def postmortem_path():
    """Where this process's post-mortem dump lands."""
    return os.path.join(_rank_dir(), "postmortem.json")


def _profiler_tail(n=100):
    from . import profiler
    with profiler._lock:
        return list(profiler._events)[-n:]


def dump(reason="manual", exc_info=None, note=None, path=None):
    """Write the post-mortem JSON: ring buffer, telemetry registry
    snapshot, config snapshot, memory watermarks, chrome-trace tail, and
    (when crashing) the exception + traceback. Returns the path. Last
    dump wins the file; earlier dumps this process (e.g. a recovered
    watchdog fire hours before a clean exit) survive as `prior_dumps`."""
    pm = {
        "schema": 1,
        "rank": _rank(),
        "pid": os.getpid(),
        "ts": time.time(),
        "reason": reason,
        "argv": list(sys.argv),
    }
    if note:
        pm["note"] = note
    with _lock:
        if _dump_history:
            pm["prior_dumps"] = [{"reason": r, "ts": t}
                                 for r, t in _dump_history]
    if exc_info is not None:
        etype, evalue, etb = exc_info
        pm["exception"] = {
            "type": getattr(etype, "__name__", str(etype)),
            "message": str(evalue),
            "traceback": traceback.format_exception(etype, evalue, etb),
        }
    w = _watchdog
    if w is not None:
        pm["watchdog"] = {
            "deadline_s": w.deadline,
            "fired": w.fired,
            "last_step": w._last_step,
            "seconds_since_progress": round(w.clock() - w._last, 3),
        }
    if _current_scope[0]:
        pm["scope"] = {"name": _current_scope[0],
                       "entered_s_ago": round(
                           time.monotonic() - _current_scope[1], 3),
                       "step": _current_scope[2]}
    pm["ring"] = records()
    try:
        pm["telemetry"] = _telemetry.snapshot()
    except Exception as e:
        pm["telemetry"] = {"error": str(e)}
    try:
        pm["config"] = config.describe()
    except Exception as e:
        pm["config"] = {"error": str(e)}
    try:
        pm["memory"] = memory_watermarks()
    except Exception as e:
        pm["memory"] = [{"error": str(e)}]
    try:
        # cost attribution (mx.inspect — via sys.modules: inspect imports
        # this module): an OOM post-mortem then names the step with the
        # largest peak_bytes right next to the memory watermarks
        _inspect_mod = sys.modules.get(__package__ + ".inspect")
        if _inspect_mod is not None and _inspect_mod._registry:
            pm["inspect"] = _inspect_mod.snapshot()
    except Exception as e:
        pm["inspect"] = {"error": str(e)}
    try:
        # resume provenance (mx.resilience — checked via sys.modules so a
        # run that never touched resilience pays no import): names the
        # checkpoint this process restored from, so a post-mortem of a
        # relaunched run shows where it picked up
        _res = sys.modules.get(__package__ + ".resilience")
        if _res is not None:
            if _res._resume_info:
                pm["resume"] = dict(_res._resume_info)
            if _res.restart_count():
                pm.setdefault("resume", {})["restart_count"] = \
                    _res.restart_count()
    except Exception as e:
        pm["resume"] = {"error": str(e)}
    try:
        # memory-safety story (mx.memsafe — via sys.modules so a run that
        # never touched it pays no import): the last pre-flight budget
        # check, every degradation-ladder transition, and the OOM count —
        # an OOM post-mortem then shows what was predicted and what the
        # ladder already traded away
        _ms = sys.modules.get(__package__ + ".memsafe")
        if _ms is not None and (_ms._transitions or _ms._last_check
                                or _ms._oom_events):
            pm["memsafe"] = _ms.snapshot()
    except Exception as e:
        pm["memsafe"] = {"error": str(e)}
    try:
        # step-timeline story (mx.trace — via sys.modules so a run that
        # never touched it pays no import): sampling config, span/skew
        # volume, the LAST measured step-skew probe, and where this
        # rank's trace.jsonl landed
        _tr = sys.modules.get(__package__ + ".trace")
        if _tr is not None and (_tr._enabled or _tr._skews):
            pm["trace"] = _tr.snapshot()
    except Exception as e:
        pm["trace"] = {"error": str(e)}
    try:
        # liveness/SDC story (mx.guard, via sys.modules): last heartbeat,
        # deadline and digest-vote config, the last SDC verdict, and —
        # when the step deadline fired — the suspected dead peer
        _g = sys.modules.get(__package__ + ".guard")
        if _g is not None and (_g._enabled or _g._peer_lost_info
                               or _g._last_sdc):
            pm["guard"] = _g.snapshot()
    except Exception as e:
        pm["guard"] = {"error": str(e)}
    try:
        # wall-clock accounting story (mx.goodput, via sys.modules)
        _gp = sys.modules.get(__package__ + ".goodput")
        if _gp is not None and _gp._enabled:
            pm["goodput"] = _gp.snapshot()
    except Exception as e:
        pm["goodput"] = {"error": str(e)}
    try:
        pm["profiler_tail"] = _profiler_tail()
    except Exception:
        pm["profiler_tail"] = []
    path = path or postmortem_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(pm, f, default=str)
    os.replace(tmp, path)  # crash-during-dump leaves the previous dump intact
    with _lock:
        _dump_history.append((reason, pm["ts"]))
    return path


def _excepthook(etype, evalue, etb):
    try:
        dump(reason="exception", exc_info=(etype, evalue, etb))
    except Exception as e:
        print(f"mx.diagnostics: post-mortem dump failed: {e}",
              file=sys.stderr)
    hook = _prev_excepthook or sys.__excepthook__
    hook(etype, evalue, etb)


def _atexit_dump():
    # a crash already wrote its dump through the excepthook — that IS the
    # exit state. Anything else (no dump yet, or a RECOVERED watchdog/nan
    # fire hours earlier) gets a final reason='exit' dump so a rank that
    # stalled once but finished clean isn't reported as HUNG forever; the
    # earlier fire survives in prior_dumps.
    if not (_installed and _enabled):
        return
    if _dump_history and _dump_history[-1][0] == "exception":
        return
    try:
        dump(reason="exit")
    except Exception:
        pass  # nothing useful to do with a write error during interpreter exit


def install(diagnostics_dir=None, rank=None, ring_size=None):
    """Arm the whole post-mortem layer: enable the flight recorder, chain
    `sys.excepthook`, register the atexit writer, point `faulthandler` at
    `<rank dir>/faulthandler.log` (hard-crash stacks: SIGSEGV/SIGABRT),
    and start the watchdog when `watchdog_deadline_s` > 0. Idempotent;
    returns the per-rank directory."""
    global _installed, _prev_excepthook, _atexit_registered
    global _dir_override, _rank_override, _faulthandler_file
    with _lock:
        if diagnostics_dir is not None:
            _dir_override = str(diagnostics_dir)
        if rank is not None:
            _rank_override = int(rank)
    enable(ring_size=ring_size)
    d = _rank_dir()
    try:
        os.makedirs(d, exist_ok=True)
        if _faulthandler_file is None:
            _faulthandler_file = open(
                os.path.join(d, "faulthandler.log"), "a")
            faulthandler.enable(file=_faulthandler_file, all_threads=True)
    except OSError as e:
        print(f"mx.diagnostics: cannot write {d!r}: {e} — post-mortems "
              "will retry at dump time", file=sys.stderr)
    with _lock:
        if not _installed:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _excepthook
            _installed = True
        if not _atexit_registered:
            atexit.register(_atexit_dump)
            _atexit_registered = True
    if config.get("watchdog_deadline_s") > 0 and _watchdog is None \
            and not _in_forked_worker():
        arm_watchdog()
    return d


def uninstall():
    """Undo install() (tests): restore the excepthook, stop the watchdog,
    release faulthandler. The atexit hook stays registered but checks
    `_installed` and becomes a no-op."""
    global _installed, _prev_excepthook, _faulthandler_file
    global _dir_override, _rank_override
    disarm_watchdog()
    with _lock:
        if _installed:
            sys.excepthook = _prev_excepthook or sys.__excepthook__
            _prev_excepthook = None
            _installed = False
        if _faulthandler_file is not None:
            try:
                faulthandler.disable()
                _faulthandler_file.close()
            except OSError:
                pass
            _faulthandler_file = None
        _dir_override = None
        _rank_override = None
    disable()


if config.get("diagnostics"):
    install()
