"""mx.telemetry — framework-wide metrics registry + structured run events
(counterpart of `mxnet_tpu/telemetry.py`).

`mx.profiler` answers "where did this microsecond go" (host scopes and
the card's kernels, chrome://tracing); this module is the aggregation
layer for the questions that decide throughput: how often did a step
meet a new signature and WHY, is the step input-bound or compute-bound,
how long did a request wait. Named Counters / Gauges / Histograms with
labels, plus a structured JSONL event stream (compile/recompile/step
events), exported as Prometheus text or JSONL and mirrored into the
profiler's chrome trace as Counter series.

PyTorch runs eagerly and compiles nothing, so `compile_total`,
`recompile_total` and `compile_seconds` count the first call at a new
signature: a `ShardedTrainer` step at a new batch shape (the probe pass
included) or a hybridized block's cache miss.

Cost model: DISABLED (the default) is the production fast path — every
instrumentation site checks one module-level bool and falls through; no
locks, no allocation, no event objects. Enabled updates take one lock.

Instrumented layers (each site degrades to the bool check when disabled):
  * gluon/block.py          — hybridize-cache hits/misses, first-call wall
                              time, recompile-cause diagnosis (signature
                              diff)
  * gluon/trainer.py        — optimizer-apply latency histogram
  * parallel/trainer.py     — step latency + new-signature compiles
  * gluon/data/dataloader   — batch-wait histogram, prefetch-queue depth
  * serve.py                — requests, tokens, deadline misses, TTFT,
                              queue wait, queue depth, active requests
  * memsafe.py              — budget checks, OOM events, ladder rungs
  * resilience.py           — checkpoint save/restore seconds, verify
                              failures, restarts/preemptions/retries
  * trace.py                — step_skew_seconds / straggler_rank gauges

Config: `telemetry` (enable at import), `telemetry_jsonl_path` (auto-flush
target), `telemetry_flush_interval` (seconds between auto-flushes).
"""
from __future__ import annotations

import atexit
import bisect
import collections
import json
import os
import time

from . import _locklint
from . import config
from . import util as _util

__all__ = [
    "enable", "disable", "enabled", "reset",
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram", "get",
    "event", "events", "signature", "diff_signature",
    "snapshot", "dump_jsonl", "dump_prometheus", "flush",
    "PROM_CONTENT_TYPE",
]

# the Prometheus text exposition content type of dump_prometheus()
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# RLock: exporters render whole metric trees (children, percentiles) under
# the lock, and percentile() itself locks — hot-path updates still take it
# exactly once. Created through the instrumented-lock factory: the plain
# RLock when check_threads is off (zero overhead), the order-recording
# CheckedLock under tsan-lite
_lock = _locklint.make_rlock("telemetry.registry")
# plain dict when tsan-lite is off; armed, every mutation asserts _lock
# is held (the shared-structure half of the concurrency analysis)
_metrics = _locklint.guarded_dict(_lock, "telemetry.metrics")
# name -> metric object
_MAX_EVENTS = 100_000             # drop-oldest bound on the buffer
_events = collections.deque(maxlen=_MAX_EVENTS)   # cleared on flush
_dropped_events = 0
_last_flush = time.monotonic()
_flush_warned = False             # one warning per bad autoflush target
_enabled = False                  # the fast-path bool; see enable()/disable()


def enabled():
    """True when telemetry collection is on (hot paths read the module
    global `_enabled` directly — this accessor is the public spelling)."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    """Zero every registered metric and drop buffered events (tests and
    run boundaries; the registry itself — names/types — survives)."""
    global _dropped_events
    with _lock:
        for m in _metrics.values():
            m._reset()
        _events.clear()
        _dropped_events = 0


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _label_key(labels):
    return tuple(sorted(labels.items()))


def _render_labels(key):
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" if key else ""


class _Metric:
    """Base: a named series, optionally fanned out by label values."""

    typ = "untyped"

    def __init__(self, name, doc=""):
        self.name = name
        self.doc = doc
        self._mirror_name = name  # label-qualified for children (chrome trace)
        self._children = {}       # label-key tuple -> child metric

    def labels(self, **labels):
        """Child series bound to label values (prometheus semantics);
        created lazily, cheap to re-request."""
        key = _label_key(labels)
        with _lock:
            child = self._children.get(key)
            if child is None:
                child = type(self)(self.name, self.doc)
                # each label child mirrors into the profiler as its own
                # counter series — sharing the parent name would interleave
                # e.g. push and pull cumulative totals into one sawtooth
                child._mirror_name = self.name + _render_labels(key)
                if isinstance(self, Histogram):
                    child._uppers = self._uppers
                    child._bucket_counts = [0] * len(self._uppers)
                self._children[key] = child
            return child

    def _reset(self):
        for c in self._children.values():
            c._reset()


class Counter(_Metric):
    """Monotonic count. `inc()` is a no-op while telemetry is disabled."""

    typ = "counter"

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self.value = 0.0

    def inc(self, amount=1.0):
        if not _enabled:
            return
        with _lock:
            self.value += amount
        _mirror(self._mirror_name, self.value)

    def _reset(self):
        self.value = 0.0
        super()._reset()


class Gauge(_Metric):
    """Point-in-time value (queue depth, samples/s)."""

    typ = "gauge"

    def __init__(self, name, doc=""):
        super().__init__(name, doc)
        self.value = 0.0

    def set(self, value):
        if not _enabled:
            return
        with _lock:
            self.value = float(value)
        _mirror(self._mirror_name, self.value)

    def inc(self, amount=1.0):
        if not _enabled:
            return
        with _lock:
            self.value += amount
        _mirror(self._mirror_name, self.value)

    def dec(self, amount=1.0):
        self.inc(-amount)

    def _reset(self):
        self.value = 0.0
        super()._reset()


# latency-shaped default buckets: 100µs .. 60s, roughly x2.5 per step
_DEFAULT_BUCKETS = (1e-4, 2.5e-4, 1e-3, 2.5e-3, 1e-2, 2.5e-2, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram(_Metric):
    """Distribution: prometheus-style cumulative buckets for export plus a
    bounded reservoir of raw samples for exact-ish percentiles in reports."""

    typ = "histogram"
    _RESERVOIR = 8192

    def __init__(self, name, doc="", buckets=_DEFAULT_BUCKETS):
        super().__init__(name, doc)
        self._uppers = tuple(sorted(buckets))
        self._bucket_counts = [0] * len(self._uppers)
        self.count = 0
        self.sum = 0.0
        self._samples = collections.deque(maxlen=self._RESERVOIR)

    def observe(self, value):
        if not _enabled:
            return
        value = float(value)
        with _lock:
            self.count += 1
            self.sum += value
            i = bisect.bisect_left(self._uppers, value)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1
            self._samples.append(value)

    def percentile(self, q):
        """q in [0, 100]; from the raw-sample reservoir (None when empty)."""
        with _lock:
            samples = sorted(self._samples)
        if not samples:
            return None
        idx = min(len(samples) - 1, int(round(q / 100.0 * (len(samples) - 1))))
        return samples[idx]

    def _reset(self):
        self.count = 0
        self.sum = 0.0
        self._bucket_counts = [0] * len(self._uppers)
        self._samples.clear()
        super()._reset()


def _get_or_create(cls, name, doc, **kwargs):
    with _lock:
        m = _metrics.get(name)
        if m is None:
            m = cls(name, doc, **kwargs)
            _metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric '{name}' already registered as {m.typ}, "
                f"requested {cls.typ}")
        return m


def counter(name, doc=""):
    """Get-or-create: instrumentation sites across modules share one series
    per name (that is the point of a framework-wide registry)."""
    return _get_or_create(Counter, name, doc)


def gauge(name, doc=""):
    return _get_or_create(Gauge, name, doc)


def histogram(name, doc="", buckets=_DEFAULT_BUCKETS):
    return _get_or_create(Histogram, name, doc, buckets=buckets)


def get(name):
    """The registered metric object (KeyError when absent)."""
    return _metrics[name]


# ---------------------------------------------------------------------------
# chrome-trace bridge
# ---------------------------------------------------------------------------

def _mirror(name, value):
    """Mirror a counter/gauge update into mx.profiler as a chrome-trace
    Counter ('C') event, so telemetry series appear on the same timeline as
    host scopes. No-op unless the profiler is running."""
    from . import profiler
    if profiler._active():
        profiler._record({
            "name": name, "ph": "C", "ts": profiler._now_us(),
            "pid": os.getpid(), "args": {name: value},
        }, name)


# ---------------------------------------------------------------------------
# event stream
# ---------------------------------------------------------------------------

def event(kind, **payload):
    """Append one structured event (compile / recompile / step / ...).
    Buffered in memory; auto-flushed to `telemetry_jsonl_path` when
    configured, else held for dump_jsonl(). `mono_us` stamps the shared
    monotonic trace epoch (`util`) next to the wall `ts`, so
    JSONL events line up with mx.profiler scopes and mx.trace spans on
    one merged timeline without wall-clock smearing."""
    global _dropped_events
    if not _enabled:
        return
    ev = {"ts": time.time(), "mono_us": round(_util.now_us(), 1),
          "kind": kind}
    ev.update(payload)
    with _lock:
        if len(_events) == _MAX_EVENTS:
            _dropped_events += 1    # deque maxlen evicts the oldest
        _events.append(ev)
    _maybe_autoflush()


def events(kind=None):
    """Buffered (not yet flushed) events, newest last."""
    with _lock:
        evs = list(_events)
    return [e for e in evs if kind is None or e["kind"] == kind]


def _maybe_autoflush():
    global _last_flush, _flush_warned
    path = config.get("telemetry_jsonl_path")
    if not path:
        return
    now = time.monotonic()
    if now - _last_flush < float(config.get("telemetry_flush_interval")):
        return
    _last_flush = now
    try:
        flush(path)
    except OSError as e:
        # telemetry rides along — an unwritable autoflush target must not
        # kill the training step it is observing (events stay buffered)
        if not _flush_warned:
            _flush_warned = True
            import warnings
            warnings.warn(f"telemetry autoflush to {path!r} failed: {e}; "
                          "events stay buffered (warning once)")


def _drain_events():
    with _lock:
        evs = list(_events)
        _events.clear()
    return evs


def _restore_events(evs):
    """Put drained events back after a failed write: drained events first,
    then anything buffered since the drain (deque maxlen trims oldest,
    counted into _dropped_events like any other eviction)."""
    global _dropped_events
    with _lock:
        evs.extend(_events)
        _events.clear()
        overflow = len(evs) - _MAX_EVENTS
        if overflow > 0:
            _dropped_events += overflow
        _events.extend(evs)


def flush(path=None):
    """Append buffered events to `path` (default: telemetry_jsonl_path) and
    clear the buffer. Returns the path, or None when there is no target.
    On write failure the events are put back (oldest dropped first if the
    buffer refilled meanwhile) and the OSError propagates."""
    path = path or config.get("telemetry_jsonl_path")
    if not path:
        return None
    evs = _drain_events()
    if evs:
        try:
            with open(path, "a") as f:
                for ev in evs:
                    f.write(json.dumps(ev) + "\n")
        except OSError:
            _restore_events(evs)
            raise
    return path


@atexit.register
def _flush_at_exit():
    path = config.get("telemetry_jsonl_path")
    if not path or not _enabled:
        return
    try:
        flush(path)
        with open(path, "a") as f:
            f.write(json.dumps({"ts": time.time(), "kind": "snapshot",
                                "metrics": snapshot()}) + "\n")
    except OSError:
        pass    # nothing useful to do with a write error during interpreter exit


# ---------------------------------------------------------------------------
# recompile-cause diagnosis
# ---------------------------------------------------------------------------

def signature(args, train=None, **extra):
    """Canonical input signature of a compiled call: per-input shape/dtype
    (anything shapeless records its type name), plus the train flag and any
    extra cache-key components the caller includes."""
    inputs = []
    for a in args:
        if hasattr(a, "shape"):
            # "float32", as numpy and the JAX package spell it, not
            # "torch.float32"
            dtype = str(getattr(a, "dtype", "?")).replace("torch.", "")
            inputs.append({"shape": list(a.shape), "dtype": dtype})
        else:
            inputs.append({"shape": None, "dtype": type(a).__name__})
    sig = {"inputs": inputs}
    if train is not None:
        sig["train"] = bool(train)
    sig.update(extra)
    return sig


def diff_signature(prev, new):
    """Explain a recompile: structured changes between two signature()
    dicts. Returns (causes, changed) — human strings plus machine records
    naming the input index and AXIS that moved (the payload the acceptance
    gate asserts on)."""
    causes, changed = [], []
    if prev is None:
        return ["first compile"], changed
    pin, nin = prev.get("inputs", []), new.get("inputs", [])
    if len(pin) != len(nin):
        causes.append(f"input count {len(pin)} -> {len(nin)}")
        changed.append({"field": "input_count",
                        "from": len(pin), "to": len(nin)})
    for i, (p, n) in enumerate(zip(pin, nin)):
        if p["shape"] != n["shape"]:
            ps, ns = p["shape"], n["shape"]
            if ps is not None and ns is not None and len(ps) == len(ns):
                for ax, (a, b) in enumerate(zip(ps, ns)):
                    if a != b:
                        causes.append(
                            f"input[{i}] shape axis {ax}: {a} -> {b}")
                        changed.append({"input": i, "axis": ax,
                                        "from": a, "to": b})
            else:
                causes.append(f"input[{i}] rank/shape {ps} -> {ns}")
                changed.append({"input": i, "axis": None,
                                "from": ps, "to": ns})
        if p["dtype"] != n["dtype"]:
            causes.append(f"input[{i}] dtype {p['dtype']} -> {n['dtype']}")
            changed.append({"input": i, "dtype_from": p["dtype"],
                            "dtype_to": n["dtype"]})
    for field in sorted((set(prev) | set(new)) - {"inputs"}):
        if prev.get(field) != new.get(field):
            causes.append(f"{field} {prev.get(field)} -> {new.get(field)}")
            changed.append({"field": field, "from": prev.get(field),
                            "to": new.get(field)})
    if not causes:
        causes.append("signature unchanged (cache cleared)")
    return causes, changed


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _metric_snapshot(m):
    if isinstance(m, Histogram):
        out = {"type": m.typ, "count": m.count, "sum": m.sum,
               "p50": m.percentile(50), "p99": m.percentile(99)}
    else:
        out = {"type": m.typ, "value": m.value}
    if m._children:
        out["labels"] = {
            _render_labels(k): _metric_snapshot(c)
            for k, c in sorted(m._children.items())}
    return out


def snapshot():
    """All registered metrics as plain data (the JSONL 'snapshot' line).
    Rendered entirely under the lock so a concurrent labels()/observe()
    can't mutate a child dict mid-iteration or tear bucket state."""
    with _lock:
        out = {name: _metric_snapshot(m)
               for name, m in sorted(_metrics.items())}
        if _dropped_events:
            out["_dropped_events"] = {"type": "counter",
                                      "value": _dropped_events}
    return out


def dump_jsonl(path):
    """Write buffered events plus one final snapshot line to `path`
    (overwrites; the buffer is cleared). The format
    tools/telemetry_report.py reads."""
    evs = _drain_events()
    try:
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
            f.write(json.dumps({"ts": time.time(), "kind": "snapshot",
                                "metrics": snapshot()}) + "\n")
    except OSError:
        _restore_events(evs)
        raise
    return path


def _prom_lines(name, m, label_key=()):
    lbl = _render_labels(label_key)
    lines = []
    if not label_key and m._children and not (
            m.count if isinstance(m, Histogram) else m.value):
        # labeled metric whose unlabeled parent was never touched: emit
        # only the children (prometheus client convention — a phantom
        # zero-valued parent sample skews min()/absent() queries)
        for key, child in sorted(m._children.items()):
            lines.extend(_prom_lines(name, child, key))
        return lines
    if isinstance(m, Histogram):
        cum = 0
        for upper, n in zip(m._uppers, m._bucket_counts):
            cum += n
            le = _render_labels(label_key + (("le", repr(float(upper))),))
            lines.append(f"{name}_bucket{le} {cum}")
        inf = _render_labels(label_key + (("le", "+Inf"),))
        lines.append(f"{name}_bucket{inf} {m.count}")
        lines.append(f"{name}_sum{lbl} {m.sum}")
        lines.append(f"{name}_count{lbl} {m.count}")
    else:
        lines.append(f"{name}{lbl} {m.value}")
    for key, child in sorted(m._children.items()):
        lines.extend(_prom_lines(name, child, key))
    return lines


def dump_prometheus(path=None):
    """Prometheus text exposition format. Writes to `path` when given;
    always returns the text. Rendered under the lock (see snapshot)."""
    lines = []
    with _lock:
        for name, m in sorted(_metrics.items()):
            if m.doc:
                lines.append(f"# HELP {name} {m.doc}")
            lines.append(f"# TYPE {name} {m.typ}")
            lines.extend(_prom_lines(name, m))
    text = "\n".join(lines) + "\n"
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


if config.get("telemetry"):
    enable()
