"""mx.trace — step tracing with straggler and critical-path attribution
(counterpart of `mxnet_tpu/trace.py`).

  * **sampling span recorder** — host-side spans tagged `(rank, step)` at
    the hook sites: ShardedTrainer compile, dispatch and fence, block
    first calls, resilience checkpoint save, the serving rounds
    (`serve.queue_wait`, `serve.admit`, `serve.decode_step`,
    `serve.stream`). Every `trace_sample_every`-th step is recorded
    (compiles/checkpoints always — rare and seconds-scale); sampled
    steps are additionally wrapped in a `torch.profiler.record_function`
    range ("mx.trace.step"), so a profile of the card shows the step's
    kernels under the step's span.
  * **skew probe** — every `trace_skew_every` sampled steps, the rank
    wall-stamps its arrival at the step boundary (an all-gather of the
    stamps when `torch.distributed` runs more than one rank; in one
    process the probe reports this rank alone). Feeds the
    `step_skew_seconds` / `straggler_rank` telemetry gauges, a
    flight-ring "trace" entry, and the post-mortem "trace" section.
  * **per-rank span files** — with `trace_dir` set, spans append to
    `<dir>/<rank>/trace.jsonl` behind a meta line carrying this rank's
    wall-clock epoch, so `tools/trace_report.py` can merge ranks into one
    clock-aligned chrome trace and print a verdict: input-bound /
    compute-bound / comm-skew-bound.

Clock model: spans timestamp against the process-wide monotonic epoch in
`util` — the SAME epoch the profiler's chrome events and telemetry's
event mirror use — and the meta line maps that epoch to wall time.

Cost model: DISABLED (the default) is the production fast path — every
hook site checks one module-level bool and falls through; no span buffer
exists, no locks are taken, nothing allocates. Enable with
`mx.trace.enable()` / `MXNET_TPU_TRACE=on`.
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import time

from . import _locklint
from . import config as _config
from . import telemetry as _telemetry
from . import util as _util

__all__ = [
    "enable", "disable", "enabled", "reset",
    "sampled", "record_span", "annotate", "skew_tick",
    "flush", "trace_path", "spans", "skews", "snapshot",
    "skew_p99_ms", "skew_verdict", "critical_path",
]

_lock = _locklint.make_lock("trace.recorder")
_enabled = False          # the fast-path bool; hook sites read it directly
_dir = ""                 # per-rank files under <_dir>/<rank>/trace.jsonl
_rank_override = None
_sample_every = 1
_skew_every = 16
_buf = None               # pending records; None while disabled (zero-alloc)
_meta_paths = set()       # targets that already carry their meta line
_ticks = {}               # per-name counters: sampling for step-less spans
_agg = {}                 # (cat, name) -> [count, total_us] (critical path)
_skews = []               # skew probe records (bounded, drop-oldest)
_recorded = 0
_dropped = 0
_skew_failed = False      # a failed collective probe disables further ones
_flush_warned = False
_next_flush_try = 0.0     # monotonic backoff after a failed flush
_FLUSH_EVERY = 256        # buffered records per file append
_FLUSH_RETRY_S = 5.0      # wait after a failed flush before retrying
_MAX_BUF = 100_000        # in-memory record bound (with or without a dir)
_MAX_SKEWS = 4096

# gang-wide skew surfaced as ordinary telemetry series (no-ops while
# telemetry is disabled, like every other gauge in the registry)
_M_SKEW = _telemetry.gauge(
    "step_skew_seconds", "step-arrival spread across ranks at the "
    "collective boundary, from the last mx.trace skew probe (collectives "
    "serialize on the slowest arriver — this is the measured cost)")
_M_STRAGGLER = _telemetry.gauge(
    "straggler_rank", "rank that arrived LAST at the collective boundary "
    "in the last mx.trace skew probe — the gang's current straggler")


def enabled():
    """True when the span recorder is on (hot paths read the module
    global `_enabled` directly — this accessor is the public spelling)."""
    return _enabled


def enable(trace_dir=None, rank=None, sample_every=None, skew_every=None):
    """Arm the recorder. Arguments override the `trace_dir` /
    `trace_sample_every` / `trace_skew_every` knobs (read once here — the
    per-span hot path never touches the config registry)."""
    global _enabled, _dir, _rank_override, _sample_every, _skew_every, _buf
    with _lock:
        if trace_dir is not None:
            _dir = str(trace_dir)
        elif not _dir:
            _dir = _config.get("trace_dir")
        if rank is not None:
            _rank_override = int(rank)
        _sample_every = max(1, int(
            sample_every if sample_every is not None
            else _config.get("trace_sample_every")))
        _skew_every = int(skew_every if skew_every is not None
                          else _config.get("trace_skew_every"))
        if _buf is None:
            _buf = []
        _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    """Drop recorded state (tests and run boundaries). While disabled the
    buffer itself is released, restoring the zero-allocation fast path."""
    global _buf, _recorded, _dropped
    global _skew_failed, _dir, _rank_override, _next_flush_try
    with _lock:
        _next_flush_try = 0.0
        _buf = [] if _enabled else None
        _ticks.clear()
        _agg.clear()
        del _skews[:]
        _meta_paths.clear()
        _recorded = 0
        _dropped = 0
        _skew_failed = False
        if not _enabled:
            _dir = ""
            _rank_override = None


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


def _generation():
    """Which relaunch generation this process belongs to (the
    supervised-relaunch counter a launcher exports; 0 standalone).
    Stamped into skew records so the offline cross-rank match pairs
    arrival stamps WITHIN a generation — a resumed gang replays step
    ids, and matching a survivor's replayed stamp against a dead rank's
    pre-restart stamp would read the restart backoff as arrival skew."""
    try:
        return int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        return 0


def _gang_epoch_ns():
    """The shared gang trace epoch a launcher exports (one wall
    timestamp for the whole gang), or None standalone."""
    v = os.environ.get("MXNET_TPU_TRACE_EPOCH_NS")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def trace_path():
    """Where this rank's span file lands (None when trace_dir is unset)."""
    if not _dir:
        return None
    return os.path.join(_dir, str(_rank()), "trace.jsonl")


# ---------------------------------------------------------------------------
# span recorder
# ---------------------------------------------------------------------------

def _trim_locked():
    """Drop-oldest bound on the record buffer (caller holds _lock),
    applied with OR without a trace_dir — an unwritable dir (every flush
    failing and re-queuing) must degrade to the same bounded in-memory
    buffer, not grow RSS. Trims in batches so eviction is amortized O(1)
    per span instead of an O(len) list shift per record once full."""
    global _dropped
    if len(_buf) > _MAX_BUF:
        cut = len(_buf) - _MAX_BUF + max(1, _MAX_BUF // 10)
        cut = min(cut, len(_buf))
        del _buf[:cut]
        _dropped += cut


def _flush_due_locked():
    """Whether the recorder should attempt a periodic flush (caller
    holds _lock). A failed flush backs off _FLUSH_RETRY_S so a full or
    read-only disk costs one open() per retry window, not one O(buffer)
    copy-and-fail per span."""
    return (bool(_dir) and len(_buf) >= _FLUSH_EVERY
            and time.monotonic() >= _next_flush_try)


def sampled(step):
    """True when `step` is one of the sampled steps (the trainer uses
    this to decide up front whether to stamp/fence/annotate a step)."""
    return step % _sample_every == 0


def record_span(name, t0, t1=None, step=None, cat="host", always=False,
                **extra):
    """Record one host-side span: `t0`/`t1` are raw time.perf_counter()
    readings (seconds; `t1` defaults to now), mapped onto the shared
    monotonic epoch. Sampling: `always` records unconditionally
    (compiles, checkpoints); a `step` records iff the step is sampled;
    step-less spans (input streams) sample on a per-name counter with
    the same stride. Returns True iff the span was recorded. Callers
    gate on the module bool — this function is never reached while
    disabled (ci sanity counts the calls)."""
    global _recorded, _dropped
    if not _enabled:
        return False
    if t1 is None:
        t1 = time.perf_counter()
    with _lock:
        if _buf is None:
            return False    # disabled+reset raced a recording thread
        if not always:
            if step is not None:
                if step % _sample_every:
                    return False
            else:
                n = _ticks.get(name, 0)
                _ticks[name] = n + 1
                if n % _sample_every:
                    return False
        ev = {"kind": "span", "name": name, "cat": cat,
              "ts_us": round(_util.perf_to_us(t0), 1),
              "dur_us": round((t1 - t0) * 1e6, 1), "rank": _rank()}
        if step is not None:
            ev["step"] = int(step)
        if extra:
            ev.update(extra)
        a = _agg.get((cat, name))
        if a is None:
            _agg[(cat, name)] = [1, ev["dur_us"]]
        else:
            a[0] += 1
            a[1] += ev["dur_us"]
        _buf.append(ev)
        _recorded += 1
        _trim_locked()
        due = _flush_due_locked()
    if due:
        _safe_flush()
    return True


def annotate(step):
    """Context manager wrapping one sampled step in a
    `torch.profiler.record_function` range named "mx.trace.step" whose
    arguments carry the same (rank, step) tag as the host spans, so a
    profile of the card shows the step's kernels under the step. Only
    called for sampled steps while enabled."""
    import torch
    return torch.profiler.record_function(
        "mx.trace.step", f"step={int(step)},rank={_rank()}")


# ---------------------------------------------------------------------------
# skew probe
# ---------------------------------------------------------------------------

def skew_tick(step):
    """Run the skew probe on every `trace_skew_every`-th SAMPLED step.
    The cadence is a pure function of the step id — NOT a local counter —
    because the multi-process probe is a blocking collective: every rank
    must reach it at the same global step, and a rank-local event (a
    first step at a new signature also calls this) must not
    desynchronize who probes when."""
    if not _enabled or _skew_every <= 0:
        return
    if step % _sample_every:
        return   # an always-traced (cache-miss) step that is not sampled
    if (step // _sample_every) % _skew_every:
        return
    _skew_probe(step)


def _skew_probe(step):
    """One probe: wall-stamp this rank's arrival; when
    `torch.distributed` runs more than one rank, all-gather the stamps so
    every rank sees the gang's spread and straggler live. One process
    records the local stamp alone (participants 1)."""
    global _skew_failed
    t_ns = time.time_ns()
    ts_us = _util.now_us()
    times = None
    try:
        dist = sys.modules.get("torch.distributed")
        # once a collective probe failed, never retry it this process:
        # a rank whose peers stopped answering must not block a sampled
        # step in an all-gather they will never join
        if not _skew_failed and dist is not None and dist.is_available() \
                and dist.is_initialized() and dist.get_world_size() > 1:
            out = [None] * dist.get_world_size()
            dist.all_gather_object(out, t_ns)
            times = [int(x) for x in out]
    except Exception as e:  # pragma: no cover - backend-dependent
        if not _skew_failed:
            _skew_failed = True
            import warnings
            warnings.warn(f"mx.trace skew probe unavailable: {e}; "
                          "per-rank arrival stamps still record")
    if times is None:
        times = [t_ns]
    t_min = min(times)
    spread_s = (max(times) - t_min) / 1e9
    straggler = max(range(len(times)), key=lambda i: times[i]) \
        if len(times) > 1 else _rank()
    rec = {"kind": "skew", "ts_us": round(ts_us, 1), "step": int(step),
           "rank": _rank(), "t_wall_ns": t_ns, "gen": _generation(),
           "participants": len(times), "spread_s": round(spread_s, 6),
           "straggler_rank": straggler,
           "offsets_ns": [t - t_min for t in times]}
    global _dropped
    with _lock:
        _skews.append(dict(rec))
        if len(_skews) > _MAX_SKEWS:
            del _skews[0]
        due = False
        if _buf is not None:
            _buf.append(rec)
            _trim_locked()
            due = _flush_due_locked()
    _M_SKEW.set(spread_s)
    _M_STRAGGLER.set(straggler)
    _telemetry.event("trace_skew", step=int(step), spread_s=spread_s,
                     straggler_rank=straggler, participants=len(times))
    try:
        from . import diagnostics as _diagnostics
        _diagnostics.record_event("trace", step=int(step),
                                  spread_s=spread_s,
                                  straggler_rank=straggler)
    except Exception:
        pass
    if due:
        _safe_flush()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _meta_record():
    return {"kind": "meta", "schema": 1, "rank": _rank(),
            "pid": os.getpid(), "ts": time.time(),
            "epoch_unix_ns": _util.epoch_unix_ns(),
            "gang_epoch_ns": _gang_epoch_ns(),
            "sample_every": _sample_every, "skew_every": _skew_every}


def flush(path=None):
    """Append buffered records to `path` (default: this rank's
    trace_dir/<rank>/trace.jsonl) behind a one-time-PER-TARGET meta line
    (an explicit flush to a side path must not rob the rank file of the
    epoch anchor trace_report aligns on), and clear the buffer. Returns
    the path, or None when there is no target (the buffer then stays,
    bounded)."""
    path = path or trace_path()
    if path is None:
        return None
    global _next_flush_try
    with _lock:
        recs = list(_buf) if _buf else []
        if _buf:
            del _buf[:]
        need_meta = path not in _meta_paths
        _meta_paths.add(path)
    meta_ok = not need_meta
    written = 0
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # line-buffered: each write hands its line to the OS, so
        # `written` below reflects lines actually out the door — a
        # full-buffer deferral would otherwise surface the OSError at
        # close() with every record already counted (and then lost)
        with open(path, "a", buffering=1) as f:
            if need_meta:
                f.write(json.dumps(_meta_record()) + "\n")
                meta_ok = True
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
                written += 1
    except OSError:
        # a failed write must not lose the spans _safe_flush promises
        # stay buffered — but lines already handed to the OS before the
        # failure may be in the file, so only the UNWRITTEN suffix goes
        # back (front, order kept; a torn final line is skipped by
        # trace_report's loader, not duplicated), the meta line is only
        # re-armed when it never made it out, and retries back off
        with _lock:
            if not meta_ok:
                _meta_paths.discard(path)
            if _buf is not None:
                _buf[:0] = recs[written:]
                _trim_locked()
            _next_flush_try = time.monotonic() + _FLUSH_RETRY_S
        raise
    with _lock:
        _next_flush_try = 0.0
    return path


def _safe_flush():
    """Periodic flush that must not kill the training step it observes:
    an unwritable trace_dir warns once and keeps recording in memory."""
    global _flush_warned
    try:
        flush()
    except OSError as e:
        if not _flush_warned:
            _flush_warned = True
            import warnings
            warnings.warn(f"mx.trace flush to {trace_path()!r} failed: {e}; "
                          "spans stay buffered (warning once)")


def spans(tail=None):
    """Buffered (not yet flushed) span records, oldest first. `tail`
    bounds the work to the newest N spans — a reader must not copy a
    100k-record buffer under the same lock the step hot path's
    record_span takes, just to return 64 of them."""
    with _lock:
        if not _buf:
            return []
        if tail is None:
            return [dict(r) for r in _buf if r.get("kind") == "span"]
        out = []
        if tail > 0:
            for r in reversed(_buf):
                if r.get("kind") == "span":
                    out.append(dict(r))
                    if len(out) >= tail:
                        break
            out.reverse()
        return out


def skews():
    """Skew probe records this process, oldest first (kept in memory even
    after flushes, bounded)."""
    with _lock:
        return [dict(r) for r in _skews]


def snapshot():
    """Plain-data summary for the post-mortem "trace" section: sampling
    config, span/skew volume, this rank's file, and the last measured
    skew."""
    with _lock:
        return {
            "rank": _rank(),
            "sample_every": _sample_every,
            "skew_every": _skew_every,
            "spans_recorded": _recorded,
            "spans_buffered": len(_buf or ()),
            "spans_dropped": _dropped,
            "skew_probes": len(_skews),
            "last_skew": dict(_skews[-1]) if _skews else None,
            "path": trace_path(),
        }


def skew_p99_ms():
    """p99 of the measured multi-participant arrival spreads, in ms —
    None when no probe saw more than one participant (a single process
    cannot measure gang skew by itself; the merged report can)."""
    with _lock:
        spreads = sorted(s["spread_s"] for s in _skews
                         if s.get("participants", 1) > 1)
    if not spreads:
        return None
    idx = min(len(spreads) - 1, int(round(0.99 * (len(spreads) - 1))))
    return round(spreads[idx] * 1e3, 3)


def skew_verdict():
    """Live gang-skew summary (the offline report in
    tools/trace_report.py stays the authoritative verdict — this is what
    THIS rank's probes know): the last measured arrival spread, the
    suspected straggler rank, and the p99 across probes. None before any
    probe ran."""
    with _lock:
        last = dict(_skews[-1]) if _skews else None
        probes = len(_skews)
    if last is None:
        return None
    return {
        "probes": probes,
        "step": last.get("step"),
        "participants": last.get("participants", 1),
        "spread_ms": round(last.get("spread_s", 0.0) * 1e3, 3),
        "straggler_rank": last.get("straggler_rank"),
        "skew_p99_ms": skew_p99_ms(),
    }


def critical_path():
    """This rank's dominant STEADY-STATE span — the local leg of the
    gang critical path: {"span", "cat", "fraction", "total_s"} of the
    step/input span with the most recorded time, or None before any.
    Always-recorded compile/checkpoint spans are excluded: they are
    one-off seconds-scale events that would otherwise win every run
    (warm-up time is not the critical path), the same exclusion
    tools/trace_report.py makes for its compute-bound dominant span."""
    with _lock:
        steady = {k: v for k, v in _agg.items()
                  if k[0] in ("step", "input", "serve")}
        if not steady:
            return None
        total = sum(t for _, t in steady.values())
        (cat, name), (count, t) = max(steady.items(),
                                      key=lambda kv: kv[1][1])
    if total <= 0:
        return None
    return {"span": name, "cat": cat, "fraction": round(t / total, 4),
            "total_s": round(t / 1e6, 6), "count": count}


@atexit.register
def _flush_at_exit():
    if _enabled and _dir:
        try:
            flush()
        except OSError:
            pass  # nothing useful to do with a write error at interpreter exit


if _config.get("trace") == "on":
    enable()
