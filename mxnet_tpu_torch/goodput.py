"""mx.goodput — wall-clock accounting, goodput against badput
(counterpart of `mxnet_tpu/goodput.py`).

Every survival mechanism trades wall-clock for progress — preemption
restarts, the OOM ladder, SDC rollback — and none of them says what
that costs. This module is the accounting layer: a per-rank monotone
interval accountant that classifies run wall-clock into exhaustive,
non-overlapping categories at the hook sites that already exist.

Categories (one per second of wall-clock, first claim wins):

  goodput   `step`            completed trainer step (dispatch to fence)
            `serve_decode`    serving decode dispatch (batched tokens)
  badput    `compile`         the first step at a new signature (the
                              port's compile: the step that builds the
                              kernels' launch state and, on the card,
                              allocates the step's memory — the same
                              step telemetry counts in compile_total)
            `input_stall`     train loop blocked on the staging queue
                              (prefetch; not claimed on one card)
            `checkpoint_save` / `checkpoint_restore`
            `reshard`         checkpoint/live-resize redistribution
                              (needs data replicas; not claimed on one
                              card)
            `oom_recovery`    degradation-ladder walk including the
                              retried step
            `replay`          a re-trained step at or below the step-id
                              high-water mark (guard rollback or restart
                              resume re-earning progress already paid for)
            `serve_idle`      scheduler awake with no work queued
            `serve_degraded`  decode while a slot runs degraded/requeued
  offline   `restart_downtime` (tools/goodput_report.py reconstructs it
            from generation gaps and the launcher's restarts.jsonl)
            `untracked`       wall-clock no hook claimed (host overhead)

Interval discipline: hooks report closed [t0, t1) perf_counter spans;
the accountant clamps each to start at the monotone cursor (the end of
the last accepted interval), so concurrent hooks never double-count a
second: overlap is dropped, gaps fall to `untracked`, and the
categories sum to the elapsed time by construction.

Progress semantics: `note_step` keeps a step-id high-water mark. A
completed step at or below it is `replay`, never goodput; the mark
survives a relaunch because enable() recovers it from this rank's
existing goodput.jsonl before appending the new generation's records.

Persistence: with `goodput_dir` set, intervals append at once
(line-buffered, meta line first, torn final lines healed) to
`<dir>/<rank>/goodput.jsonl`, in the JAX package's format, so
`tools/goodput_report.py` reads either package's files. High-frequency
categories (the scheduler's idle waits and decode rounds) coalesce into
one record while contiguous.

Cost model: disabled (the default), every hook site checks one module
bool and falls through; no accountant state exists. Enable with
`mx.goodput.enable()` or `MXNET_TPU_GOODPUT=on`. Enabled, a hook reads
`time.perf_counter()` around work that fences already (the trainer's
step fence, the server's host fetch of the logits): it adds no CUDA
event and no synchronisation.
"""
from __future__ import annotations

import atexit
import json
import os
import time

from . import _locklint
from . import config as _config
from . import telemetry as _telemetry
from . import util as _util

__all__ = [
    "enable", "disable", "enabled", "reset",
    "note", "note_step", "note_oom_begin", "note_resume", "note_rollback",
    "flush", "flush_summary", "goodput_path", "high_water", "snapshot",
    "CATEGORIES", "GOOD",
]

#: every category a hook can claim (report-side adds restart_downtime
#: and untracked, which no live hook can know)
CATEGORIES = (
    "step", "compile", "input_stall", "checkpoint_save",
    "checkpoint_restore", "reshard", "oom_recovery", "replay",
    "serve_decode", "serve_idle", "serve_degraded",
)
#: the categories that count as goodput — everything else is badput
GOOD = ("step", "serve_decode")

#: high-frequency categories whose contiguous intervals merge into one
#: record (totals are exact either way; only the file granularity
#: changes — one record per state transition, not per scheduler tick)
_COALESCE = ("serve_idle", "serve_decode", "serve_degraded",
             "input_stall")
_COALESCE_GAP_S = 0.010

_lock = _locklint.make_lock("goodput.accountant")
_enabled = False          # the fast-path bool; hook sites read it directly
_dir = ""                 # per-rank files under <_dir>/<rank>/goodput.jsonl
_rank_override = None
_cursor = None            # perf_counter: accounting complete up to here
_t_enable = None          # perf_counter at enable() — the elapsed anchor
_hw_step = 0              # step-id high-water mark (recovered across gens)
_oom_step = None          # step whose retry is oom_recovery
_totals = None            # {category: seconds}; None while disabled
_counts = None            # {category: intervals}
_pending = None           # coalescing tail interval (dict) not yet written
_shadowed = 0.0           # seconds dropped as already-claimed overlap
_events = 0
_meta_paths = set()
_write_warned = False

_M_FRACTION = _telemetry.gauge(
    "goodput_fraction", "fraction of wall-clock since mx.goodput was "
    "armed spent producing NEW kept progress (completed non-replayed "
    "trainer steps + serving decode) — the production metric every "
    "survival mechanism trades against")
_M_BADPUT = _telemetry.counter(
    "badput_seconds_total", "wall-clock seconds attributed to a badput "
    "cause (compile, input_stall, checkpoint_save/restore, reshard, "
    "oom_recovery, replay, serve_idle, serve_degraded), by cause")


def enabled():
    """True while the accountant is armed (hook sites read the module
    bool `_enabled` directly; this is the public spelling)."""
    return _enabled


def enable(goodput_dir=None, rank=None):
    """Arm the accountant. Arguments override the `goodput_dir` knob
    (read once here — the per-interval path never touches the config
    registry). Recovers the step-id high-water mark from this rank's
    existing goodput.jsonl so a relaunched generation classifies its
    resumed replay correctly."""
    global _enabled, _dir, _rank_override, _cursor, _t_enable
    global _hw_step, _totals, _counts
    with _lock:
        if goodput_dir is not None:
            _dir = str(goodput_dir)
        elif not _dir:
            _dir = _config.get("goodput_dir")
        if rank is not None:
            _rank_override = int(rank)
        if _totals is None:
            _totals = {}
            _counts = {}
        if _t_enable is None:
            _t_enable = time.perf_counter()
            _cursor = _t_enable
        path = goodput_path()
        if path is not None and not _hw_step:
            _hw_step = _recover_high_water(path)
        _enabled = True
    _append_record(None)     # meta line lands before any interval


def disable():
    """Disarm the hooks; a configured goodput_dir gets the pending
    coalesced tail plus a final summary record so the offline report
    sees this generation's totals and high-water mark."""
    global _enabled
    if _enabled and _dir:
        try:
            flush_summary()
        except OSError:
            pass
    _enabled = False


def reset():
    """Drop recorded state (tests and run boundaries). While disabled
    everything is released, restoring the zero-allocation fast path."""
    global _dir, _rank_override, _cursor, _t_enable, _hw_step, _oom_step
    global _totals, _counts, _pending, _shadowed, _events, _write_warned
    with _lock:
        _pending = None
        _shadowed = 0.0
        _events = 0
        _oom_step = None
        _meta_paths.clear()
        _write_warned = False
        if _enabled:
            _totals = {}
            _counts = {}
            _t_enable = time.perf_counter()
            _cursor = _t_enable
            _hw_step = 0
        else:
            _totals = None
            _counts = None
            _t_enable = None
            _cursor = None
            _hw_step = 0
            _dir = ""
            _rank_override = None


def _rank():
    if _rank_override is not None:
        return _rank_override
    for var in ("RANK", "JAX_PROCESS_ID", "DMLC_WORKER_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _generation():
    """Which relaunch generation this process belongs to (the
    supervised-relaunch counter tools/launch.py exports; 0 standalone)."""
    try:
        return int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        return 0


def _gang_epoch_ns():
    """The shared gang epoch the launcher exports (one wall timestamp
    for the whole gang, fixed across relaunch generations), or None
    standalone. Shared with mx.trace so the report's chrome badput lane
    aligns with trace_report's timeline."""
    v = os.environ.get("MXNET_TPU_TRACE_EPOCH_NS")
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def goodput_path():
    """Where this rank's interval file lands (None when goodput_dir is
    unset)."""
    if not _dir:
        return None
    return os.path.join(_dir, str(_rank()), "goodput.jsonl")


def high_water():
    """The step-id high-water mark: the largest step id this rank (or,
    after a relaunch, any prior generation of it) ever completed. Steps
    at or below it are replay."""
    return _hw_step


def _recover_high_water(path):
    """Max completed step id across the prior generations' records in
    this rank's file (torn/garbage lines skipped — a SIGKILLed writer
    is the expected author)."""
    hw = 0
    try:
        f = open(path)
    except OSError:
        return 0
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            for field in ("step", "hw_step"):
                v = rec.get(field)
                if isinstance(v, int) and v > hw:
                    hw = v
    return hw


# ---------------------------------------------------------------------------
# the interval accountant
# ---------------------------------------------------------------------------

def note(cat, t0, t1=None, step=None, **extra):
    """Account one closed interval [t0, t1) of this rank's wall-clock to
    `cat` (raw time.perf_counter() seconds; t1 defaults to now). The
    start is clamped to the monotone cursor so concurrent hooks never
    double-count: a fully shadowed interval is dropped (counted in
    `shadowed_s`), a partially shadowed one keeps its tail. Callers
    gate on the module bool — this function is never reached while
    disabled."""
    global _cursor, _pending, _shadowed, _events
    if not _enabled:
        return False
    if t1 is None:
        t1 = time.perf_counter()
    write_out = []
    with _lock:
        if _totals is None:
            return False     # disabled+reset raced a recording thread
        lo = t0 if _cursor is None else max(t0, _cursor)
        if t1 <= lo:
            _shadowed += max(0.0, t1 - t0)
            return False
        _cursor = t1
        dur = t1 - lo
        _totals[cat] = _totals.get(cat, 0.0) + dur
        _counts[cat] = _counts.get(cat, 0) + 1
        _events += 1
        frac = _fraction_locked(t1)
        if _dir:
            p = _pending
            mergeable = cat in _COALESCE and step is None and not extra
            if (p is not None and p["cat"] == cat and mergeable
                    and lo - p["_end"] <= _COALESCE_GAP_S):
                p["dur_us"] = round((t1 - p["_t0"]) * 1e6, 1)
                p["n"] = p.get("n", 1) + 1
                p["_end"] = t1
            else:
                if p is not None:
                    write_out.append(p)
                rec = {"kind": "int", "cat": cat,
                       "t0_us": round(_util.perf_to_us(lo), 1),
                       "dur_us": round(dur * 1e6, 1),
                       "_t0": lo, "_end": t1}
                if step is not None:
                    rec["step"] = int(step)
                if extra:
                    rec.update(extra)
                if mergeable:
                    # a coalescing candidate waits for its run to end
                    _pending = rec
                else:
                    # everything else lands NOW — a SIGKILLed rank must
                    # keep every completed step interval (the recovered
                    # high-water mark depends on it)
                    _pending = None
                    write_out.append(rec)
    for rec in write_out:
        _append_record(rec)
    if _telemetry._enabled:
        if cat not in GOOD:
            _M_BADPUT.labels(cause=cat).inc(dur)
        _M_FRACTION.set(round(frac, 4))
    return True


def note_step(step, t_build, t_step, t_done):
    """Classify one COMPLETED trainer step: `replay` at or below the
    high-water mark (a rollback or restart re-earning paid-for
    progress), `oom_recovery` when it is the degradation ladder's
    retried step, `compile` on any other first step at a new signature
    (`t_build` not None: build through fence), `step` (goodput)
    otherwise."""
    global _hw_step, _oom_step
    step = int(step)
    extra = {}
    with _lock:
        if _totals is None:
            return False
        replay = step <= _hw_step
        if replay:
            extra["hw"] = _hw_step
        else:
            _hw_step = step
        oom = _oom_step is not None and step == _oom_step
        if _oom_step is not None and step >= _oom_step:
            _oom_step = None
    if replay:
        cat = "replay"
        if t_build is not None:
            extra["compile"] = True
    elif oom:
        cat = "oom_recovery"
        if t_build is not None:
            extra["compile"] = True
    elif t_build is not None:
        cat = "compile"
    else:
        cat = "step"
    t0 = t_build if t_build is not None else t_step
    return note(cat, t0, t_done, step=step, **extra)


def note_oom_begin(step):
    """mx.memsafe marks the step it is recovering: that step's retry
    counts `oom_recovery` (recompute overhead), not `compile`."""
    global _oom_step
    _oom_step = int(step)


def note_resume(step):
    """mx.resilience restored a checkpoint: an event marker (no
    wall-clock claim) so the report can verify replayed-step count ==
    high-water minus the restored step."""
    _event("resume", step=int(step), hw=_hw_step)


def note_rollback(step, restored):
    """mx.guard rolled the gang back (SDC): event marker naming the
    failing step and the verified step actually restored."""
    _event("rollback", step=int(step), restored=int(restored),
           hw=_hw_step)


def _event(ev, **fields):
    global _events
    if not _enabled:
        return
    with _lock:
        _events += 1
    rec = {"kind": "ev", "ev": ev, "t_us": round(_util.now_us(), 1)}
    rec.update(fields)
    flush()                  # keep the file time-ordered past the marker
    _append_record(rec)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _meta_record():
    return {"kind": "meta", "schema": 1, "rank": _rank(),
            "pid": os.getpid(), "ts": time.time(),
            "epoch_unix_ns": _util.epoch_unix_ns(),
            "gang_epoch_ns": _gang_epoch_ns(),
            "gen": _generation(), "hw_step": _hw_step,
            "t_start_us": round(_util.perf_to_us(_t_enable), 1)
            if _t_enable is not None else None}


def _strip(rec):
    return {k: v for k, v in rec.items() if not k.startswith("_")}


def _append_record(rec):
    """Append one record (None = just ensure the meta line) to this
    rank's goodput.jsonl: meta line first, once per path; a torn final
    line left by a SIGKILLed writer is healed by starting fresh (the
    fragment itself is skipped by readers). An unwritable dir warns
    once and drops records: the JAX package's documented behaviour (an
    accountant must not take the workload down with it)."""
    global _write_warned
    path = goodput_path()
    if path is None:
        return False
    with _lock:
        need_meta = path not in _meta_paths
        _meta_paths.add(path)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prefix = ""
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        prefix = "\n"          # heal the torn line
        except OSError:
            pass                               # fresh file
        with open(path, "a", buffering=1) as f:
            if need_meta:
                f.write(prefix + json.dumps(_meta_record()) + "\n")
                prefix = ""
            if rec is not None:
                f.write(prefix + json.dumps(_strip(rec)) + "\n")
        return True
    except OSError as e:
        with _lock:
            if need_meta:
                _meta_paths.discard(path)
        if not _write_warned:
            _write_warned = True
            import warnings
            warnings.warn(f"mx.goodput: interval write to {path!r} "
                          f"failed: {e}; records are dropped "
                          "(warning once)")
        return False


def flush():
    """Write out the coalescing tail interval (idle/decode runs merge in
    memory until the category changes — an explicit flush closes the
    run so readers see everything accounted so far)."""
    global _pending
    with _lock:
        rec, _pending = _pending, None
    if rec is not None:
        _append_record(rec)
    return goodput_path()


def flush_summary():
    """Append this generation's summary record (totals, elapsed,
    high-water) after flushing the tail. Called by disable() and at
    interpreter exit; safe to call repeatedly (readers keep the last
    per generation)."""
    flush()
    snap = snapshot()
    rec = {"kind": "summary", "schema": 1, "rank": _rank(),
           "gen": _generation(), "ts": time.time(),
           "t_end_us": round(_util.now_us(), 1),
           "elapsed_s": snap["elapsed_s"],
           "categories": snap["categories"],
           "hw_step": snap["hw_step"],
           "shadowed_s": snap["shadowed_s"]}
    if _append_record(rec):
        return goodput_path()
    return None


# ---------------------------------------------------------------------------
# live surfaces
# ---------------------------------------------------------------------------

def _fraction_locked(now):
    if _t_enable is None or _totals is None:
        return 0.0
    elapsed = max(1e-9, now - _t_enable)
    good = sum(_totals.get(c, 0.0) for c in GOOD)
    return min(1.0, good / elapsed)


def snapshot():
    """The live `goodput` section mx.scope /statusz serves and the
    diagnostics post-mortem embeds (plain dict): per-category seconds,
    the goodput fraction of elapsed, untracked remainder, top badput
    cause, and the progress high-water mark."""
    now = time.perf_counter()
    with _lock:
        totals = dict(_totals or {})
        counts = dict(_counts or {})
        t_en = _t_enable
        hw = _hw_step
        shadowed = _shadowed
        events = _events
    elapsed = max(0.0, now - t_en) if t_en is not None else 0.0
    good = sum(v for c, v in totals.items() if c in GOOD)
    bad = sum(v for c, v in totals.items() if c not in GOOD)
    untracked = max(0.0, elapsed - good - bad)
    badput = {c: v for c, v in totals.items() if c not in GOOD}
    top = max(badput.items(), key=lambda kv: kv[1])[0] if badput else None
    return {
        "enabled": _enabled,
        "rank": _rank(),
        "gen": _generation(),
        "elapsed_s": round(elapsed, 3),
        "goodput_s": round(good, 3),
        "badput_s": round(bad, 3),
        "untracked_s": round(untracked, 3),
        "goodput_fraction": round(good / elapsed, 4) if elapsed else None,
        "top_badput_cause": top,
        "categories": {c: round(v, 3) for c, v in sorted(totals.items())},
        "intervals": counts,
        "events": events,
        "shadowed_s": round(shadowed, 4),
        "hw_step": hw,
        "path": goodput_path(),
    }


@atexit.register
def _summary_at_exit():
    if _enabled and _dir:
        try:
            flush_summary()
        except OSError:
            pass  # nothing useful to do with a write error at exit


if _config.get("goodput") == "on":
    enable()
