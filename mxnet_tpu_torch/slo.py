"""mx.slo — per-request serving observability (counterpart of
`mxnet_tpu/slo.py`).

Telemetry, trace and scope are step- or rank-scoped; this module is
request-scoped: it turns the server's verdict counters into
attributable per-request latency budgets. Three pieces:

  * **request journal** — while armed, every `serve.Request` carries a
    monotone event timeline (submit, admit/reject/shed, first dispatch,
    per-token generation timestamps → time-between-tokens, stream
    delivery timestamps, degradation/requeue/retry transitions, the
    terminal verdict), recorded at the server's lifecycle points.
    Timestamps are `time.perf_counter()` readings mapped onto the
    port's shared trace epoch (`util.perf_to_us`), so journals and
    mx.trace spans, which carry the request id in their args, join on
    one timeline.
  * **SLO objectives and burn rate** — the `slo_ttft_ms` / `slo_tbt_ms`
    / `slo_availability` knobs classify each terminated request good or
    bad. Classifications feed a multi-window rolling error-budget
    tracker (`BurnTracker`, injectable clock): burn rate = observed bad
    fraction / allowed bad fraction (1 - slo_availability), per window
    (fast 5 min and slow 1 h by default). Burn above `slo_burn_alert`
    emits a telemetry alert event, a diagnostics flight-ring entry and
    an alert record in the access log.
  * **tail-sampled exemplars** — full journals persist to
    `slo_dir/<rank>/access.jsonl` only for SLO-violating, degraded or
    slower-than-running-p99 requests, plus a 1-in-`slo_sample_every`
    healthy sample. The records are the JAX package's, so
    `tools/slo_report.py` renders either package's files; mx.scope
    `/statusz` serves the live `slo` section.

Classification: `completed` requests are good unless an enabled latency
objective is violated (TTFT is client-visible — first delivered token
when a consumer streams, first generated token otherwise; TBT is the
worst gap between consecutive generated tokens). `rejected` / `shed` /
`expired` / `failed` requests violate availability. `cancelled`
requests are the client's own doing and are excluded from the error
budget (still journaled).

On the card a generated token's timestamp is taken after the round's
host fetch of the logits, which is the round's fence already: the
journal adds no synchronisation.

Cost model: disabled (the default), every hook site in serve.py checks
one module bool and allocates nothing (`Request._slo_j` stays None).
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time

from . import _locklint
from . import config as _config
from . import diagnostics as _diagnostics
from . import telemetry as _telemetry
from . import util as _util

__all__ = [
    "enable", "disable", "enabled", "reset", "snapshot", "BurnTracker",
    "Journal", "access_path", "flush_summary", "objectives",
]

# reentrant: _finalize holds the lock while the burn tracker fires
# _on_alert, which records the first-alert marker and appends the alert
# record under the same lock
_lock = _locklint.make_rlock("slo.module")
_enabled = False            # the fast-path bool; serve hook sites read it
_dir = ""                   # exemplar base dir ("" = classify only)
_rank_override = None
_clock = time.monotonic     # burn-window clock (injectable for tests)
_tracker = None             # BurnTracker while enabled
_sample_every = 10
_objectives = None          # dict while enabled
_seq = 0                    # finalized-request counter (drives sampling)
_meta_paths = set()
_write_warned = False
_first_alert = None         # {"window","burn","ts_s","wall"} of alert #1

# bounded aggregates for snapshot()/bench (client-visible milliseconds)
_MAX_SAMPLES = 4096
_ttfts = collections.deque(maxlen=_MAX_SAMPLES)
_tbts = collections.deque(maxlen=_MAX_SAMPLES)
_counts = collections.Counter()        # terminal outcome -> requests
_violations = collections.Counter()    # objective -> bad classifications
_phase_ms = {"queue": 0.0, "prefill": 0.0, "decode": 0.0, "stream": 0.0}
_phase_n = 0
_exemplars = 0

_M_BURN = _telemetry.gauge(
    "slo_burn_rate", "rolling error-budget burn rate per window (bad "
    "fraction / allowed bad fraction; 1.0 consumes the budget exactly "
    "at the sustainable rate, above slo_burn_alert fires an alert)")
_M_REQS = _telemetry.counter(
    "slo_requests_total", "terminated serving requests classified "
    "against the SLO objectives, by verdict (good / bad; cancelled "
    "requests are excluded from the error budget)")
_M_VIOL = _telemetry.counter(
    "slo_violations_total", "SLO objective violations by objective "
    "(ttft / tbt / availability) — one request may violate several")
_M_ALERTS = _telemetry.counter(
    "slo_alerts_total", "burn-rate alerts fired, by window")
_M_EXEMPLARS = _telemetry.counter(
    "slo_exemplars_total", "request journals persisted to access.jsonl "
    "(tail-sampled: bad / degraded / slow-p99 / 1-in-N)")


def enabled():
    """True while mx.slo is armed (serve's hook sites read the module
    bool `_enabled` directly; this is the public spelling)."""
    return _enabled


def enable(slo_dir=None, rank=None, clock=None, sample_every=None):
    """Arm per-request journaling. Arguments override the `slo_dir` /
    `slo_sample_every` knobs (read once here — the per-token hot path
    never touches the config registry). `clock` injects the burn-window
    clock for deterministic tests."""
    global _enabled, _dir, _rank_override, _clock, _tracker
    global _sample_every, _objectives
    with _lock:
        if slo_dir is not None:
            _dir = str(slo_dir)
        elif not _dir:
            _dir = _config.get("slo_dir")
        if rank is not None:
            _rank_override = int(rank)
        if clock is not None:
            _clock = clock
        _sample_every = int(sample_every if sample_every is not None
                            else _config.get("slo_sample_every"))
        _objectives = {
            "ttft_ms": float(_config.get("slo_ttft_ms")),
            "tbt_ms": float(_config.get("slo_tbt_ms")),
            "availability": float(_config.get("slo_availability")),
        }
        if _tracker is None:
            _tracker = BurnTracker(
                availability=_objectives["availability"],
                windows=(("fast", float(_config.get("slo_window_fast_s"))),
                         ("slow", float(_config.get("slo_window_slow_s")))),
                alert=float(_config.get("slo_burn_alert")),
                clock=_clock, on_alert=_on_alert)
        _enabled = True


def disable():
    """Disarm the hooks; a configured access log gets a final summary
    record so offline reports see the window verdicts."""
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
    global _dir, _rank_override, _clock, _tracker, _sample_every
    global _objectives, _seq, _write_warned, _first_alert, _phase_n
    global _exemplars
    with _lock:
        _ttfts.clear()
        _tbts.clear()
        _counts.clear()
        _violations.clear()
        for k in _phase_ms:
            _phase_ms[k] = 0.0
        _phase_n = 0
        _seq = 0
        _exemplars = 0
        _meta_paths.clear()
        _write_warned = False
        _first_alert = None
        _tracker = None
        if not _enabled:
            _dir = ""
            _rank_override = None
            _clock = time.monotonic
            _objectives = None


def objectives():
    """The armed objective thresholds (None while disabled)."""
    return dict(_objectives) if _objectives else None


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


def access_path():
    """Where this rank's exemplar journals land (None when slo_dir is
    unset)."""
    if not _dir:
        return None
    return os.path.join(_dir, str(_rank()), "access.jsonl")


# ---------------------------------------------------------------------------
# burn-rate tracker
# ---------------------------------------------------------------------------

class BurnTracker:
    """Multi-window rolling error-budget burn rate (SRE-style).

    Each classification lands in a coarse time bucket; a window's burn
    rate is its bad fraction divided by the allowed bad fraction
    (1 - availability target). 1.0 burns the budget exactly at the
    sustainable rate; `alert`+ fires `on_alert(window, burn)` once per
    excursion (re-arming only after the window cools below the
    threshold). The FAST window spikes on a fresh overload while the
    SLOW window is still diluted by history — and conversely stays hot
    after a long burn the fast window has already forgotten: alert on
    fast to react, on slow to confirm. The clock is injectable so the
    window math is deterministically testable."""

    def __init__(self, availability=0.999, windows=(("fast", 300.0),
                                                    ("slow", 3600.0)),
                 alert=2.0, clock=time.monotonic, on_alert=None):
        self.budget = max(1e-9, 1.0 - float(availability))
        self.windows = [(str(n), float(s)) for n, s in windows]
        self.alert = float(alert)
        self._clock = clock
        self._on_alert = on_alert
        self._span = max(s for _, s in self.windows)
        # bucket granularity: 1/60th of the fastest window (5 s for 5 m)
        self._bucket_s = max(0.001, min(s for _, s in self.windows) / 60.0)
        self._buckets = collections.deque()   # [start_s, good, bad]
        self._alerting = {n: False for n, _ in self.windows}
        self.alerts = collections.Counter()   # window -> alerts fired

    def record(self, good, now=None):
        """Classify one terminated request into the current bucket and
        re-evaluate every window's burn rate (firing alerts)."""
        now = self._clock() if now is None else now
        start = now - (now % self._bucket_s)
        if self._buckets and self._buckets[-1][0] == start:
            b = self._buckets[-1]
        else:
            b = [start, 0, 0]
            self._buckets.append(b)
        b[1 if good else 2] += 1
        self._prune(now)
        rates = self.burn_rates(now)
        for name, _span in self.windows:
            rate = rates.get(name)
            if rate is None:
                continue
            if rate >= self.alert:
                if not self._alerting[name]:
                    self._alerting[name] = True
                    self.alerts[name] += 1
                    if self._on_alert is not None:
                        self._on_alert(name, rate)
            else:
                self._alerting[name] = False
        return rates

    def _prune(self, now):
        horizon = now - self._span - self._bucket_s
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def burn_rates(self, now=None):
        """{window_name: burn rate} — None for a window that saw no
        classified traffic (no data is not 'no burn')."""
        now = self._clock() if now is None else now
        out = {}
        for name, span in self.windows:
            good = bad = 0
            for start, g, b in self._buckets:
                if start > now - span:
                    good += g
                    bad += b
            total = good + bad
            out[name] = None if total == 0 \
                else (bad / total) / self.budget
        return out


def _on_alert(window, burn):
    global _first_alert
    rec = {"window": window, "burn": round(burn, 3),
           "ts_s": round(_clock(), 3), "wall": time.time()}
    with _lock:
        if _first_alert is None:
            _first_alert = dict(rec)
    print(f"mx.slo: error budget burning hot: window={window} "
          f"burn_rate={burn:.2f} (alert threshold "
          f"{_tracker.alert if _tracker else '?'})", file=sys.stderr)
    if _telemetry._enabled:
        _M_ALERTS.labels(window=window).inc()
        _telemetry.event("slo_alert", **rec)
    if _diagnostics._enabled:
        _diagnostics.record_event("slo", action="burn_alert", **rec)
    _append_record({"kind": "alert", **rec})


# ---------------------------------------------------------------------------
# request journal
# ---------------------------------------------------------------------------

class Journal:
    """The per-request event timeline. All `*_pc` fields are raw
    time.perf_counter() readings (seconds) on the shared trace epoch;
    `events` holds (pc, kind, extra-dict-or-None) transitions beyond
    the dedicated fields."""

    __slots__ = ("req_id", "submit_pc", "admit_pc", "dispatch_pc",
                 "token_pcs", "deliver_first_pc", "deliver_last_pc",
                 "delivered", "stream_open", "events", "retries",
                 "outcome", "verdict", "finish_pc", "finalized",
                 "bucket")

    def __init__(self, req_id, submit_pc):
        self.req_id = req_id
        self.submit_pc = submit_pc
        self.admit_pc = None
        self.dispatch_pc = None          # first decode dispatch
        self.token_pcs = []              # generation time per NEW token
        self.deliver_first_pc = None     # stream-side (client-visible)
        self.deliver_last_pc = None
        self.delivered = 0
        self.stream_open = False
        self.events = []
        self.retries = 0
        self.outcome = None
        self.verdict = None
        self.finish_pc = None
        self.finalized = False
        self.bucket = None

    # -- derived timings (milliseconds; None when the phase never ran) --
    def queue_ms(self):
        if self.admit_pc is None:
            return None
        return (self.admit_pc - self.submit_pc) * 1e3

    def prefill_ms(self):
        """Admission to the first generated token: the prompt's prefill
        (dense: through the decode step; paged: chunked)."""
        if self.admit_pc is None or not self.token_pcs:
            return None
        return (self.token_pcs[0] - self.admit_pc) * 1e3

    def decode_ms(self):
        if len(self.token_pcs) < 2:
            return None
        return (self.token_pcs[-1] - self.token_pcs[0]) * 1e3

    def stream_ms(self):
        """First-token delivery lag: generation to the client actually
        receiving it (None when nobody streamed)."""
        if self.deliver_first_pc is None or not self.token_pcs:
            return None
        return max(0.0, (self.deliver_first_pc - self.token_pcs[0]) * 1e3)

    def ttft_ms(self):
        """CLIENT-visible time to first token: submit to first delivery
        when a consumer streamed, submit to first generation otherwise."""
        if self.deliver_first_pc is not None:
            return (self.deliver_first_pc - self.submit_pc) * 1e3
        if self.token_pcs:
            return (self.token_pcs[0] - self.submit_pc) * 1e3
        return None

    def tbt_ms(self):
        """Gaps between consecutive generated tokens, in ms (includes a
        requeue's replay pause — the client really waited that long)."""
        pcs = self.token_pcs
        return [(b - a) * 1e3 for a, b in zip(pcs, pcs[1:])]

    def timeline(self):
        """The monotone event timeline, ms relative to submit."""
        rel = lambda pc: round((pc - self.submit_pc) * 1e3, 3)  # noqa: E731
        out = [{"t_ms": 0.0, "event": "submit"}]
        if self.admit_pc is not None:
            ev = {"t_ms": rel(self.admit_pc), "event": "admit"}
            if self.bucket is not None:
                ev["bucket"] = self.bucket
            out.append(ev)
        if self.dispatch_pc is not None:
            out.append({"t_ms": rel(self.dispatch_pc),
                        "event": "first_dispatch"})
        if self.token_pcs:
            out.append({"t_ms": rel(self.token_pcs[0]),
                        "event": "first_token"})
        for pc, kind, extra in self.events:
            ev = {"t_ms": rel(pc), "event": kind}
            if extra:
                ev.update(extra)
            out.append(ev)
        if self.deliver_first_pc is not None:
            out.append({"t_ms": rel(self.deliver_first_pc),
                        "event": "first_delivery"})
        if self.finish_pc is not None:
            ev = {"t_ms": rel(self.finish_pc), "event": "finish"}
            if self.outcome:
                ev["outcome"] = self.outcome
            if self.verdict:
                ev["verdict"] = self.verdict
            out.append(ev)
        out.sort(key=lambda e: e["t_ms"])
        return out


# -- serve.py hook sites (callers gate on the module bool: none of these
#    is ever reached while disabled) -------------------------------------

def note_submit(req):
    """Attach a journal at submit time — before any admission verdict,
    so rejected/shed requests are journaled too."""
    req._slo_j = Journal(req.id, req._submit_perf)


def note_admit(req, bucket):
    j = req._slo_j
    j.admit_pc = req._admit_perf
    j.bucket = int(bucket)


def note_first_dispatch(req):
    j = req._slo_j
    if j.dispatch_pc is None:
        j.dispatch_pc = time.perf_counter()


def note_token(req):
    """Generation timestamp for one NEW token (serve._emit's replay
    high-water mark keeps requeue replays from double-stamping)."""
    req._slo_j.token_pcs.append(time.perf_counter())


def note_event(req, kind, **extra):
    """Degradation / requeue / retry transition on the timeline."""
    j = req._slo_j
    if kind == "retry":
        j.retries += 1
    j.events.append((time.perf_counter(), str(kind), extra or None))


def note_stream_start(req):
    j = req._slo_j
    if not j.finalized:
        j.stream_open = True


def note_delivered(req):
    """Client-side delivery stamp (after any slow_client stall) — the
    half of TTFT the scheduler cannot see."""
    j = req._slo_j
    pc = time.perf_counter()
    if j.deliver_first_pc is None:
        j.deliver_first_pc = pc
    j.deliver_last_pc = pc
    j.delivered += 1


def note_stream_end(req):
    """The consumer finished (sentinel, break, or GC'd generator):
    delivery timestamps are complete — finalize if the request already
    terminated."""
    j = req._slo_j
    j.stream_open = False
    if j.outcome is not None:
        _finalize(req, j)


def note_finish(req, outcome, verdict):
    """Terminal transition. Finalizes (classify + maybe persist) now
    unless a live stream consumer is still draining delivery stamps —
    then note_stream_end finalizes with the client-visible timings."""
    j = req._slo_j
    j.outcome = str(outcome)
    j.verdict = verdict
    j.finish_pc = req._finish_perf or time.perf_counter()
    if not j.stream_open:
        _finalize(req, j)


# ---------------------------------------------------------------------------
# classification, aggregation, exemplar persistence
# ---------------------------------------------------------------------------

def _percentile(vals, q):
    if not vals:
        return None
    s = sorted(vals)
    idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
    return s[idx]


def _classify(j):
    """The SLO verdict for one terminated request: (good, [objective
    violations]). Cancelled requests return (None, []) — excluded."""
    if j.outcome == "cancelled":
        return None, []
    bad = []
    if j.outcome != "completed":
        bad.append("availability")
    obj = _objectives or {}
    ttft = j.ttft_ms()
    limit = obj.get("ttft_ms") or 0.0
    if limit > 0 and ttft is not None and ttft > limit:
        bad.append("ttft")
    limit = obj.get("tbt_ms") or 0.0
    if limit > 0:
        gaps = j.tbt_ms()
        if gaps and max(gaps) > limit:
            bad.append("tbt")
    return not bad, bad


def _finalize(req, j):
    """Classify against the objectives, feed the burn windows and
    aggregates, and tail-sample the full journal into access.jsonl."""
    global _seq, _phase_n, _exemplars
    with _lock:
        if j.finalized:
            return
        j.finalized = True
        _seq += 1
        seq = _seq
        good, violated = _classify(j)
        _counts[j.outcome] += 1
        for obj in violated:
            _violations[obj] += 1
        ttft = j.ttft_ms()
        slow_p99 = False
        if ttft is not None:
            if len(_ttfts) >= 20:
                p99 = _percentile(_ttfts, 99)
                slow_p99 = p99 is not None and ttft >= p99
            _ttfts.append(ttft)
        for gap in j.tbt_ms():
            _tbts.append(gap)
        phases = {"queue": j.queue_ms(), "prefill": j.prefill_ms(),
                  "decode": j.decode_ms(), "stream": j.stream_ms()}
        if any(v is not None for v in phases.values()):
            _phase_n += 1
            for k, v in phases.items():
                if v is not None:
                    _phase_ms[k] += v
        rates = _tracker.record(good) if _tracker is not None \
            and good is not None else {}
    if _telemetry._enabled:
        if good is not None:
            _M_REQS.labels(verdict="good" if good else "bad").inc()
        for obj in violated:
            _M_VIOL.labels(objective=obj).inc()
        for w, r in rates.items():
            if r is not None:
                _M_BURN.labels(window=w).set(round(r, 4))
    why = []
    if violated:
        why.append("slo:" + ",".join(violated))
    if req.degraded or req.requeues:
        why.append("degraded")
    if slow_p99:
        why.append("slow-p99")
    if _sample_every > 0 and seq % _sample_every == 0:
        why.append("sampled")
    if why and _dir:
        if _append_record(_access_record(req, j, good, violated, why,
                                         phases)):
            with _lock:
                _exemplars += 1
            if _telemetry._enabled:
                _M_EXEMPLARS.inc()


def _access_record(req, j, good, violated, why, phases):
    gaps = j.tbt_ms()
    rec = {
        "kind": "access", "schema": 1, "rank": _rank(), "req": j.req_id,
        "outcome": j.outcome, "verdict": j.verdict,
        "good": good, "violations": violated, "why": why,
        "prompt_len": int(req.prompt.size),
        "requested_new": req.requested_new_tokens,
        "new_tokens": len(req.tokens),
        "delivered": j.delivered,
        "requeues": req.requeues, "degraded": req.degraded,
        "retries": j.retries,
        "queue_ms": _r3(phases["queue"]),
        "prefill_ms": _r3(phases["prefill"]),
        "decode_ms": _r3(phases["decode"]),
        "stream_ms": _r3(phases["stream"]),
        "ttft_ms": _r3(j.ttft_ms()),
        "tbt_max_ms": _r3(max(gaps)) if gaps else None,
        "tbt_p99_ms": _r3(_percentile(gaps, 99)) if gaps else None,
        "submit_us": round(_util.perf_to_us(j.submit_pc), 1),
        "timeline": j.timeline(),
    }
    return rec


def _r3(v):
    return None if v is None else round(v, 3)


def _meta_record():
    return {"kind": "meta", "schema": 1, "rank": _rank(),
            "pid": os.getpid(), "ts": time.time(),
            "epoch_unix_ns": _util.epoch_unix_ns(),
            "objectives": dict(_objectives or {}),
            "sample_every": _sample_every}


def _append_record(rec):
    """Append one record to this rank's access.jsonl (meta line first,
    once per path). Exemplars are tail-sampled — rare by design — so a
    plain line-buffered append is the right tool. An unwritable dir
    warns once and drops records: the JAX package's documented
    behaviour (journaling must not take the serving path down)."""
    global _write_warned
    path = access_path()
    if path is None:
        return False
    with _lock:
        need_meta = path not in _meta_paths
        _meta_paths.add(path)
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a", buffering=1) as f:
            if need_meta:
                f.write(json.dumps(_meta_record()) + "\n")
            f.write(json.dumps(rec) + "\n")
        return True
    except OSError as e:
        with _lock:
            if need_meta:
                _meta_paths.discard(path)
        if not _write_warned:
            _write_warned = True
            import warnings
            warnings.warn(f"mx.slo: access log write to {path!r} failed: "
                          f"{e}; exemplars are dropped (warning once)")
        return False


def flush_summary():
    """Append a summary record (window burn rates, counts, percentiles)
    to access.jsonl — the offline half of the SLO verdict. Called by
    disable(); safe to call repeatedly (each call appends a fresher
    summary; slo_report keeps the last per rank)."""
    snap = snapshot()
    snap["kind"] = "summary"
    snap["schema"] = 1
    snap["rank"] = _rank()
    snap["ts"] = time.time()
    if _append_record(snap):
        return access_path()
    return None


def snapshot():
    """The live `slo` section mx.scope /statusz serves (plain dict,
    merged across ranks by the gang aggregator): per-outcome counts,
    TTFT/TBT percentiles, phase shares, burn rates, violations."""
    with _lock:
        ttfts = list(_ttfts)
        tbts = list(_tbts)
        counts = dict(_counts)
        viol = dict(_violations)
        phase = dict(_phase_ms)
        n = _phase_n
        tracker = _tracker
        first_alert = dict(_first_alert) if _first_alert else None
        exemplars = _exemplars
    total_phase = sum(phase.values())
    out = {
        "enabled": _enabled,
        "objectives": dict(_objectives or {}),
        "counts": counts,
        "classified": sum(counts.values()),
        "ttft_p50_ms": _r3(_percentile(ttfts, 50)),
        "ttft_p99_ms": _r3(_percentile(ttfts, 99)),
        "tbt_p50_ms": _r3(_percentile(tbts, 50)),
        "tbt_p99_ms": _r3(_percentile(tbts, 99)),
        "violations": viol,
        "phase_share": {k: round(v / total_phase, 4) if total_phase else
                        None for k, v in phase.items()},
        "phase_ms_mean": {k: _r3(v / n) if n else None
                          for k, v in phase.items()},
        "burn_rate": {w: (None if r is None else round(r, 4))
                      for w, r in (tracker.burn_rates().items()
                                   if tracker else ())},
        "alerts": dict(tracker.alerts) if tracker else {},
        "first_alert": first_alert,
        "exemplars_written": exemplars,
        "access_path": access_path(),
    }
    return out


if _config.get("slo") == "on":
    enable()
