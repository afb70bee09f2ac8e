"""mx.scope — live per-rank introspection endpoints and on-demand
device profiling (counterpart of `mxnet_tpu/scope.py`).

Telemetry, diagnostics, inspect and trace write files that a report
reads after the run. A job serving live traffic needs its state
queryable while it runs: Prometheus scrapes, liveness probes, and a
profile of the card taken without a restart. This module is that
control plane: a stdlib-only (`http.server`) per-rank HTTP server
exposing

  * ``/healthz``  — rank liveness: pid, current step, seconds since the
    last completed step, and the mx.guard heartbeat age when guard is
    armed.
  * ``/metrics``  — the mx.telemetry registry in Prometheus text
    exposition format (`telemetry.dump_prometheus`, rendered under the
    registry lock, never through a file).
  * ``/statusz``  — one JSON view: current step and step rate, the
    diagnostics flight-ring tail, mx.memsafe headroom and the active
    remat/grad-accum rungs, `serve.Server.stats()` for every live server
    (`serve.servers()`), the slo, goodput and guard sections, the
    mx.trace skew verdict and the relaunch generation.
  * ``/tracez``   — the last N buffered mx.trace spans and skew probes.
  * ``/profilez?steps=N`` — on-demand capture of the card: arms
    `profiler.start_jax_trace`/`stop_jax_trace` (a `torch.profiler`
    session of CPU and CUDA activity whose chrome trace names the
    port's kernels by their CUDA names) around the next N trainer steps
    through the step hook (started and stopped at step boundaries on the
    trainer thread) and returns the trace directory. A second request
    while one capture is armed or active gets 409.

`tools/launch.py --scope-port P` gives rank R the port P + 1 + R and
serves a gang aggregator on P; `tools/scope_top.py` renders it.

Cost model: disabled (the default), the trainer hook site checks one
module bool and falls through; no thread runs, no socket listens.
Enable with `mx.scope.enable()` or `MXNET_TPU_SCOPE=on`. The server
binds 127.0.0.1 by default. A forked worker inherits no server: the
child clears the module's slots and closes its copy of the socket.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from . import _locklint
from . import config as _config
from . import diagnostics as _diagnostics
from . import guard as _guard
from . import profiler as _profiler
from . import telemetry as _telemetry
from . import trace as _trace

__all__ = [
    "enable", "disable", "enabled", "reset", "maybe_enable",
    "on_step", "port", "url",
    "healthz", "statusz", "tracez", "request_profile", "profile_status",
    "ProfileBusy", "ScopeServer", "ScopeState",
]

_lock = _locklint.make_lock("scope.state")
_enabled = False          # the fast-path bool; the trainer hook reads it
_state = None             # ScopeState; None while disabled (zero-alloc)
_server = None            # ScopeServer; None while disabled (zero threads)

# how many ring / span records the JSON endpoints return by default
# (bounded responses: a scrape must stay cheap whatever the buffers hold)
_RING_TAIL = 8
_TRACEZ_SPANS = 64
_PROFILE_MAX_STEPS = 10_000
_RATE_WINDOW = 64         # (monotonic, step) samples for steps/s


class ProfileBusy(RuntimeError):
    """A /profilez capture is already armed or active (HTTP 409)."""

    def __init__(self, existing):
        self.existing = existing
        super().__init__(
            "a device-profile capture is already "
            f"{existing.get('state')} (trace_dir {existing.get('dir')!r})")


def _rank_from_env():
    for var in ("RANK", "JAX_PROCESS_ID", "DMLC_WORKER_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _generation():
    try:
        return int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        return 0


class ScopeState:
    """Per-rank introspection state: the last completed step, a bounded
    step-rate window, and the single armed/active profile capture. One
    module singleton in production; tests instantiate several (one per
    simulated rank) to exercise the aggregator in-process."""

    def __init__(self, rank=None):
        self.rank_override = rank
        self.started_wall = time.time()
        self.last_step = None
        self.last_step_mono = None
        self.last_step_wall = None
        self._rate = collections.deque(maxlen=_RATE_WINDOW)
        self._trainer = None      # weakref to the last stepping trainer
        self.profile = None       # the single capture slot (see on_step)
        self._lock = _locklint.make_lock("scope.instance")

    def rank(self):
        return self.rank_override if self.rank_override is not None \
            else _rank_from_env()

    # -- trainer hook ----------------------------------------------------
    def note_step(self, trainer, step):
        """Record one completed trainer step (hot path while enabled:
        a few attribute writes, no locks unless a capture is live)."""
        now = time.monotonic()
        self.last_step = int(step)
        self.last_step_mono = now
        self.last_step_wall = time.time()
        if trainer is not None and (self._trainer is None
                                    or self._trainer() is not trainer):
            # re-ref only on trainer change: a fresh weakref per step
            # would be an allocation on the hot path
            self._trainer = weakref.ref(trainer)
        rate = self._rate
        if not rate or now - rate[-1][0] >= 0.25:
            rate.append((now, int(step)))
        p = self.profile
        if p is not None and p["state"] != "done":
            self._profile_tick(p, int(step))

    def steps_per_s(self):
        rate = list(self._rate)
        if len(rate) < 2:
            return None
        (t0, s0), (t1, s1) = rate[0], rate[-1]
        if t1 <= t0 or s1 < s0:
            return None
        return round((s1 - s0) / (t1 - t0), 3)

    def trainer(self):
        ref = self._trainer
        return ref() if ref is not None else None

    # -- on-demand device profiling --------------------------------------
    def request_profile(self, steps, trace_dir=None):
        """Arm one capture of the card around the NEXT `steps` trainer
        steps. Returns the capture record (its 'done' event is set when
        the trainer-thread hook stops the trace). Raises ProfileBusy when
        a capture is already armed or active — torch.profiler holds one
        session per process."""
        steps = int(steps)
        if not 1 <= steps <= _PROFILE_MAX_STEPS:
            raise ValueError(
                f"profilez steps must be in [1, {_PROFILE_MAX_STEPS}], "
                f"got {steps}")
        with self._lock:
            p = self.profile
            if p is not None and p["state"] != "done":
                raise ProfileBusy(p)
            d = str(trace_dir) if trace_dir else tempfile.mkdtemp(
                prefix=f"mx_scope_profile_r{self.rank()}_")
            rec = {"dir": d, "steps": steps, "state": "armed",
                   "requested_ts": time.time(), "start_step": None,
                   "end_step": None, "error": None,
                   "done": threading.Event()}
            self.profile = rec
        return rec

    def _profile_tick(self, p, step):
        """Drive the armed capture from the trainer thread at the step
        boundary: start the trace after the arming step completes (the
        capture covers the next `steps` full steps), stop it once they
        have. start/stop run HERE — never on an HTTP thread — so the
        profiler session's start/stop can never race a dispatching step,
        and training order is untouched."""
        with self._lock:
            if p is not self.profile or p["state"] == "done":
                return
            if p["state"] == "armed":
                try:
                    os.makedirs(p["dir"], exist_ok=True)
                    _profiler.start_jax_trace(p["dir"])
                    p["state"] = "active"
                    p["start_step"] = step
                except Exception as e:  # noqa: BLE001 - reported, not fatal
                    p["state"] = "done"
                    p["error"] = f"{type(e).__name__}: {e}"
                    p["done"].set()
                return
            if p["state"] == "active" and step >= p["start_step"] + p["steps"]:
                try:
                    _profiler.stop_jax_trace()
                except Exception as e:  # noqa: BLE001 - reported, not fatal
                    p["error"] = f"{type(e).__name__}: {e}"
                p["state"] = "done"
                p["end_step"] = step
                p["done"].set()

    def abort_profile(self):
        """Stop a live capture (disable()/server shutdown): an armed one
        is cancelled, an active one stops its trace so the profiler
        session is never left dangling."""
        with self._lock:
            p, self.profile = self.profile, None
        if p is None or p["state"] == "done":
            return
        if p["state"] == "active":
            try:
                _profiler.stop_jax_trace()
            except Exception:
                pass
        p["state"] = "done"
        p["error"] = p["error"] or "aborted"
        p["done"].set()

    def profile_status(self):
        with self._lock:
            p = self.profile
            if p is None:
                return None
            return {k: p[k] for k in ("dir", "steps", "state",
                                      "start_step", "end_step", "error",
                                      "requested_ts")}


# ---------------------------------------------------------------------------
# endpoint payload builders (pure functions of a ScopeState — the HTTP
# handler and tests share them)
# ---------------------------------------------------------------------------

def _step_age_s(state):
    if state.last_step_mono is None:
        return None
    return round(time.monotonic() - state.last_step_mono, 3)


def healthz(state=None):
    """Liveness payload: the process answering is the liveness signal;
    the ages let a reader (the gang aggregator, a k8s probe) judge
    staleness without a clock exchange."""
    state = state or _state
    if state is None:
        return {"ok": False, "error": "scope disabled"}
    hb = _guard.last_heartbeat() if _guard._enabled else None
    return {
        "ok": True,
        "rank": state.rank(),
        "pid": os.getpid(),
        "ts": time.time(),
        "generation": _generation(),
        "step": state.last_step,
        "last_step_age_s": _step_age_s(state),
        "heartbeat_age_s": _guard.heartbeat_age_s() if hb else None,
        "heartbeat_phase": hb.get("phase") if hb else None,
        "uptime_s": round(time.time() - state.started_wall, 3),
    }


def _memsafe_section():
    ms = sys.modules.get(__package__ + ".memsafe")
    if ms is None:
        return None
    try:
        last = ms.last_check()
        out = {"headroom_bytes": ms.last_headroom_bytes(),
               "oom_events": ms._oom_events,
               "transitions": ms.transitions()[-4:]}
        if last:
            out["last_check"] = {k: last.get(k) for k in
                                 ("executable", "predicted_bytes",
                                  "capacity_bytes", "headroom_bytes")}
        return out
    except Exception as e:  # noqa: BLE001 - a section must not kill statusz
        return {"error": str(e)}


def _rungs_section(state):
    tr = state.trainer()
    if tr is None:
        return None
    out = {"grad_accum": getattr(tr, "_accum", None),
           "zero": bool(getattr(tr, "_zero", False)),
           "param_mode": getattr(tr, "param_mode", None)}
    ms = sys.modules.get(__package__ + ".memsafe")
    if ms is not None:
        try:
            out["remat_policy"] = ms.policy_marker(tr.block)
        except Exception:
            pass
    return out


def _serve_section():
    sv = sys.modules.get(__package__ + ".serve")
    if sv is None:
        return None
    try:
        servers = sv.servers()
    except Exception:
        return None
    if not servers:
        return None
    out = {"servers": [s.stats() for s in servers]}
    try:
        h = _telemetry.get("serve_ttft_seconds")
        if h.count:
            out["ttft_p50_ms"] = round((h.percentile(50) or 0) * 1e3, 3)
            out["ttft_p99_ms"] = round((h.percentile(99) or 0) * 1e3, 3)
    except KeyError:
        pass
    return out


def _fleet_section():
    fl = sys.modules.get(__package__ + ".fleet")
    if fl is None or not fl._enabled:
        return None
    try:
        return fl.snapshot()
    except Exception:
        return None


def _goodput_section():
    gp = sys.modules.get(__package__ + ".goodput")
    if gp is None or not gp._enabled:
        return None
    try:
        return gp.snapshot()
    except Exception:
        return None


def _slo_section():
    sl = sys.modules.get(__package__ + ".slo")
    if sl is None or not sl._enabled:
        return None
    try:
        return sl.snapshot()
    except Exception as e:  # noqa: BLE001 - a section must not kill statusz
        return {"error": str(e)}


def statusz(state=None):
    """The one-rank gang-member view the aggregator merges: step +
    rate, flight-ring tail, memory headroom and active degradation
    rungs, live serve stats, skew verdict, restart generation. Every
    section degrades to None/error independently — a broken subsystem
    must not take the whole status page with it."""
    state = state or _state
    if state is None:
        return {"ok": False, "error": "scope disabled"}
    out = healthz(state)
    out["steps_per_s"] = state.steps_per_s()
    out["ring_tail"] = _diagnostics.ring_tail(_RING_TAIL)
    out["memsafe"] = _memsafe_section()
    out["rungs"] = _rungs_section(state)
    out["serve"] = _serve_section()
    out["fleet"] = _fleet_section()
    out["slo"] = _slo_section()
    out["goodput"] = _goodput_section()
    out["trace"] = _trace.skew_verdict()
    out["guard"] = _guard.snapshot() if _guard._enabled else None
    out["profile"] = state.profile_status()
    out["telemetry_enabled"] = _telemetry._enabled
    res = sys.modules.get(__package__ + ".resilience")
    if res is not None:
        try:
            out["resume"] = res.last_resume()
        except Exception:
            pass
    return out


def tracez(state=None, n=_TRACEZ_SPANS):
    state = state or _state
    # n <= 0 means "no spans", never "all of them" — and the copy
    # itself is bounded via spans(tail=): a scrape must not duplicate a
    # 100k-record buffer under the trace recorder's hot-path lock
    n = max(0, int(n))
    return {
        "rank": state.rank() if state else _rank_from_env(),
        "enabled": _trace._enabled,
        "spans_buffered": _trace.snapshot()["spans_buffered"],
        "spans": _trace.spans(tail=n),
        "skews": _trace.skews()[-16:],
    }


def request_profile(steps, trace_dir=None):
    """Module-level spelling of ScopeState.request_profile (the enabled
    singleton)."""
    if _state is None:
        raise RuntimeError("mx.scope is disabled — enable() first")
    return _state.request_profile(steps, trace_dir=trace_dir)


def profile_status():
    return _state.profile_status() if _state is not None else None


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # scrape traffic must not spam worker stdout (the launcher prefixes
    # and tees every line) — errors surface through response codes
    def log_message(self, *args):
        pass

    def _send(self, code, payload, content_type="application/json"):
        body = payload if isinstance(payload, bytes) else \
            json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler spelling
        state = self.server._scope_state
        parts = urlsplit(self.path)
        route = parts.path.rstrip("/") or "/"
        q = parse_qs(parts.query)
        try:
            if route == "/healthz":
                self._send(200, healthz(state))
            elif route == "/metrics":
                text = _telemetry.dump_prometheus()
                self._send(200, text.encode(),
                           content_type=_telemetry.PROM_CONTENT_TYPE)
            elif route == "/statusz":
                self._send(200, statusz(state))
            elif route == "/tracez":
                n = int(q.get("n", [_TRACEZ_SPANS])[0])
                self._send(200, tracez(state, n=n))
            elif route == "/profilez":
                self._profilez(state, q)
            elif route == "/":
                self._send(200, {
                    "rank": state.rank(),
                    "endpoints": ["/healthz", "/metrics", "/statusz",
                                  "/tracez", "/profilez?steps=N"]})
            else:
                self._send(404, {"error": f"no such endpoint {route!r}"})
        except BrokenPipeError:
            pass       # client went away mid-response
        except ValueError as e:
            # malformed query values (n=abc, wait_s=abc): client error
            try:
                self._send(400, {"error": str(e)})
            except OSError:
                pass
        except Exception as e:  # noqa: BLE001 - a scrape must not kill the server
            try:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass

    def _profilez(self, state, q):
        """steps=N arms a capture (409 while one is live) and blocks up
        to wait_s for the trainer-thread hook to complete it; without
        steps=, reports the current capture state (poll target)."""
        if "steps" not in q:
            st = state.profile_status()
            self._send(200 if st else 404,
                       st or {"error": "no capture requested yet "
                                       "(GET /profilez?steps=N)"})
            return
        wait_s = float(q.get("wait_s", ["60"])[0])
        try:
            rec = state.request_profile(int(q["steps"][0]),
                                        trace_dir=(q.get("dir") or
                                                   [None])[0])
        except ProfileBusy as e:
            self._send(409, {"error": str(e), "profile": e.existing and {
                k: e.existing.get(k) for k in ("dir", "steps", "state")}})
            return
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        completed = rec["done"].wait(wait_s) if wait_s > 0 else False
        # answer from THIS request's capture record, not the current
        # slot: a new capture armed (or a disable()) during the wait
        # must not swap another capture's dir/state into this response
        with state._lock:
            st = {k: rec[k] for k in ("dir", "steps", "state",
                                      "start_step", "end_step", "error",
                                      "requested_ts")}
        st["completed"] = bool(completed)
        if completed and st.get("error"):
            self._send(500, st)
        else:
            # 202: armed/active — the capture finishes when the trainer
            # steps; poll GET /profilez (no steps) for completion
            self._send(200 if completed else 202, st)


class ScopeServer:
    """One rank's introspection HTTP server (a daemon-threaded
    ThreadingHTTPServer — slow scrapes never serialize behind each
    other, and a blocked /profilez wait never blocks /healthz)."""

    def __init__(self, state, port=0, host="127.0.0.1"):
        self.state = state
        self.httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self.httpd.daemon_threads = True
        self.httpd._scope_state = state
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="mx-scope-server", daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self.httpd.server_address[1]

    @property
    def url(self):
        host = self.httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# module lifecycle
# ---------------------------------------------------------------------------

def enabled():
    """True when the introspection server is up (the trainer hook reads
    the module global `_enabled` directly — this is the public
    spelling)."""
    return _enabled


def enable(port=None, rank=None, host="127.0.0.1"):
    """Start the per-rank introspection server. `port` defaults to the
    `scope_port` knob; 0 binds an ephemeral port (tests). Idempotent —
    a second enable() with the server already up is a no-op. Returns the
    bound port."""
    global _enabled, _state, _server
    with _lock:
        if _server is not None:
            _enabled = True
            return _server.port
        fresh = _state is None
        if fresh:
            _state = ScopeState(rank=rank)
        elif rank is not None:
            _state.rank_override = int(rank)
        p = int(port if port is not None else _config.get("scope_port"))
        try:
            _server = ScopeServer(_state, port=p, host=host)
        except OSError:
            if fresh:
                _state = None   # failed arm keeps the zero-alloc path
            raise
        _enabled = True
    print(f"mx.scope: rank {_state.rank()} introspection server on "
          f"{_server.url} (/healthz /metrics /statusz /tracez /profilez)",
          file=sys.stderr)
    return _server.port


def maybe_enable():
    """Arm iff the `scope` knob asks (called at trainer construction,
    like guard/memsafe — a config read at construction time only; the
    step hot path keeps its single module-bool check). A taken port
    warns instead of raising: knob-driven introspection must never kill
    the training run it observes (an explicit enable() still raises)."""
    if _enabled:
        return True
    if _config.get("scope") == "on":
        try:
            enable()
        except OSError as e:
            print(f"mx.scope: cannot bind port "
                  f"{_config.get('scope_port')}: {e} — introspection "
                  "disabled for this run", file=sys.stderr)
    return _enabled


def disable():
    """Stop the server and release the state: back to the zero-thread,
    zero-allocation fast path. A live device capture is stopped so the
    profiler session is never left dangling."""
    global _enabled, _state, _server
    with _lock:
        _enabled = False
        srv, _server = _server, None
        st, _state = _state, None
    if st is not None:
        st.abort_profile()
    if srv is not None:
        srv.stop()


def reset():
    """Tests/run boundaries: same as disable() (scope keeps no
    cross-run state beyond the server + step window)."""
    disable()


def port():
    """The bound server port (None while disabled)."""
    return _server.port if _server is not None else None


def url():
    """The server base URL (None while disabled)."""
    return _server.url if _server is not None else None


def on_step(trainer, step):
    """Post-step trainer hook (behind the module bool — never reached
    while disabled): records the completed
    step for /healthz + /statusz and drives an armed /profilez capture
    at the step boundary, on the trainer thread."""
    st = _state
    if st is not None:
        st.note_step(trainer, step)


def _after_fork_in_child():
    """A forked child has no server thread (threads do not survive
    fork): drop the slots and close the child's copy of the listening
    socket, so a worker never answers, or holds, the parent's port."""
    global _enabled, _state, _server
    srv, _server, _state, _enabled = _server, None, None, False
    if srv is not None:
        try:
            srv.httpd.socket.close()
        except OSError:
            pass


os.register_at_fork(after_in_child=_after_fork_in_child)


if _config.get("scope") == "on":
    maybe_enable()
