"""mx.fleet — the replicated serving gang: N `serve.Server` worker
processes behind one health-routed, stdlib-only front door (counterpart
of `mxnet_tpu/fleet.py`).

Every serve-side capability below this layer (continuous batching,
paged KV, SLOs, goodput) lives in a single process; mx.fleet is the
layer that survives a process. It extends the memory-safe-by-prediction
discipline (never dispatch a predicted overrun) up one level: never
ROUTE to a replica whose published admission headroom predicts a 429.

Two halves, one file, as in the JAX package:

* **Replica side** (`ReplicaEndpoint`, `run_replica`) — runs inside a
  worker process next to a port `serve.Server`. One ndjson-streaming
  HTTP surface: `POST /submit` (tokens as they decode, `skip` high-water
  for replay), `GET /healthz` / `GET /statusz` (liveness + the placement
  payload: queue depth, slot occupancy, p99 queue wait, memsafe
  admission hints), `POST /drain`. SIGTERM is flag-only: stop new
  admits, finish in-flight work inside `fleet_drain_grace_s`, requeue
  the rest with a retriable verdict, exit through the resilience
  preemption path (exit code 83) so the supervisor records a graceful
  drain, not a crash. The endpoint consumes the `slow_replica:ms` fault;
  the server's scheduler fires `kill_replica` and `wedge_replica`.

* **Router side** (`Router`, `RouterServer`) — stdlib-only: no torch, no
  package import, so `mxnet_tpu_torch/launch.py` loads this file by path
  and its supervising process never touches the card. Health-polls
  every replica on a fixed cadence, places each request on the
  least-loaded eligible replica (skipping draining, unhealthy and
  predicted-429 replicas), and fails over mid-stream: a replica that
  dies (or wedges past `fleet_stall_timeout_ms`) has its in-flight
  requests re-submitted to survivors with `skip` set to the high-water
  mark of tokens already delivered — generation is deterministic per
  request (every replica shares the weights' seed; sampling draws from
  each request's own seeded stream), so the client's concatenated stream
  equals an unloaded solo run and no token is ever re-sent. Rolling
  updates drain one replica at a time; queue-wait autoscale asks the
  supervisor for more (or fewer) replicas on sustained p99 queue-wait
  pressure.

Where the port differs:
  * `predict_429` counts the pages a replica's prefix tree alone holds
    (`pool_pages_reclaimable` in its admission hints) as free, since
    admission evicts them on demand. The JAX router reads the free list
    alone, so once the trees are warm it predicts 429s that the replica
    would not give and drops the request (fault 21 of ROADMAP.md).
  * Placement counts the router's own streams on a replica beyond what
    the last health poll saw as queued, so a burst of requests placed
    between two polls spreads over the replicas. The JAX router places a
    burst by one stale reading (fault 22 of ROADMAP.md), and a health
    poll that fails is counted (`poll_failures`).
  * The router's per-read stall bound starts at a submit's status line,
    where the JAX router's starts after it.
  * A replica's submit stream sends a keep-alive line (`{"alive": step}`)
    after each quarter of `fleet_stall_timeout_ms` without a token while
    its scheduler's step count advances (the request waits in the
    queue, or a long prefill runs). A JAX replica sends nothing until
    the first token, so a
    request queued behind a busy replica for longer than the stall bound
    is taken for a wedged one: the router marks the replica dead and
    replays the request elsewhere (fault 23 of ROADMAP.md). A parked
    scheduler's step count stands still, so the wedge still falls silent.
    Every router skips a line that is neither a token nor the final one.
  * The HTTP servers keep a listen backlog of 256 connections (the
    standard library's 5 resets a burst of concurrent streams).

`python -m mxnet_tpu_torch.fleet` runs one replica worker (`run_replica`):
the JAX worker's flags plus `--device` (default `cuda`; `--device cpu`
is the only way to run a replica on the CPU).

fleet=off is the zero-overhead fast path: nothing here is constructed,
and every hook site elsewhere (the mx.scope statusz section) reduces to
one module-bool check.
"""
from __future__ import annotations

import argparse
import collections
import http.client
import json
import os
import signal as _signal
import socket
import sys
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = [
    "ReplicaEndpoint", "Router", "RouterServer", "FleetRequest",
    "enable", "disable", "enabled", "snapshot", "run_replica",
    "EXIT_PREEMPTED",
]

#: mirror of resilience.EXIT_PREEMPTED — the router half of this module
#: must stay importable by path with no package around it
EXIT_PREEMPTED = 83

try:
    from ._fleet_defaults import DEFAULTS
except ImportError:
    # loaded by file path (the launcher): the table beside this file
    import importlib.util as _ilu
    _spec = _ilu.spec_from_file_location(
        "_fleet_defaults", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "_fleet_defaults.py"))
    _defaults = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_defaults)
    DEFAULTS = _defaults.DEFAULTS


def _knob(name):
    """A fleet knob from its environment variable (`config.set`
    overrides are not seen: this module runs without the package)."""
    raw = os.environ.get("MXNET_TPU_" + name.upper())
    default = DEFAULTS[name]
    return default if raw is None else type(default)(raw)


# fleet=on arms the module at import (its mx.scope statusz section)
_enabled = _knob("fleet") == "on"
_endpoints = weakref.WeakSet()


def enabled():
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def snapshot():
    """Replica-side fleet state for the mx.scope statusz section (one
    dict per live endpoint). Callers gate on `_enabled` — this is never
    reached on the fleet=off fast path."""
    return {"endpoints": [ep.describe() for ep in list(_endpoints)]}


def _percentile(values, pct):
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round((pct / 100.0) * (len(vs) - 1)))))
    return vs[idx]


class _HTTPServer(ThreadingHTTPServer):
    """A thread per connection, and a listen backlog that holds a burst
    of concurrent streams: the standard library's 5 resets connections
    when a fleet's clients (or the router's attempts) arrive together
    faster than the accept loop runs."""
    daemon_threads = True
    request_queue_size = 256


# ---------------------------------------------------------------------------
# replica side
# ---------------------------------------------------------------------------

class _StreamAborted(Exception):
    """Raised inside a /submit handler when the endpoint is simulating
    replica death (`kill()`): the connection closes mid-stream with no
    terminal line — exactly what a SIGKILLed process looks like to the
    router."""


class ReplicaEndpoint:
    """The in-process serving endpoint one fleet replica exports.

    Wraps a live `serve.Server`; `port=0` binds an ephemeral port
    (tests, benchmarks). The launcher layout is `fleet_port + 1 + R`
    for replica R — same base+1+rank convention as mx.scope. A submit
    stream stays silent for at most a quarter of the router's stall
    bound (`fleet_stall_timeout_ms`) while the scheduler advances."""

    def __init__(self, server, replica=None, port=0, host="127.0.0.1",
                 version=None):
        enable()
        self.keepalive_s = _knob("fleet_stall_timeout_ms") / 4000.0 or None
        self.server = server
        self.replica = int(replica if replica is not None
                           else os.environ.get("MXNET_TPU_FLEET_REPLICA", 0))
        self.version = version if version is not None \
            else os.environ.get("MXNET_TPU_FLEET_VERSION", "v0")
        self.host = host
        self.draining = False
        self._dead = False                  # test-only simulated SIGKILL
        self._slow_ms = None                # slow_replica fault, once armed
        self._slow_checked = False
        self._qwaits = collections.deque(maxlen=256)
        self._served = 0
        self._requeued_out = 0
        self._lock = threading.Lock()
        self._httpd = _HTTPServer((host, int(port)),
                                  self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name=f"mx-fleet-replica-{self.replica}", daemon=True)
        self._thread.start()
        _endpoints.add(self)

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def describe(self):
        return {"replica": self.replica, "version": self.version,
                "port": self.port, "draining": self.draining,
                "served": self._served, "requeued_out": self._requeued_out,
                "pid": os.getpid()}

    # -- drain / death ---------------------------------------------------
    def begin_drain(self):
        """Stop admitting new fleet requests (router submits answer
        `503 draining`, retriable). In-flight requests keep decoding."""
        self.draining = True

    def drain_and_requeue(self, grace_s=None):
        """Finish in-flight requests for up to `grace_s`, then cancel
        the stragglers with a retriable verdict so the router requeues
        them on a survivor (their streams carry the replay high-water).
        Returns (finished, requeued)."""
        if grace_s is None:
            grace_s = _knob("fleet_drain_grace_s")
        self.begin_drain()
        deadline = time.monotonic() + float(grace_s)
        finished = 0
        while self.server.busy() and time.monotonic() < deadline:
            time.sleep(0.01)
        from . import serve as _serve
        with self.server._lock:
            live = [r for r in self.server._by_id.values()
                    if r.state not in _serve.TERMINAL]
        for r in live:
            self.server.cancel(r)
            self._requeued_out += 1
        # let the scheduler apply the cancels so every stream terminates
        t0 = time.monotonic()
        while self.server.busy() and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        finished = self._served - self._requeued_out
        return finished, len(live)

    def kill(self):
        """Simulate abrupt replica death in-process (tests): in-flight
        /submit streams break mid-token with no terminal line, and
        health checks start failing. The real drill is a SIGKILLed
        worker process; this is its single-process stand-in."""
        self._dead = True

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- payloads --------------------------------------------------------
    def statusz(self):
        st = self.server.stats()
        with self._lock:
            qw = list(self._qwaits)
        p99 = _percentile(qw, 99)
        out = {"replica": self.replica, "version": self.version,
               "pid": os.getpid(), "draining": self.draining,
               "stats": st,
               "queue_wait_p99_ms": round(p99 * 1e3, 3)
               if p99 is not None else None,
               "admission": self.server.admission_hints(),
               "served": self._served,
               "requeued_out": self._requeued_out}
        try:
            from . import telemetry as _telemetry
            if _telemetry._enabled:
                h = _telemetry.get("serve_ttft_seconds")
                if h.count:
                    out["ttft_p99_ms"] = round(
                        (h.percentile(99) or 0) * 1e3, 3)
        except Exception:
            pass
        return out

    def _maybe_slow_ms(self):
        """slow_replica:ms fault — the SERVER side of slow_client: every
        streamed token leaves this replica `ms` late, so the router's
        placement (TTFT percentiles) must learn to route around it."""
        if self._slow_checked:
            return self._slow_ms
        self._slow_checked = True
        try:
            from . import resilience as _resilience
        except Exception:
            return None
        inj = _resilience._injector if _resilience._enabled else None
        if inj is not None:
            arg = inj.consume("slow_replica")
            if arg:
                self._slow_ms = float(arg)
                print(f"mx.fleet: fault injection: slow replica "
                      f"{self.replica} — {arg} ms per streamed token",
                      file=sys.stderr)
        return self._slow_ms

    # -- http ------------------------------------------------------------
    def _make_handler(self):
        ep = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"   # Connection: close == stream EOF

            def log_message(self, *args):
                pass

            def _send_json(self, code, payload):
                body = (json.dumps(payload) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if ep._dead:
                    # dead-host simulation: no status line, connection
                    # closes — the fetcher sees exactly a SIGKILLed peer
                    self.close_connection = True
                    return
                if self.path == "/healthz":
                    self._send_json(200, {
                        "ok": True, "replica": ep.replica,
                        "version": ep.version, "draining": ep.draining,
                        "pid": os.getpid()})
                elif self.path == "/statusz":
                    self._send_json(200, ep.statusz())
                else:
                    self._send_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if ep._dead:
                    self.close_connection = True
                    return
                if self.path == "/drain":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        body = {}
                    if body.get("off"):
                        ep.draining = False
                    else:
                        ep.begin_drain()
                    self._send_json(200, {"draining": ep.draining,
                                          "replica": ep.replica})
                    return
                if self.path != "/submit":
                    self._send_json(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send_json(400, {"error": "bad json"})
                    return
                ep._handle_submit(self, body)

        return Handler

    def _handle_submit(self, handler, body):
        from . import serve as _serve
        if self.draining:
            handler._send_json(200, {
                "done": True, "state": _serve.SHED,
                "verdict": f"503 draining: replica {self.replica}",
                "retriable": True, "n": 0, "replica": self.replica,
                "version": self.version})
            return
        skip = int(body.get("skip", 0))
        try:
            req = self.server.submit(
                body["prompt"],
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                eos=body.get("eos"),
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                seed=int(body.get("seed", 0)),
                deadline_ms=body.get("deadline_ms"))
        except ValueError as e:
            handler._send_json(400, {"error": str(e)})
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.end_headers()
        slow_ms = self._maybe_slow_ms()
        i = 0
        seen = self.server._sched_step
        try:
            for tok in req.stream(idle_s=self.keepalive_s):
                if self._dead:
                    raise _StreamAborted()
                if tok is None:
                    # no token for a keep-alive interval (queued behind
                    # full slots, or a long prefill): one line for the
                    # router's stall bound, sent only while the scheduler
                    # steps, so a parked scheduler still falls silent
                    step = self.server._sched_step
                    if step != seen:
                        seen = step
                        handler.wfile.write(
                            (json.dumps({"alive": step}) + "\n").encode())
                        handler.wfile.flush()
                    continue
                if i >= skip:
                    handler.wfile.write(
                        (json.dumps({"t": int(tok)}) + "\n").encode())
                    handler.wfile.flush()
                i += 1
                if slow_ms:
                    time.sleep(slow_ms / 1000.0)
            if self._dead:
                raise _StreamAborted()
            final = {"done": True, "state": req.state,
                     "verdict": req.verdict, "n": len(req.tokens),
                     "requeues": req.requeues, "replica": self.replica,
                     "version": self.version}
            # a drain-expiry cancellation is the router's cue to replay
            # this request on a survivor (skip = what we already sent)
            if self.draining and req.state == _serve.CANCELLED:
                final["retriable"] = True
            handler.wfile.write((json.dumps(final) + "\n").encode())
            handler.wfile.flush()
            with self._lock:
                self._served += 1
                if req.queue_wait_s is not None:
                    self._qwaits.append(req.queue_wait_s)
        except (_StreamAborted, BrokenPipeError, ConnectionResetError):
            # dead-replica simulation or a vanished client: free the
            # slot and close without a terminal line; the router
            # replays on a survivor from its high-water mark
            self.server.cancel(req)
            handler.close_connection = True


# ---------------------------------------------------------------------------
# router side (stdlib-only: loadable by path from launch.py)
# ---------------------------------------------------------------------------

class _Replica:
    __slots__ = ("rid", "url", "healthy", "draining", "hold", "stats",
                 "last_ok", "fails")

    def __init__(self, rid, url):
        self.rid = rid
        self.url = url
        self.healthy = False
        self.draining = False
        self.hold = False        # router-local traffic hold (rolling update)
        self.stats = {}
        self.last_ok = 0.0
        self.fails = 0

    def view(self):
        st = self.stats.get("stats", {})
        return {"url": self.url, "healthy": self.healthy,
                "draining": self.draining or self.hold,
                "version": self.stats.get("version"),
                "queued": st.get("queued"), "running": st.get("running"),
                "queue_wait_p99_ms": self.stats.get("queue_wait_p99_ms"),
                "fails": self.fails}


class FleetRequest:
    """The router-side request handle; mirrors the `serve.Request`
    consumer surface (`stream()` / `result(timeout)` / `state` /
    `verdict` / `tokens`) plus the fleet trail: `replicas_tried`,
    `failovers`. Tokens arriving after a failover continue the same
    stream — the replay `skip` guarantees no token repeats."""

    _EOS = object()

    def __init__(self, rid, payload):
        self.id = rid
        self.payload = payload
        self.tokens = []
        self.state = "queued"
        self.verdict = None
        self.replicas_tried = []
        self.failovers = 0
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._done = threading.Event()

    @property
    def done(self):
        return self._done.is_set()

    def _push(self, tok):
        self.tokens.append(tok)
        with self._cv:
            self._q.append(tok)
            self._cv.notify_all()

    def _finish(self, state, verdict):
        self.state = state
        self.verdict = verdict
        self._done.set()
        with self._cv:
            self._q.append(self._EOS)
            self._cv.notify_all()

    def stream(self):
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
                item = self._q.popleft()
            if item is self._EOS:
                return
            yield item

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"fleet request {self.id} still {self.state} after "
                f"{timeout}s")
        return list(self.tokens)


class Router:
    """Health-routed load balancer over a set of replica endpoints.

    stdlib-only by design: `mxnet_tpu_torch/launch.py` loads this module
    by path (no package import, no torch) and runs the router inside the
    launcher process.

    `replicas` maps replica-id -> base URL. `on_scale(n)` — when set —
    receives the autoscaler's requested replica count; the launcher
    clamps it one replica a step between --min-workers and
    --max-replicas and spawns/drains workers to match."""

    #: verdict prefixes worth one more try on a DIFFERENT replica —
    #: per-replica overload is exactly what a second replica is for
    RETRIABLE = ("503", "429")

    def __init__(self, replicas, retry_max=None, health_interval_s=None,
                 stall_timeout_s=None, connect_timeout_s=2.0,
                 autoscale=None, autoscale_p99_ms=None,
                 autoscale_window_s=None, on_scale=None,
                 clock=time.monotonic):
        self.retry_max = int(retry_max if retry_max is not None
                             else _knob("fleet_retry_max"))
        self.health_interval_s = float(
            health_interval_s if health_interval_s is not None
            else _knob("fleet_health_interval_ms") / 1000.0)
        self.stall_timeout_s = float(
            stall_timeout_s if stall_timeout_s is not None
            else _knob("fleet_stall_timeout_ms") / 1000.0)
        self.connect_timeout_s = float(connect_timeout_s)
        self.autoscale = (autoscale if autoscale is not None
                          else _knob("fleet_autoscale") == "on")
        self.autoscale_p99_ms = float(
            autoscale_p99_ms if autoscale_p99_ms is not None
            else _knob("fleet_autoscale_p99_ms"))
        self.autoscale_window_s = float(
            autoscale_window_s if autoscale_window_s is not None
            else _knob("fleet_autoscale_window_s"))
        self.on_scale = on_scale
        self._clock = clock
        self._lock = threading.RLock()
        self._replicas = {rid: _Replica(rid, url)
                          for rid, url in dict(replicas).items()}
        self._seq = 0
        self._rr = 0
        self._streams = collections.Counter()   # rid -> attempts running
        self.counters = collections.Counter()
        self.scale_events = []
        self._over_since = None
        self._under_since = None
        self._poll_thread = None
        self._stop = threading.Event()

    # -- membership ------------------------------------------------------
    def add_replica(self, rid, url):
        with self._lock:
            self._replicas[rid] = _Replica(rid, url)

    def remove_replica(self, rid):
        with self._lock:
            self._replicas.pop(rid, None)

    def replica_ids(self):
        with self._lock:
            return sorted(self._replicas)

    def set_url(self, rid, url):
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None:
                r.url = url

    # -- health ----------------------------------------------------------
    def start(self):
        if self._poll_thread is not None and self._poll_thread.is_alive():
            return self
        self._stop.clear()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="mx-fleet-router", daemon=True)
        self._poll_thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5)

    def _poll_loop(self):
        while not self._stop.wait(self.health_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — poll must survive
                print(f"mx.fleet: health poll error: {e}", file=sys.stderr)

    def _get_json(self, url, timeout):
        import urllib.request
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    def poll_once(self):
        """One synchronous health pass over every replica: /healthz for
        liveness, /statusz for the placement payload. A replica that
        fails the fetch is unhealthy until a later pass succeeds."""
        with self._lock:
            reps = list(self._replicas.values())
        for r in reps:
            try:
                hz = self._get_json(r.url + "/healthz",
                                    self.connect_timeout_s)
                st = self._get_json(r.url + "/statusz",
                                    self.connect_timeout_s)
            except Exception:
                r.healthy = False
                r.fails += 1
                self.counters["poll_failures"] += 1
                continue
            r.healthy = bool(hz.get("ok"))
            r.draining = bool(hz.get("draining"))
            r.stats = st
            r.last_ok = self._clock()
            r.fails = 0
        if self.autoscale:
            self.maybe_autoscale()

    # -- admission prediction -------------------------------------------
    @staticmethod
    def predict_429(statusz, need):
        """True when the replica's PUBLISHED admission hints predict a
        429 for a request of `need` total tokens (prompt + max_new):
        the dense bucket it would newly allocate costs more than the
        published memsafe headroom, or — paged — the pool lacks the
        pages, counting those only the prefix tree holds
        (`pool_pages_reclaimable`) as free. Unknown headroom (memsafe
        off) predicts nothing."""
        hints = (statusz or {}).get("admission") or {}
        max_len = hints.get("max_len")
        if max_len and need > int(max_len):
            return True                      # 413, but equally unroutable
        headroom = hints.get("headroom_bytes")
        if headroom is None:
            return False
        if hints.get("pages") == "on":
            ps = int(hints.get("page_size") or 0)
            free = hints.get("pool_pages_free")
            if ps and free is not None:
                # pages only the prefix tree holds are free to admission
                # (a port replica publishes them; a JAX one does not)
                free = int(free) + int(hints.get("pool_pages_reclaimable")
                                       or 0)
                return (need + ps - 1) // ps > free
            return False
        buckets = hints.get("buckets")
        if buckets:
            cands = [int(b) for b in buckets if int(b) >= need]
            if not cands:
                return True
            bucket = min(cands)
        else:
            bucket = 1
            while bucket < need:
                bucket *= 2
            if max_len:
                bucket = min(bucket, int(max_len))
        allocated = set(int(b) for b in
                        (statusz.get("stats", {})
                         .get("buckets_allocated") or []))
        if bucket in allocated:
            return False                     # cache exists; no new cost
        cost = (hints.get("bucket_cost") or {}).get(str(bucket))
        if cost is None:
            return False
        return int(cost) > int(headroom)

    # -- placement -------------------------------------------------------
    def _place(self, need, exclude=()):
        """Least-loaded eligible replica for a `need`-token request, or
        None. Eligible = healthy, not draining/held, not excluded, not
        predicted to 429. A replica's load is its polled queue and slot
        occupancy, with this router's streams on it beyond the polled
        total counted as queued: a burst placed between two polls then
        spreads instead of following one stale reading. The chosen
        replica's stream count rises here, under the lock; `_drive`
        lowers it when the attempt ends."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.healthy and not r.draining and not r.hold
                    and r.rid not in exclude]
            cands = []
            for r in reps:
                if need and self.predict_429(r.stats, need):
                    self.counters["skipped_admission"] += 1
                    continue
                st = r.stats.get("stats", {})
                slots = (r.stats.get("admission") or {}).get("slots") or 1
                queued, running = st.get("queued", 0), st.get("running", 0)
                queued += max(0, self._streams[r.rid] - queued - running)
                load = queued + running / max(1, slots)
                cands.append((load, r.stats.get("ttft_p99_ms") or 0.0, r))
            if not cands:
                return None
            cands.sort(key=lambda c: (c[0], c[1], c[2].rid))
            best = cands[0][0]
            ties = [c[2] for c in cands if c[0] == best]
            self._rr += 1
            rep = ties[self._rr % len(ties)]
            self._streams[rep.rid] += 1
            return rep

    def _mark_dead(self, rid):
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None:
                r.healthy = False
                r.fails += 1

    # -- submit / failover ----------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos=None, temperature=0.0,
               top_k=0, seed=0, deadline_ms=None):
        """Route one generation request; returns a FleetRequest
        immediately. Never raises for overload — exhausting every
        replica (or the failover budget) lands a 503 verdict on the
        request, mirroring `serve.Server.submit`."""
        with self._lock:
            rid = self._seq
            self._seq += 1
        payload = {"prompt": [int(t) for t in prompt],
                   "max_new_tokens": int(max_new_tokens), "eos": eos,
                   "temperature": float(temperature), "top_k": int(top_k),
                   "seed": int(seed), "deadline_ms": deadline_ms}
        freq = FleetRequest(rid, payload)
        self.counters["submitted"] += 1
        t = threading.Thread(target=self._drive, args=(freq,),
                             name=f"mx-fleet-req-{rid}", daemon=True)
        t.start()
        return freq

    def _drive(self, freq):
        need = len(freq.payload["prompt"]) + freq.payload["max_new_tokens"]
        overloaded = set()     # replicas that answered a retriable verdict
        last_verdict = None
        attempts = 0
        backoff = 0.05
        while True:
            rep = self._place(need, exclude=overloaded)
            if rep is None and overloaded:
                # every healthy replica answered overload: accept the
                # freshest overload verdict rather than spinning
                freq._finish("shed" if (last_verdict or "").startswith(
                    "503") else "rejected",
                    last_verdict or "503 fleet: all replicas overloaded")
                return
            if rep is None:
                attempts += 1
                if attempts > self.retry_max:
                    freq._finish(
                        "failed",
                        "503 fleet: no healthy replica "
                        f"(tried {freq.replicas_tried})")
                    return
                time.sleep(backoff)
                backoff = min(1.0, backoff * 2)
                self.poll_once()
                continue
            freq.replicas_tried.append(rep.rid)
            try:
                kind, info = self._attempt(rep, freq)
            finally:
                with self._lock:
                    self._streams[rep.rid] -= 1
            if kind == "final":
                self.counters["completed"] += 1
                freq._finish(info["state"], info["verdict"])
                return
            if kind == "overloaded":
                overloaded.add(rep.rid)
                last_verdict = info
                self.counters["retries"] += 1
                continue
            # transport death / stall / drain-requeue: failover
            self.counters["failovers"] += 1
            freq.failovers += 1
            if info == "dead":
                self._mark_dead(rep.rid)
            attempts += 1
            if attempts > self.retry_max:
                freq._finish(
                    "failed",
                    f"503 fleet: failover budget exhausted after "
                    f"{freq.failovers} failover(s) "
                    f"(tried {freq.replicas_tried})")
                return
            time.sleep(backoff)
            backoff = min(1.0, backoff * 2)

    def _attempt(self, rep, freq):
        """One streaming /submit attempt against `rep`, resuming past
        the tokens already delivered. Returns ("final", {...}),
        ("overloaded", verdict) or ("failover", "dead"|"requeue")."""
        body = dict(freq.payload)
        body["skip"] = len(freq.tokens)       # the replay high-water mark
        host, _, port = rep.url.rpartition("//")[2].partition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=self.connect_timeout_s)
        try:
            conn.request("POST", "/submit", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
            if self.stall_timeout_s and conn.sock is not None:
                # per-read stall bound: a wedged-but-alive replica stops
                # producing tokens without closing the socket. It starts
                # at the status line (the JAX router's starts after it,
                # under the connect timeout): a replica's submit waits
                # for its scheduler's lock, which a first dispatch on the
                # card can hold for seconds
                conn.sock.settimeout(self.stall_timeout_s)
            resp = conn.getresponse()
            if resp.status != 200:
                return "failover", "dead"
            while True:
                line = resp.readline()
                if not line:
                    # EOF with no terminal line: the replica died
                    # mid-stream (SIGKILL / kill())
                    return "failover", "dead"
                try:
                    msg = json.loads(line)
                except ValueError:
                    return "failover", "dead"
                if "t" in msg:
                    freq._push(int(msg["t"]))
                    continue
                if msg.get("done"):
                    verdict = msg.get("verdict") or ""
                    if msg.get("retriable"):
                        return "failover", "requeue"
                    if verdict[:3] in ("503", "429") \
                            and msg.get("n", 0) == 0 \
                            and not freq.tokens:
                        return "overloaded", verdict
                    return "final", {"state": msg.get("state", "done"),
                                     "verdict": verdict}
        except (OSError, http.client.HTTPException, socket.timeout):
            return "failover", "dead"
        finally:
            try:
                conn.close()
            except Exception:
                pass

    # -- drain / rolling update -----------------------------------------
    def drain(self, rid, remote=True):
        """Hold traffic off replica `rid` (and, `remote=True`, tell the
        replica itself to refuse new admits)."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return False
            r.hold = True
            url = r.url
        if remote:
            try:
                import urllib.request
                req = urllib.request.Request(url + "/drain", data=b"{}",
                                             method="POST")
                urllib.request.urlopen(req, timeout=self.connect_timeout_s)
            except Exception:
                pass
        return True

    def undrain(self, rid, remote=True):
        """Release a router-local hold; `remote=True` also clears the
        replica's own draining refusal (a rolled replica comes back
        fresh, but an ABORTED drain must re-open the old process)."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is None:
                return
            r.hold = False
            r.draining = False
            url = r.url
        if remote:
            try:
                import urllib.request
                req = urllib.request.Request(
                    url + "/drain", data=b'{"off": true}', method="POST")
                urllib.request.urlopen(req, timeout=self.connect_timeout_s)
            except Exception:
                pass

    def replica_idle(self, rid):
        with self._lock:
            r = self._replicas.get(rid)
        if r is None:
            return True
        st = r.stats.get("stats", {})
        return r.healthy and st.get("queued", 1) == 0 \
            and st.get("running", 1) == 0

    def wait_idle(self, rid, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll_once()
            if self.replica_idle(rid):
                return True
            time.sleep(0.05)
        return False

    def wait_healthy(self, rid, timeout_s=30.0, version=None):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.poll_once()
            with self._lock:
                r = self._replicas.get(rid)
                if r is not None and r.healthy and not r.draining and (
                        version is None
                        or r.stats.get("version") == version):
                    return True
            time.sleep(0.05)
        return False

    def rolling_update(self, update_replica, version=None,
                       wait_timeout_s=30.0):
        """Replica-by-replica restart onto new weights, serving
        continuously: drain -> wait idle -> `update_replica(rid)` (may
        return a new URL) -> wait healthy (at `version`, if given) ->
        release traffic. Returns the list of updated replica ids."""
        updated = []
        for rid in self.replica_ids():
            self.drain(rid)
            self.wait_idle(rid, wait_timeout_s)
            new_url = update_replica(rid)
            if new_url:
                self.set_url(rid, new_url)
            self.wait_healthy(rid, wait_timeout_s, version=version)
            self.undrain(rid)
            updated.append(rid)
        return updated

    # -- autoscale -------------------------------------------------------
    def maybe_autoscale(self, now=None):
        """Queue-wait autoscaling with hysteresis: every healthy
        replica over the p99 threshold for a full window asks for one
        more replica; a fleet with empty queues and negligible queue
        wait for a full window gives one back. The supervisor clamps
        the request to its replica bounds."""
        if self.on_scale is None:
            return
        now = self._clock() if now is None else now
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.healthy and not r.draining and not r.hold]
            n = len(self._replicas)
        if not reps:
            self._over_since = self._under_since = None
            return
        p99s = [r.stats.get("queue_wait_p99_ms") or 0.0 for r in reps]
        queued = sum(r.stats.get("stats", {}).get("queued", 0)
                     for r in reps)
        pressure = min(p99s)      # EVERY replica hot, not just one
        if pressure > self.autoscale_p99_ms:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            elif now - self._over_since >= self.autoscale_window_s:
                self._over_since = None
                self.scale_events.append(
                    {"t": now, "dir": "up", "from": n, "to": n + 1,
                     "p99_ms": pressure})
                self.on_scale(n + 1)
        elif pressure < self.autoscale_p99_ms / 4.0 and queued == 0:
            self._over_since = None
            if self._under_since is None:
                self._under_since = now
            elif now - self._under_since >= self.autoscale_window_s:
                self._under_since = None
                self.scale_events.append(
                    {"t": now, "dir": "down", "from": n, "to": n - 1,
                     "p99_ms": pressure})
                self.on_scale(n - 1)
        else:
            self._over_since = self._under_since = None

    # -- views -----------------------------------------------------------
    def healthz(self):
        with self._lock:
            reps = {r.rid: {"ok": r.healthy, "draining":
                            r.draining or r.hold}
                    for r in self._replicas.values()}
        return {"ok": any(v["ok"] for v in reps.values()),
                "replicas": reps}

    def statusz(self):
        with self._lock:
            return {"replicas": {r.rid: r.view()
                                 for r in self._replicas.values()},
                    "counters": dict(self.counters),
                    "scale_events": list(self.scale_events)}


class RouterServer:
    """The fleet's one public HTTP endpoint: `POST /submit` streams
    tokens back as ndjson riding the
    router's placement + failover; `GET /healthz` / `GET /statusz` are
    the merged fleet views; `POST /roll` and `POST /scale` hand rolling
    updates and explicit resizes to the supervisor's hooks."""

    def __init__(self, router, port, host="127.0.0.1"):
        self.router = router
        self.on_roll = None
        self.on_scale = None
        self._httpd = _HTTPServer((host, int(port)),
                                  self._make_handler())
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="mx-fleet-front", daemon=True)
        self._thread.start()

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def _make_handler(self):
        rs = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _send_json(self, code, payload):
                body = (json.dumps(payload) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._send_json(200, rs.router.healthz())
                elif self.path == "/statusz":
                    self._send_json(200, rs.router.statusz())
                else:
                    self._send_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send_json(400, {"error": "bad json"})
                    return
                if self.path == "/roll":
                    if rs.on_roll is None:
                        self._send_json(501, {"error": "no supervisor"})
                    else:
                        rs.on_roll(body.get("version"))
                        self._send_json(202, {"rolling": True})
                    return
                if self.path == "/scale":
                    if rs.on_scale is None:
                        self._send_json(501, {"error": "no supervisor"})
                    else:
                        rs.on_scale(int(body["n"]))
                        self._send_json(202, {"target": int(body["n"])})
                    return
                if self.path != "/submit":
                    self._send_json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    freq = rs.router.submit(
                        body["prompt"],
                        max_new_tokens=int(body.get("max_new_tokens", 32)),
                        eos=body.get("eos"),
                        temperature=float(body.get("temperature", 0.0)),
                        top_k=int(body.get("top_k", 0)),
                        seed=int(body.get("seed", 0)),
                        deadline_ms=body.get("deadline_ms"))
                except (KeyError, ValueError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                try:
                    for tok in freq.stream():
                        self.wfile.write(
                            (json.dumps({"t": int(tok)}) + "\n").encode())
                        self.wfile.flush()
                    self.wfile.write((json.dumps(
                        {"done": True, "state": freq.state,
                         "verdict": freq.verdict,
                         "n": len(freq.tokens),
                         "failovers": freq.failovers,
                         "replicas_tried": freq.replicas_tried})
                        + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass

        return Handler


# ---------------------------------------------------------------------------
# replica worker entry point: python -m mxnet_tpu_torch.fleet
# ---------------------------------------------------------------------------

def run_replica(argv=None):
    """One fleet replica worker: a `models.gpt` model on `--device` (the
    card unless `--device cpu`) -> serve.Server -> ReplicaEndpoint (+
    mx.scope when armed), then park until SIGTERM flags a drain —
    finish/requeue in-flight work within the grace budget, print the
    kernel launch counters of this process, and exit through the
    resilience preemption path (83). The serving knobs (`pages`,
    `serve_slots`, `pages_page_size`, ...) come from the environment."""
    p = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.fleet")
    p.add_argument("--model", default="gpt_tiny",
                   help="models.gpt config name (gpt_tiny, gpt2_117m, ...)")
    p.add_argument("--port", type=int, default=None,
                   help="endpoint port (default MXNET_TPU_FLEET_PORT, "
                        "else fleet_port+1+replica)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--slots", type=int, default=None)
    p.add_argument("--seed", type=int, default=0,
                   help="weight-init seed — every replica MUST share it "
                        "or failover replay breaks bit-identity")
    p.add_argument("--device", default="cuda",
                   help="device of the model (default the card; 'cpu' "
                        "runs the replica on the CPU)")
    args = p.parse_args(argv)

    from . import config as _config
    from . import random as _random
    from . import resilience as _resilience
    from . import scope as _scope
    from . import serve as _serve
    from .models import gpt as _gpt
    from .run_example import launch_counts

    replica = int(os.environ.get("MXNET_TPU_FLEET_REPLICA", 0))
    port = args.port
    if port is None:
        port = int(os.environ.get(
            "MXNET_TPU_FLEET_PORT",
            int(_config.get("fleet_port")) + 1 + replica))
    version = os.environ.get("MXNET_TPU_FLEET_VERSION", "v0")

    cfg_fn = getattr(_gpt, f"{args.model}_config")
    model = _gpt.GPTForCausalLM(cfg_fn(), device=args.device)
    model.initialize(generator=_random.seed(args.seed, model.device))

    # SIGINT keeps the resilience preemption handler; SIGTERM belongs
    # to the fleet drain (flag-only, async-signal-safe)
    _resilience.install(signals=(_signal.SIGINT,))
    term = threading.Event()
    _signal.signal(_signal.SIGTERM, lambda *_: term.set())

    srv = _serve.Server(model, slots=args.slots).start()
    ep = ReplicaEndpoint(srv, replica=replica, port=port, host=args.host,
                         version=version)
    _scope.maybe_enable()
    grace = float(_config.get("fleet_drain_grace_s"))
    print(f"mx.fleet: replica {replica} ({version}) serving "
          f"{args.model} on {model.device} at {ep.url} "
          f"(pid {os.getpid()})", flush=True)
    try:
        # no heartbeat here: the serve scheduler is the beat source
        # (phase="serve", every step) — if it wedges, the beat MUST go
        # stale so the supervisor's staleness kill fires
        while not term.wait(0.2):
            srv.raise_if_failed()
    except KeyboardInterrupt:
        pass
    print(f"mx.fleet: replica {replica} draining "
          f"(grace {grace:.0f}s)", flush=True)
    finished, requeued = ep.drain_and_requeue(grace)
    srv.stop()
    ep.stop()
    print(f"mx.fleet: replica {replica} ({version}) launches "
          + json.dumps({"served": ep._served, "launches": launch_counts()}),
          flush=True)
    print(f"mx.fleet: replica {replica} drained — {finished} finished, "
          f"{requeued} requeued elsewhere; exiting via preemption path",
          flush=True)
    raise _resilience.PreemptedExit(
        f"fleet replica {replica} drained", code=_resilience.EXIT_PREEMPTED)


if __name__ == "__main__":
    # run the package's module, not this __main__ copy: mx.scope's fleet
    # section reads the endpoints of `mxnet_tpu_torch.fleet`
    from mxnet_tpu_torch.fleet import run_replica as _run
    _run()
