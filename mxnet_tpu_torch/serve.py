"""Continuous-batching inference server (counterpart of
`mxnet_tpu/serve.py`).

The Orca-style token-level loop of the JAX package, over one
`GPTForCausalLM`:

  * **fixed batch slots, bucketed caches** — requests are grouped by the
    `dataflow.bucket_length` bucket of prompt + max_new_tokens; each
    active bucket owns `slots` decode rows. With `pages="off"` a bucket
    owns dense (slots, H, bucket, D) caches per layer and every step is
    `decode_step_slots` (prefill IS decode: prompt tokens go through the
    same step). With `pages="on"` (the configuration that runs the
    paged attention kernel) the caches are one refcounted page pool
    (`pages.PagePool`) with a content-hashed prefix tree, so shared
    prompt prefixes prefill once, and prompts prefill in chunks of
    `prefill_chunk` tokens per dispatch (`decode_paged_chunk`).
  * **admit/evict per step** — every scheduler step fires injected
    faults, applies cancellations, evicts expired requests, admits
    queued ones into free slots, runs one batched dispatch per active
    bucket, and streams the freshly sampled tokens. Sampling is
    host-side numpy with each request's own seeded RandomState, so a
    request's stream never depends on what shares its batch;
    `pages="on"` output equals `pages="off"` output.

The request lifecycle, as in the JAX package:

  * **admission control** — every accept is gated on a memory budget
    (`memsafe.check_budget`): resident parameters (the drafter's too) +
    every allocated bucket's caches or the page pool + the step's
    execution peak, against the device capacity. A predicted overrun is
    a `429` verdict or a rung of the ladder below, never a device OOM.
    The JAX package predicts the execution peak from XLA's AOT
    analysis; on the card this server measures it once per bucket with
    one fully masked dispatch (`_exec_peak`), and on the CPU it has none
    and checks resident bytes alone, as the JAX package does when
    analysis is withheld.
  * **bounded queue, backpressure, load shedding** — at most
    `serve_queue_depth` requests wait; beyond that `serve_shed` rejects
    the newcomer or displaces the oldest waiter (503 verdicts).
  * **deadlines and cancellation** — a request carries an absolute
    deadline on the server's `clock` (`deadline_ms` or the
    `serve_deadline_ms` default); expired requests are evicted BETWEEN
    decode steps (partial tokens stay delivered, `504 deadline ...`)
    and their pages or slot reclaimed in the same step. `cancel()` and
    the `cancel@req:N` fault do the same on demand (`499 cancelled`).
  * **retry** — each batched dispatch runs under
    `resilience.RetryPolicy` (transient OSError / ConnectionError /
    TimeoutError only; a CUDA error is never retried).
  * **degradation ladder** — when admission predicts an overrun (dense)
    or the pool is short of pages (paged): (1) shrink the request's
    max_new_tokens to a smaller bucket (floored at
    `serve_min_new_tokens`), (2) evict-and-requeue the youngest running
    request (its replay is deterministic; already streamed tokens are
    not re-sent), (3) reject with a 429 when nothing else holds memory.
  * **speculative decoding** — with `drafter=` under `pages="on"`, a
    round in which every active slot is past its prompt and one is
    greedy runs the drafter's greedy chain of `spec_k` proposals
    (`decode_paged_draft` on the pool's "draft" stream) and verifies
    them in one `spec_k + 1`-token chunk with every step's logits
    (`decode_paged_chunk(full=True)`); exact greedy acceptance keeps
    the stream equal to plain greedy decode. Sampled rows ride along
    with one ordinary token.
  * **fault drills** — `resilience.FaultInjector`'s `slow_client:ms`
    (stream consumer stalls), `burst:N@step:K` (`on_burst(N)` at
    scheduler step K), `cancel@req:N`, and the fleet's `kill_replica`
    (SIGKILL of this process) and `wedge_replica` (the scheduler parks,
    lock released, until `stop()`), each `@step:K` of the scheduler.

Where the port differs from the JAX package: a drafter whose vocabulary
differs from the target's raises at construction (the JAX package
accepts it and only its `check` lint flags it); a paged request whose
smallest table could never fit the pool is rejected at submit with the
JAX ladder's `page pool exhausted` verdict, where the JAX package queues
it until nothing runs; under a byte-budget overrun the paged server
seats a shrunk or re-admitted request through its page allocator, where
the JAX package's ladder would build a dense group.

Observers, as in the JAX package, each behind its module bool:
telemetry's `serve_requests_total{outcome=}`, `serve_tokens_total`,
`serve_deadline_missed_total`, `serve_degraded_total`,
`serve_ttft_seconds`, `serve_queue_wait_seconds`, `serve_queue_depth`
and `serve_active_requests` (with `serve` events for the degradation
ladder and for every request that does not complete); trace spans
`serve.queue_wait` and `serve.admit` per admitted request,
`serve.decode_step` (dispatch to the host fetch of the logits) and
`serve.stream` per round; flight-ring `serve` records. The round's host
fetch is its fence already, so observing adds none.

The operations layer, at the JAX package's sites, each behind its
module bool: mx.slo journals every request (submit before any verdict,
admit, first dispatch, each new token, stream delivery, degradation and
retry events, the terminal verdict; `Request._slo_j` stays None while
slo is off); mx.goodput claims each round's decode (`serve_decode`, or
`serve_degraded` when a slot of the bucket was shrunk or requeued) and
the scheduler thread's idle waits (`serve_idle`); mx.guard beats each
scheduler step with phase `serve`; mx.check lints a `pages="on"`
configuration at construction (`lint_paging`) and records each bucket's
first dispatch of each shape (`check.check_jit`: captured constants,
upcasts, caches replaced instead of updated in place). `servers()`
lists the live servers (a WeakSet that construction fills; mx.scope's
/statusz reads each one's `stats()`), and `note_dispatch` counts every
batched dispatch while serving is armed (`dispatches()`), which
constructing a Server does, as in the JAX package. A round's host fetch
of the logits is its fence already, so none of these adds a
synchronisation.
"""
from __future__ import annotations

import collections
import os
import queue as _pyqueue
import signal
import sys
import threading
import time
import weakref

import numpy as np
import torch

from . import _locklint
from . import check as _check
from . import config as _config
from . import dataflow as _dataflow
from . import diagnostics as _diagnostics
from . import goodput as _goodput
from . import guard as _guard
from . import memsafe as _memsafe
from . import pages as _pages
from . import resilience as _resilience
from . import slo as _slo
from . import telemetry as _telemetry
from . import trace as _trace

__all__ = ["Server", "Request", "QUEUED", "RUNNING", "DONE", "REJECTED",
           "SHED", "EXPIRED", "CANCELLED", "FAILED", "TERMINAL", "enable",
           "disable", "enabled", "note_dispatch", "dispatches", "servers"]

# request lifecycle states
QUEUED = "queued"        # accepted, waiting for a slot
RUNNING = "running"      # owns a batch slot, decoding
DONE = "done"            # all tokens generated (or eos)
REJECTED = "rejected"    # can never be served (413/429-style)
SHED = "shed"            # load shedding dropped it (503-style)
EXPIRED = "expired"      # deadline passed; evicted between decode steps
CANCELLED = "cancelled"  # client/injected cancellation (499-style)
FAILED = "failed"        # scheduler error surfaced to the request (500)
TERMINAL = frozenset({DONE, REJECTED, SHED, EXPIRED, CANCELLED, FAILED})

_lock = _locklint.make_lock("serve.module")
_enabled = False          # the fast-path bool; the dispatch hook reads it
_dispatches = 0           # batched dispatches seen at the hook site
# live Server objects (weak: a dropped server must not be pinned by the
# registry) — mx.scope's /statusz surfaces each one's stats()
_servers = weakref.WeakSet()


def servers():
    """The live Server objects of this process (construction registers
    them; garbage collection removes them)."""
    return list(_servers)


def enabled():
    """True while serving instrumentation is armed (the dispatch hook
    reads the module bool directly; this is the public spelling)."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def note_dispatch(model_name, t0=None):
    """Dispatch hook, called by the server for every batched dispatch
    while serving is armed (`Server._retried`). Callers gate on the
    module bool — this function is never reached while disabled."""
    global _dispatches
    with _lock:
        _dispatches += 1


def dispatches():
    """Batched dispatches observed at the hook site this process."""
    with _lock:
        return _dispatches


_M_REQUESTS = _telemetry.counter(
    "serve_requests_total", "serving requests by terminal outcome "
    "(completed / rejected / shed / expired / cancelled / failed)")
_M_TOKENS = _telemetry.counter(
    "serve_tokens_total", "tokens generated and streamed by mx.serve")
_M_DEADLINE_MISS = _telemetry.counter(
    "serve_deadline_missed_total", "requests whose deadline expired "
    "(evicted between decode steps, or expired while still queued)")
_M_DEGRADED = _telemetry.counter(
    "serve_degraded_total", "graceful-degradation ladder transitions, by "
    "action: shrink_max_new (request admitted with a clamped token "
    "budget) or evict_requeue (youngest running request evicted and "
    "requeued to free KV pages)")
_M_TTFT = _telemetry.histogram(
    "serve_ttft_seconds", "time-to-first-token: submit to the first "
    "generated token landing in the request's stream")
_M_QWAIT = _telemetry.histogram(
    "serve_queue_wait_seconds", "time a request waited in the bounded "
    "queue before admission to a decode slot")
_M_QDEPTH = _telemetry.gauge(
    "serve_queue_depth", "requests currently waiting in the bounded "
    "admission queue (capacity serve_queue_depth)")
_M_ACTIVE = _telemetry.gauge(
    "serve_active_requests", "requests currently holding a decode slot")

_EOS_SENTINEL = object()


class Request:
    """One generation request moving through the serving lifecycle.

    `id` (admission-order sequence number — the N the `cancel@req:N`
    fault spec targets), `state` / `verdict` ('200 ok', '413 ...',
    '429 ...', '503 ...', '504 deadline ...', '499 cancelled ...',
    '500 ...'), `tokens` (generated so far), `max_new_tokens` (EFFECTIVE
    — the shrink rung may clamp it, recorded in `degraded`),
    `requeues`, `deadline` (absolute, on the server's clock) and the
    timings `queue_wait_s` / `ttft_s`. Consume with `stream()` or
    `result(timeout)`; both need the scheduler driven
    (`Server.start()` or `step()`/`drain()`)."""

    def __init__(self, seq, prompt, max_new_tokens, eos, temperature,
                 top_k, seed, deadline=None):
        self.id = seq
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.requested_new_tokens = int(max_new_tokens)
        self.eos = eos
        self.temperature = float(temperature or 0.0)
        self.top_k = int(top_k or 0)
        self.seed = int(seed)
        self.deadline = deadline
        self.state = QUEUED
        self.verdict = None
        self.tokens = []
        self.degraded = None
        self.requeues = 0
        self.evicted_once = False         # each request triggers <= 1 evict
        self._streamed = 0                # replay high-water mark
        self._slo_j = None                # mx.slo journal (None while off)
        self._rng = None
        self._stream_q = _pyqueue.Queue()
        self._done = threading.Event()
        self._submit_perf = time.perf_counter()
        self._admit_perf = None
        self._first_token_perf = None
        self._finish_perf = None

    def result(self, timeout=None):
        """Block until terminal; returns the generated tokens (int32,
        possibly partial — check `state`/`verdict`). Raises TimeoutError
        if `timeout` passes with the request still live."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} still {self.state} after {timeout}s — "
                "is the server running? (Server.start() or drain())")
        return np.asarray(self.tokens, np.int32)

    def stream(self, idle_s=None):
        """Iterate tokens as the scheduler generates them, ending when
        the request reaches a terminal state (partial on expiry/cancel).
        A `slow_client:ms` fault spec injects a per-token consumer stall
        here — the CLIENT side — which never slows the scheduler. With
        `idle_s`, the iteration also yields None after every `idle_s`
        seconds without a token (the fleet endpoint's keep-alive cue)."""
        delay = None
        inj = _resilience._injector if _resilience._enabled else None
        if inj is not None:
            arg = inj.consume("slow_client")
            if arg:
                delay = float(arg) / 1000.0
                print(f"mx.serve: fault injection: slow client — "
                      f"{arg} ms stall per streamed token (request "
                      f"{self.id})", file=sys.stderr)
        if _slo._enabled and self._slo_j is not None:
            _slo.note_stream_start(self)
        try:
            while True:
                try:
                    tok = self._stream_q.get(timeout=idle_s)
                except _pyqueue.Empty:
                    yield None
                    continue
                if tok is _EOS_SENTINEL:
                    return
                if delay:
                    time.sleep(delay)
                if self._slo_j is not None:
                    _slo.note_delivered(self)
                yield tok
        finally:
            # sentinel, break or a collected generator: the delivery
            # timeline is over — mx.slo can finalize
            if self._slo_j is not None:
                _slo.note_stream_end(self)

    @property
    def done(self):
        return self.state in TERMINAL

    @property
    def queue_wait_s(self):
        if self._admit_perf is None:
            return None
        return self._admit_perf - self._submit_perf

    @property
    def ttft_s(self):
        if self._first_token_perf is None:
            return None
        return self._first_token_perf - self._submit_perf

    def _reset_for_replay(self):
        """Requeue support: generation restarts from the prompt and —
        being deterministic per request (greedy, or the per-request rng
        reseeded here) — reproduces the same tokens; `_streamed` keeps
        already-delivered tokens from being re-sent."""
        self.tokens = []
        self._rng = None
        self.requeues += 1
        self.state = QUEUED

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state!r}, "
                f"tokens={len(self.tokens)}/{self.max_new_tokens}"
                + (f", verdict={self.verdict!r}" if self.verdict else "")
                + ")")


class _Group:
    """Decode state of one dense length bucket: `slots` requests sharing
    (slots, H, bucket, D) caches; `pos[i]` is the next position slot i
    writes (prompt tokens first, then its own sampled tokens)."""

    __slots__ = ("bucket", "slots", "pos", "caches", "cache_bytes")

    def __init__(self, bucket, caches):
        self.bucket = bucket
        self.caches = caches
        self.cache_bytes = _memsafe.resident_bytes(caches)
        n = int(caches[0].shape[0])
        self.slots = [None] * n
        self.pos = [0] * n

    def free_slot(self):
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]


class _PagedGroup:
    """The paged counterpart of `_Group`: slot i owns a LIST of page ids
    (`pages[i]`, one pool reference each) whose order IS its page table;
    `inserted[i]` latches the one-time prefix-tree insertion.
    `cache_bytes` is 0: the pool is allocated once at construction and
    priced there, not per bucket."""

    __slots__ = ("bucket", "n_pg", "slots", "pos", "pages", "inserted",
                 "cache_bytes")

    def __init__(self, bucket, n_slots, n_pg):
        self.bucket = bucket
        self.n_pg = n_pg
        self.cache_bytes = 0
        self.slots = [None] * n_slots
        self.pos = [0] * n_slots
        self.pages = [[] for _ in range(n_slots)]
        self.inserted = [False] * n_slots

    def free_slot(self):
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def active(self):
        return [i for i, r in enumerate(self.slots) if r is not None]


class Server:
    """Continuous-batching inference server over one `GPTForCausalLM`,
    on the model's device.

    `submit()` never raises for overload: rejection, shedding and expiry
    are verdicts on the returned Request. Drive it with `start()`/
    `stop()` (a background thread), a `with` block, or synchronously
    with `step()` / `drain()` (tests inject `clock=` for deterministic
    deadlines). Knobs default to the `serve_*` / `pages_*` config
    values. `on_burst(n)`, when set, is how the `burst:N@step:K` fault
    spec materialises synthetic load; `retry` is the dispatches'
    `resilience.RetryPolicy`; `drafter` (pages="on") is the speculative
    decoding model, proposing `spec_k` tokens a round."""

    def __init__(self, model, slots=None, queue_depth=None, shed=None,
                 default_deadline_ms=None, buckets=None, max_len=None,
                 clock=None, retry=None, pages=None, drafter=None,
                 page_size=None, pool_pages=None, prefill_chunk=None,
                 spec_k=None):
        self.model = model
        g = model.gpt
        self._n_l = len(g.layers)
        self._heads = g.layers[0].attn._num_heads
        self._units = g.word_embed.weight.shape[1]
        self._cache_dtype = g.word_embed.weight.dtype
        self._max_len = int(max_len or g.position_embed.shape[0])
        pages = pages if pages is not None else _config.get("pages")
        if pages not in ("off", "on"):
            raise ValueError(f"pages must be 'off' or 'on', got {pages!r}")
        self._paged = pages == "on"
        self._drafter = drafter
        if drafter is not None:
            dv = int(drafter.gpt.word_embed.weight.shape[0])
            tv = int(g.word_embed.weight.shape[0])
            if dv != tv:
                raise ValueError(
                    f"drafter vocabulary {dv} differs from the target's "
                    f"{tv}: its proposals could not be verified")
            if drafter.device != model.device:
                raise ValueError(f"drafter on {drafter.device}, target on "
                                 f"{model.device}")
        self._slots = int(slots or _config.get("serve_slots"))
        self._queue_depth = int(queue_depth if queue_depth is not None
                                else _config.get("serve_queue_depth"))
        shed = shed or _config.get("serve_shed")
        if shed not in ("reject", "oldest"):
            raise ValueError(
                f"serve_shed must be 'reject' or 'oldest', got {shed!r}")
        self._shed = shed
        self._default_deadline_ms = float(
            default_deadline_ms if default_deadline_ms is not None
            else _config.get("serve_deadline_ms"))
        self._buckets = self._parse_buckets(buckets)
        self._clock = clock or time.monotonic
        self._retry = retry or _resilience.RetryPolicy()
        self._lock = threading.RLock()
        self._queue = collections.deque()
        self._groups = {}          # bucket -> _Group / _PagedGroup
        self._peaks = {}           # (bucket, C, full) -> measured bytes
        self._by_id = {}
        self._pending_cancels = []
        self._seq = 0
        self._sched_step = 0
        self._stats = {
            "submitted": 0, "completed": 0, "rejected": 0, "shed": 0,
            "expired": 0, "cancelled": 0, "failed": 0, "tokens": 0,
            "steps": 0, "requeues": 0, "degraded": 0, "retries": 0,
        }
        self._params_bytes = self._measure_params(model)
        self._pool = None
        self._tree = None
        if self._paged:
            self._init_paged(page_size, pool_pages, prefill_chunk, spec_k)
        self.on_burst = None
        self._thread = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._error = None
        self._stopped = False
        self._checked = set()      # (what, bucket, shapes) recorded once
        enable()
        _servers.add(self)

    # -- construction helpers -------------------------------------------
    def _parse_buckets(self, buckets):
        if buckets is None:
            raw = _config.get("serve_buckets")
            buckets = [int(b) for b in str(raw).split(",") if b.strip()] \
                if raw else None
        if buckets is None:
            return None                       # pow2 policy
        bl = sorted(int(b) for b in buckets)
        if not bl:
            raise ValueError("serve buckets: empty list")
        if bl[-1] > self._max_len:
            raise ValueError(
                f"serve bucket {bl[-1]} exceeds the model's max_length "
                f"{self._max_len}")
        return bl

    @staticmethod
    def _measure_params(model):
        # each parameter once: a shared one is listed under every path
        return _memsafe.resident_bytes(model.parameters())

    def _init_paged(self, page_size, pool_pages, prefill_chunk, spec_k):
        """Build the page pool and prefix tree. The usable position range
        rounds DOWN to a page multiple and buckets round UP to one
        (`_bucket_for`), so a paged bucket's gathered KV length
        n_pg*page_size equals the bucket exactly: the same operand shapes
        as the dense cache. The default pool holds slots *
        max_len/page_size data pages (the dense worst case), plus one
        scratch page per slot. A drafter adds the pool's "draft" stream,
        with the drafter's heads, head width and dtype, addressed by the
        same page ids."""
        ps = int(page_size or _config.get("pages_page_size"))
        if ps < 1:
            raise ValueError(f"pages_page_size must be >= 1, got {ps}")
        self._page_size = ps
        self._prefill_chunk = max(
            1, int(prefill_chunk or _config.get("pages_prefill_chunk")))
        self._spec_k = max(1, int(spec_k or _config.get("pages_spec_k")))
        max_paged = (self._max_len // ps) * ps
        if max_paged < 1:
            raise ValueError(
                f"pages_page_size {ps} exceeds the model's max_length "
                f"{self._max_len} — no position fits a single page")
        self._max_len = max_paged
        D = self._units // self._heads
        streams = {"target": [(self._heads, D, self._cache_dtype)]
                   * (2 * self._n_l)}
        if self._drafter is not None:
            dg = self._drafter.gpt
            d_heads = dg.layers[0].attn._num_heads
            d_units = dg.word_embed.weight.shape[1]
            streams["draft"] = [(d_heads, d_units // d_heads,
                                 dg.word_embed.weight.dtype)] \
                * (2 * len(dg.layers))
            self._params_bytes += self._measure_params(self._drafter)
        data = int(pool_pages or _config.get("pages_pool_pages")) \
            or self._slots * (self._max_len // ps)
        self._pool = _pages.PagePool(ps, data, self._slots, streams,
                                     device=self.model.device)
        self._tree = _pages.PrefixTree(self._pool)
        self._stats.update({
            "prompt_tokens": 0, "prefix_tokens": 0, "prefix_hits": 0,
            "chunk_dispatches": 0, "spec_rounds": 0,
            "drafts_proposed": 0, "drafts_accepted": 0,
        })
        if _check._enabled:
            smallest = self._buckets[0] if self._buckets is not None \
                else max(1, int(_config.get("bucket_pad_min")))
            _check.lint_paging(
                f"serve.Server(pages=on,page_size={ps})", ps, smallest,
                int(self.model.gpt.word_embed.weight.shape[0]),
                None if self._drafter is None
                else int(self._drafter.gpt.word_embed.weight.shape[0]))
        _pages.enable()

    # -- client surface --------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos=None, temperature=0.0,
               top_k=0, seed=0, deadline_ms=None):
        """Enqueue one generation request; returns a Request immediately
        (already terminal when shed, or rejected as unservable). Never
        raises for overload."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or int(max_new_tokens) <= 0:
            raise ValueError("submit needs a non-empty prompt and "
                             "max_new_tokens >= 1")
        ms = deadline_ms if deadline_ms is not None \
            else (self._default_deadline_ms or None)
        deadline = (self._clock() + float(ms) / 1000.0) if ms else None
        with self._lock:
            req = Request(self._seq, prompt, max_new_tokens, eos,
                          temperature, top_k, seed, deadline)
            self._seq += 1
            self._by_id[req.id] = req
            self._stats["submitted"] += 1
            # journal BEFORE any admission verdict: rejected and shed
            # requests are exactly the ones mx.slo must explain
            if _slo._enabled:
                _slo.note_submit(req)
            if self._error is not None:
                self._finish(req, FAILED,
                             f"500 scheduler failed earlier: "
                             f"{type(self._error).__name__}: {self._error}")
                return req
            if self._stopped:
                self._finish(req, SHED, "503 server stopped")
                return req
            need = prompt.size + int(max_new_tokens)
            if need > self._max_len:
                self._finish(req, REJECTED,
                             f"413 too long: prompt {prompt.size} + "
                             f"max_new_tokens {max_new_tokens} exceeds "
                             f"max_length {self._max_len}")
                return req
            over = self._solo_overrun(req)
            if over is not None:
                self._finish(req, REJECTED, over)
                return req
            if len(self._queue) >= self._queue_depth:
                if self._shed == "reject":
                    self._finish(req, SHED,
                                 "503 shed: queue full "
                                 f"({self._queue_depth} deep, "
                                 "serve_shed=reject)")
                    return req
                oldest = self._queue.popleft()
                self._finish(oldest, SHED,
                             "503 shed: displaced by newer request "
                             f"{req.id} (serve_shed=oldest)")
            self._queue.append(req)
            if _telemetry._enabled:
                _M_QDEPTH.set(len(self._queue))
        self._wake.set()
        return req

    def cancel(self, req_or_id):
        """Cancel a request: removed from the queue, or — if running —
        evicted between decode steps (partial tokens stay delivered).
        No-op on already-terminal requests."""
        req = self._by_id.get(req_or_id) \
            if not isinstance(req_or_id, Request) else req_or_id
        if req is None:
            return
        with self._lock:
            self._pending_cancels.append(req)
        self._wake.set()

    def stats(self):
        """Counter snapshot plus live occupancy (plain dict)."""
        with self._lock:
            out = dict(self._stats)
            out["queued"] = len(self._queue)
            out["running"] = sum(len(g.active())
                                 for g in self._groups.values())
            out["buckets_allocated"] = sorted(self._groups)
            out["scheduler_steps"] = self._sched_step
            if self._paged:
                out["pages"] = "on"
                out["page_size"] = self._page_size
                out["pool_pages_total"] = self._pool.data_pages
                out["pool_pages_free"] = self._pool.free_pages()
                out["tree_nodes"] = len(self._tree.nodes)
                out["cow_copies"] = self._pool.stats["cow_copies"]
                pt = self._stats["prompt_tokens"]
                out["prefix_hit_rate"] = (
                    self._stats["prefix_tokens"] / pt if pt else 0.0)
                dp = self._stats["drafts_proposed"]
                out["accepted_draft_rate"] = (
                    self._stats["drafts_accepted"] / dp if dp else 0.0)
        return out

    def admission_hints(self):
        """What a router needs to PREDICT this server's admission verdict
        without a round trip: the headroom next to the analytic cache
        cost of every bucket admission could newly allocate (dense), or
        the free-page count (paged) and, beside it, the count of pages
        only the prefix tree holds, which admission evicts on demand
        (`pool_pages_reclaimable`: the JAX package's hints lack it, and
        its router predicts a 429 that the server would not give). A
        None `headroom_bytes` means the capacity is unknown (the CPU) —
        nothing to predict."""
        out = {"max_len": self._max_len, "slots": self._slots,
               "queue_depth": self._queue_depth,
               "buckets": self._buckets,       # None => pow2 policy
               "pages": "on" if self._paged else "off"}
        cap = _memsafe.capacity_bytes(self.model.device)
        if cap is None:
            out["headroom_bytes"] = None
            return out
        with self._lock:
            if self._paged:
                resident = self._params_bytes + self._pool.pool_bytes()
                out["page_size"] = self._page_size
                out["pool_pages_free"] = self._pool.free_pages()
                # tree-only pages: admission evicts them on demand
                # (`_paged_alloc`), so a router counts them as free
                out["pool_pages_reclaimable"] = self._tree.reclaimable()
            else:
                resident = self._params_bytes + sum(
                    g.cache_bytes for g in self._groups.values())
                if self._buckets is not None:
                    cands = list(self._buckets)
                else:
                    cands, b = [], max(1, int(_config.get("bucket_pad_min")))
                    while b < self._max_len:
                        cands.append(b)
                        b *= 2
                    cands.append(self._max_len)
                out["bucket_cost"] = {str(b): self._cache_bytes(b)
                                      for b in cands}
        out["headroom_bytes"] = max(0, int(cap) - int(resident))
        return out

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Run the scheduler in a background thread until `stop()`."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stopped = False
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="mx-serve-scheduler", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the background scheduler; outstanding requests finish
        with a '499 server stopped' verdict so no client blocks forever,
        and the prefix tree drops its page references."""
        self._stopped = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        with self._lock:
            live = [r for r in self._by_id.values()
                    if r.state not in TERMINAL]
            for r in live:
                self._remove_from_slots(r)
                self._finish(r, CANCELLED, "499 server stopped")
            self._queue.clear()
            self._gc_groups()
            if self._paged:
                self._tree.clear()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _loop(self):
        while not self._stop.is_set():
            try:
                work = self.step()
            except Exception as e:  # noqa: BLE001 — surfaced to requests
                self._scheduler_failed(e)
                return
            if not work:
                if _goodput._enabled:
                    # an empty scheduler pass is queue-idle wall-clock
                    # (coalesced into one record per idle span)
                    t0 = time.perf_counter()
                    self._wake.wait(0.005)
                    _goodput.note("serve_idle", t0)
                else:
                    self._wake.wait(0.005)
                self._wake.clear()

    def _scheduler_failed(self, exc):
        """An error escaped a scheduler step (overload paths — budget,
        deadline, shed, cancel — are all verdicts and cannot reach
        here): fail every live request with a 500 verdict so no client
        wedges on a dead scheduler, and keep the error for
        `raise_if_failed`."""
        self._error = exc
        print(f"mx.serve: scheduler error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        if _diagnostics._enabled:
            _diagnostics.record_event("serve", action="scheduler_error",
                                      error=f"{type(exc).__name__}: {exc}")
        with self._lock:
            for r in list(self._by_id.values()):
                if r.state not in TERMINAL:
                    self._remove_from_slots(r)
                    self._finish(r, FAILED,
                                 f"500 scheduler error: "
                                 f"{type(exc).__name__}: {exc}")
            self._queue.clear()

    def raise_if_failed(self):
        if self._error is not None:
            raise self._error

    def busy(self):
        """True while any request is queued, holds a slot, or waits to be
        cancelled."""
        with self._lock:
            if self._queue or self._pending_cancels:
                return True
            return any(g.active() for g in self._groups.values())

    def drain(self, max_steps=100_000):
        """Drive the scheduler synchronously until idle. Raises
        RuntimeError after `max_steps` — a wedged scheduler must fail
        loudly, not hang the caller."""
        n = 0
        while self.busy():
            self.step()
            n += 1
            if n >= max_steps:
                raise RuntimeError(
                    f"mx.serve: scheduler still busy after {max_steps} "
                    f"steps — {self.stats()}")
        return n

    # -- scheduler -------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One scheduler iteration: fire injected faults, apply
        cancellations, evict expired requests, admit from the queue
        (admission control + degradation ladder), run one batched
        dispatch per active bucket, stream the new tokens (with no
        autograd graph, also for a model trained eagerly). Returns True
        while work remains. Overload never raises out of here — only
        scheduler bugs do."""
        with self._lock:
            self._sched_step += 1
            n = self._sched_step
        self._fire_faults(n)
        if _guard._enabled:
            _guard.heartbeat(phase="serve")
        # execution peaks are measured OUTSIDE the lock (a dispatch each;
        # submit/cancel from client threads must not block behind it)
        self._prewarm_buckets()
        with self._lock:
            self._apply_cancels()
            self._evict_expired()
            # reclaim drained buckets BEFORE admission: caches freed by
            # a cancel/expiry this very step must not count against the
            # incoming request's budget
            self._gc_groups()
            self._admit()
            groups = [g for g in self._groups.values() if g.active()]
        for grp in groups:
            decode = self._decode_group_paged if self._paged \
                else self._decode_group
            if not _goodput._enabled:
                decode(grp)
                continue
            # decode time for a batch holding any degraded or requeued
            # request is "serve_degraded": capacity spent delivering
            # below-contract service rather than clean goodput
            with self._lock:
                degr = any(grp.slots[i].degraded or grp.slots[i].requeues
                           for i in grp.active())
            t0 = time.perf_counter()
            decode(grp)
            _goodput.note("serve_degraded" if degr else "serve_decode", t0)
        with self._lock:
            self._gc_groups()
            if _telemetry._enabled:
                _M_QDEPTH.set(len(self._queue))
                _M_ACTIVE.set(sum(len(g.active())
                                  for g in self._groups.values()))
        return self.busy()

    def _prewarm_buckets(self):
        """Measure the execution peak of every bucket the queue will need
        before the locked admission pass (only when a capacity is known:
        the card, or the `device_bytes_limit` knob)."""
        if _memsafe.capacity_bytes(self.model.device) is None:
            return
        with self._lock:
            pending = [r for r in self._queue if r.state == QUEUED]
        for r in pending:
            self._exec_peak(self._bucket_for(r.prompt.size
                                             + r.max_new_tokens))

    def _fire_faults(self, sched_step):
        inj = _resilience._injector if _resilience._enabled else None
        if inj is None:
            return
        hit = inj.take("burst", step=sched_step)
        if hit is not None:
            count = int(hit["arg"] or 1)
            print(f"mx.serve: fault injection: burst of {count} at "
                  f"scheduler step {sched_step}", file=sys.stderr)
            if self.on_burst is not None:
                self.on_burst(count)
        # a step-less cancel spec waits, still armed, until its target
        # request has been submitted — consuming it on an idle tick would
        # silently no-op the cancellation drill
        hit = inj.take("cancel", step=sched_step,
                       ready=lambda spec: spec["req"] is not None
                       and spec["req"] in self._by_id)
        if hit is not None:
            rid = hit.get("req")
            print(f"mx.serve: fault injection: cancel request {rid} at "
                  f"scheduler step {sched_step}", file=sys.stderr)
            if rid is not None:
                self.cancel(int(rid))
        # the fleet drills, fired from the scheduler so they land mid-
        # generation: kill_replica is the SIGKILLed-worker failover drill
        # (the router replays the in-flight requests on a survivor);
        # wedge_replica parks the scheduler WITHOUT holding the lock, so
        # health checks keep answering while tokens stop: the stalled
        # but alive replica of the router's per-read stall bound. The
        # park ends only when the server stops (the JAX package's never
        # ends; from the router's side the two are alike)
        hit = inj.take("kill_replica", step=sched_step)
        if hit is not None:
            print(f"mx.serve: fault injection: kill_replica at scheduler "
                  f"step {sched_step} (pid {os.getpid()})", file=sys.stderr)
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        hit = inj.take("wedge_replica", step=sched_step)
        if hit is not None:
            print(f"mx.serve: fault injection: wedge_replica at scheduler "
                  f"step {sched_step} — scheduler parked, process alive",
                  file=sys.stderr)
            sys.stderr.flush()
            while not self._stop.wait(3600):
                pass

    def _apply_cancels(self):
        pending, self._pending_cancels = self._pending_cancels, []
        for req in pending:
            if req.state in TERMINAL:
                continue
            self._remove_from_slots(req)
            try:
                self._queue.remove(req)
            except ValueError:
                pass
            self._finish(req, CANCELLED,
                         f"499 cancelled after {len(req.tokens)} tokens")

    def _evict_expired(self):
        now = self._clock()
        for grp in self._groups.values():
            for i in grp.active():
                r = grp.slots[i]
                if r.deadline is not None and now > r.deadline:
                    self._vacate(grp, i)
                    self._note_deadline_miss(r, running=True)
        for r in list(self._queue):
            if r.deadline is not None and now > r.deadline:
                self._queue.remove(r)
                self._note_deadline_miss(r, running=False)

    def _note_deadline_miss(self, req, running):
        if _telemetry._enabled:
            _M_DEADLINE_MISS.inc()
        where = (f"evicted mid-generation after {len(req.tokens)} tokens "
                 "(KV pages reclaimed)") if running else "expired in queue"
        self._finish(req, EXPIRED, f"504 deadline: {where}")

    # -- admission -------------------------------------------------------
    def _bucket_for(self, need):
        if self._buckets is not None:
            b = _dataflow.bucket_length(need, self._buckets)
        else:
            b = _dataflow.bucket_length(need, "pow2")
        b = min(int(b), self._max_len)
        if self._paged:
            # paged buckets are page multiples, so a bucket's gathered KV
            # length (n_pg * page_size) equals the bucket exactly
            ps = self._page_size
            b = min(((b + ps - 1) // ps) * ps, self._max_len)
        return b

    def _buckets_below(self, bucket, floor):
        """Candidate shrink buckets strictly below `bucket`, largest
        first, each still holding `floor` total positions. The pow2
        policy never goes below `bucket_pad_min` — shrinking must not
        mint bucket sizes normal admission would never produce."""
        if self._buckets is not None:
            cands = [b for b in self._buckets if floor <= b < bucket]
        else:
            lo = max(1, int(_config.get("bucket_pad_min")))
            cands, b = [], bucket // 2
            while b >= max(floor, lo):
                cands.append(b)
                b //= 2
        return sorted(cands, reverse=True)

    def _cache_bytes(self, bucket):
        """Analytic KV bytes for one bucket's caches: 2*n_l tensors of
        (slots, H, bucket, D)."""
        D = self._units // self._heads
        item = torch.empty((), dtype=self._cache_dtype).element_size()
        return 2 * self._n_l * self._slots * self._heads * bucket * D * item

    def _runner(self, bucket):
        """The dense bucket's dispatch, under the JAX package's name:
        run(tok, t, caches) -> logits, one `decode_step_slots` that
        writes the bucket's caches in place (where the JAX package's
        runner is the bucket's jitted step, donating them).
        `run.aot_exec_peak()` is the bucket's execution peak
        (`_exec_peak`)."""
        model, n_l = self.model, self._n_l

        def run(tok, t, caches):
            return model.decode_step_slots(tok, t, caches[:n_l],
                                           caches[n_l:])[0]

        run.aot_exec_peak = lambda *avals: self._exec_peak(bucket)
        return run

    def _exec_peak(self, bucket):
        """Execution-peak bytes of the heaviest dispatch the bucket can
        run, beyond its resident arguments: the speculative verify chunk
        (spec_k + 1 steps, every step's logits) when a drafter is
        attached, else the prefill chunk (paged), or the one-token step
        (dense). None off the card (the budget then checks resident bytes
        alone)."""
        if not self._paged:
            return self._measure_peak(bucket)
        if self._drafter is not None:
            return self._measure_peak(bucket, self._spec_k + 1, True)
        return self._measure_peak(bucket, self._prefill_chunk)

    def _measure_peak(self, bucket, C=1, full=False):
        """Bytes a dispatch of bucket `bucket` (chunk of C steps, all
        logits when `full`) allocates on the card beyond what is resident
        before it, measured once per (bucket, C, full) around one fully
        masked dispatch with `torch.cuda.reset_peak_memory_stats`: every
        paged row runs n = 0, so its writes land in the scratch pages and
        no live page is touched; a dense bucket runs one step on caches
        of its own, freed after. None off the card."""
        key = (bucket, C, full)
        if key in self._peaks:
            return self._peaks[key]
        dev = self.model.device
        peak = None
        if dev.type == "cuda":
            B = self._slots
            i32 = dict(dtype=torch.int32, device=dev)
            with torch.no_grad():
                if self._paged:
                    lead = (torch.zeros((B, C), **i32),
                            torch.zeros((B,), **i32),
                            torch.zeros((B,), **i32),
                            torch.zeros((B, bucket // self._page_size),
                                        **i32))
                    torch.cuda.synchronize(dev)
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    out, _ = self.model.decode_paged_chunk(
                        *lead, self._pool.state["target"], self._page_size,
                        full=full)
                else:
                    caches = self.model._alloc_caches(B, bucket)
                    tok = torch.zeros((B,), **i32)
                    torch.cuda.synchronize(dev)
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    out, _, _ = self.model.decode_step_slots(
                        tok, tok, caches[:self._n_l], caches[self._n_l:])
                torch.cuda.synchronize(dev)
                peak = int(torch.cuda.max_memory_allocated(dev)) - base
                del out
        self._peaks[key] = peak
        return peak

    def _admit_budget(self, bucket):
        """The memory budget check for admitting into `bucket`: resident
        params + every allocated bucket's caches (+ this bucket's, if it
        would be newly allocated) or the page pool, + the bucket's
        execution peak, against the capacity. Raises MemoryBudgetError
        on a predicted overrun — BEFORE any allocation or dispatch."""
        cap = _memsafe.capacity_bytes(self.model.device)
        if cap is None:
            return None
        if self._paged:
            # the pool is the cache: one constant resident allocation made
            # at construction — admission only prices the dispatch's peak
            resident = self._params_bytes + self._pool.pool_bytes()
            return _memsafe.check_budget(
                f"serve.decode(bucket={bucket},slots={self._slots},"
                f"pages=on)", self._exec_peak(bucket), resident,
                capacity=cap)
        new_bytes = 0 if bucket in self._groups \
            else self._cache_bytes(bucket)
        resident = self._params_bytes + new_bytes + sum(
            g.cache_bytes for g in self._groups.values())
        return _memsafe.check_budget(
            f"serve.decode(bucket={bucket},slots={self._slots})",
            self._exec_peak(bucket), resident, capacity=cap)

    def _solo_overrun(self, req):
        """Submit-time check: a request that cannot fit even alone gets a
        429 with the accounting at once, instead of aging in the queue —
        its smallest shrunk bucket's caches next to the params over the
        capacity, or (paged) its smallest page table over the whole
        pool."""
        floor_new = max(1, min(int(_config.get("serve_min_new_tokens")),
                               req.max_new_tokens))
        if self._paged:
            need = self._fewest_pages(req, floor_new)
            if need > self._pool.data_pages:
                return (f"429 over capacity: page pool exhausted — "
                        f"request needs {need} pages at its smallest "
                        f"bucket but the pool holds only "
                        f"{self._pool.data_pages}")
        cap = _memsafe.capacity_bytes(self.model.device)
        if cap is None:
            return None
        bucket = self._bucket_for(req.prompt.size + floor_new)
        resident = self._params_bytes + (
            self._pool.pool_bytes() if self._paged
            else self._cache_bytes(bucket))
        if resident > cap:
            return (f"429 over capacity: smallest viable KV bucket "
                    f"{bucket} needs {_memsafe._fmt(resident)} resident "
                    f"(params + caches) but device capacity is "
                    f"{_memsafe._fmt(cap)}")
        return None

    def _fewest_pages(self, req, floor_new):
        """The fewest pages the paged ladder could seat `req` in: its own
        need, or a shrink bucket's whole table."""
        ps = self._page_size
        lp = req.prompt.size
        bucket = self._bucket_for(lp + req.max_new_tokens)
        need = min(-(-(lp + req.max_new_tokens) // ps), bucket // ps)
        for L in self._buckets_below(bucket, lp + floor_new):
            L = min(((L + ps - 1) // ps) * ps, self._max_len)
            if lp + floor_new <= L < bucket:
                need = min(need, L // ps)
        return need

    def _admit(self):
        """Admit queued requests into free slots, oldest first (younger
        requests may pass one whose bucket group is full or over
        budget). Loops while progress is made — an evict-and-requeue
        may unblock the next pass."""
        while True:
            progress = False
            for req in list(self._queue):
                if req.state != QUEUED:
                    continue
                if self._try_admit(req):
                    progress = True
            if not progress:
                return

    def _try_admit(self, req):
        bucket = self._bucket_for(req.prompt.size + req.max_new_tokens)
        grp = self._groups.get(bucket)
        if grp is not None and grp.free_slot() is None:
            return False                     # bucket full: wait
        try:
            self._admit_budget(bucket)
        except _memsafe.MemoryBudgetError as e:
            return self._admit_pressure(req, bucket, e)
        if self._paged:
            got = self._paged_alloc(req, bucket)
            if got is None:
                return self._paged_pressure(req, bucket)
            self._place_paged(req, bucket, got)
            return True
        self._place(req, bucket)
        return True

    def _seat(self, req, bucket, max_new=None):
        """Place `req` in `bucket`: a dense slot, or a paged slot when the
        pool covers its table (False when it does not)."""
        if not self._paged:
            self._place(req, bucket)
            return True
        got = self._paged_alloc(req, bucket, max_new)
        if got is None:
            return False
        self._place_paged(req, bucket, got)
        return True

    def _paged_alloc(self, req, bucket, max_new=None):
        """Match the prompt against the prefix tree and allocate the
        request's EXACT page need: ceil((prompt + max_new) / page_size)
        pages, not the bucket's whole table (unowned table rows pad to
        scratch page 0, whose reads are masked, and a speculative round's
        overshoot writes land in scratch instead of a live page).

        A whole-prompt match would make the first decode write land
        inside the shared last page (the re-fed prompt tail that
        produces the sampling logits), so that page is copied
        (copy-on-write) before the shared reference is dropped.

        Returns (pages, matched_tokens, start_pos) with one pool
        reference held per page, or None when the pool cannot cover the
        need even after evicting unreferenced prefix-tree leaves."""
        ps = self._page_size
        lp = req.prompt.size
        mn = req.max_new_tokens if max_new is None else max_new
        n_pg = min(-(-(lp + mn) // ps), bucket // ps)
        matched_pages, matched = self._tree.match(req.prompt)
        cow = matched > 0 and matched == lp
        need = (n_pg - len(matched_pages)) + (1 if cow else 0)
        if self._pool.free_pages() < need:
            self._tree.evict(need)
        if self._pool.free_pages() < need:
            for p in matched_pages:
                self._pool.decref(p)
            return None
        if cow:
            dup = self._pool.copy_page(matched_pages[-1])
            self._pool.decref(matched_pages[-1])
            matched_pages[-1] = dup
            pos0 = lp - 1
        else:
            pos0 = matched
        pages = matched_pages + self._pool.alloc(n_pg - len(matched_pages))
        return pages, matched, pos0

    def _paged_pressure(self, req, bucket):
        """The degradation ladder under PAGE exhaustion — the paged
        analog of `_admit_pressure`, with the same rungs and
        requeued-request protections: (1) shrink max_new_tokens to a
        smaller bucket needing fewer pages, (2) evict-and-requeue the
        youngest running request (its `_vacate` returns exclusive pages
        to the pool), (3) reject when nothing else holds pages."""
        if req.requeues == 0 and self._paged_shrunk(req, bucket):
            return True
        if req.requeues == 0 and not req.evicted_once:
            victim = self._youngest_running(exclude=req)
            if victim is not None:
                req.evicted_once = True
                self._evict_requeue(victim, for_req=req)
                self._gc_groups()
                if self._seat(req, bucket):
                    return True
                if self._paged_shrunk(req, bucket):
                    return True
        if not any(g.active() for g in self._groups.values()):
            self._queue.remove(req)
            need = -(-(req.prompt.size + req.max_new_tokens)
                     // self._page_size)
            self._finish(
                req, REJECTED,
                f"429 over capacity: page pool exhausted — request "
                f"needs {need} pages but only {self._pool.free_pages()} "
                f"of {self._pool.data_pages} are free with no running "
                f"work to drain")
            return True
        return False

    def _paged_shrunk(self, req, bucket):
        """Degradation rung 1 (paged): clamp the token budget to the
        largest smaller page-multiple bucket whose table the pool can
        cover now."""
        ps = self._page_size
        floor_new = max(1, min(int(_config.get("serve_min_new_tokens")),
                               req.max_new_tokens))
        floor_total = req.prompt.size + floor_new
        seen = set()
        for L in self._buckets_below(bucket, floor_total):
            L = min(((L + ps - 1) // ps) * ps, self._max_len)
            if L >= bucket or L < floor_total or L in seen:
                continue
            seen.add(L)
            grp = self._groups.get(L)
            if grp is not None and grp.free_slot() is None:
                continue
            new_max = L - req.prompt.size
            if not self._seat(req, L, max_new=new_max):
                continue
            self._note_shrunk(req, new_max, L)
            return True
        return False

    def _admit_pressure(self, req, bucket, err):
        """The degradation ladder, walked when admission predicts a
        memory overrun: (1) shrink max_new_tokens to the largest smaller
        bucket that passes the budget, (2) evict-and-requeue the youngest
        running request (its bucket's caches free when the group
        drains), then (3) reject with the accounting if the request
        cannot fit even alone. Anything else stays queued.

        A REQUEUED request is never shrunk and never evicts: its client
        is mid-stream on a promised token budget, and letting it evict
        in turn would let two requests displace each other forever — it
        waits for the running work to drain instead."""
        if req.requeues == 0 and self._admit_shrunk(req, bucket):
            return True
        if req.requeues == 0 and not req.evicted_once:
            victim = self._youngest_running(exclude=req)
            if victim is not None:
                req.evicted_once = True
                self._evict_requeue(victim, for_req=req)
                self._gc_groups()
                try:
                    self._admit_budget(bucket)
                except _memsafe.MemoryBudgetError:
                    if self._admit_shrunk(req, bucket):
                        return True
                else:
                    if self._seat(req, bucket):
                        return True
        if not any(g.active() for g in self._groups.values()):
            # nothing else is holding memory: this request simply does
            # not fit the device — a queue wait cannot save it
            self._queue.remove(req)
            self._finish(req, REJECTED, f"429 over capacity: {err}")
            return True
        return False

    def _admit_shrunk(self, req, bucket):
        """Degradation rung 1: clamp the request's token budget to the
        largest smaller bucket that passes the memory budget (floored at
        serve_min_new_tokens)."""
        floor_new = max(1, min(int(_config.get("serve_min_new_tokens")),
                               req.max_new_tokens))
        floor_total = req.prompt.size + floor_new
        for L in self._buckets_below(bucket, floor_total):
            grp = self._groups.get(L)
            if grp is not None and grp.free_slot() is None:
                continue
            try:
                self._admit_budget(L)
            except _memsafe.MemoryBudgetError:
                continue
            new_max = L - req.prompt.size
            if not self._seat(req, L, max_new=new_max):
                continue
            self._note_shrunk(req, new_max, L)
            return True
        return False

    def _note_shrunk(self, req, new_max, bucket):
        was = req.max_new_tokens
        req.max_new_tokens = new_max
        req.degraded = f"shrink_max_new:{was}->{new_max}"
        self._note_degraded("shrink_max_new", req,
                            {"from": was, "to": new_max, "bucket": bucket})

    def _youngest_running(self, exclude=None):
        victim = None
        for g in self._groups.values():
            for i in g.active():
                r = g.slots[i]
                if r is exclude:
                    continue
                if victim is None or r.id > victim.id:
                    victim = r
        return victim

    def _evict_requeue(self, victim, for_req):
        """Degradation rung 2: evict the youngest running request and
        requeue it at the FRONT of the queue — its deterministic replay
        regenerates the same tokens, and `_streamed` keeps already-
        delivered ones from being re-sent."""
        self._remove_from_slots(victim)
        victim._reset_for_replay()
        self._queue.appendleft(victim)
        self._stats["requeues"] += 1
        self._note_degraded("evict_requeue", victim,
                            {"to_admit": for_req.id,
                             "streamed": victim._streamed})

    def _note_degraded(self, action, req, extra):
        self._stats["degraded"] += 1
        if _slo._enabled and req._slo_j is not None:
            _slo.note_event(req, action, **extra)
        print(f"mx.serve: degradation ladder: {action} (request "
              f"{req.id}: {extra})", file=sys.stderr)
        if _telemetry._enabled:
            _M_DEGRADED.inc()
            _telemetry.event("serve", action=action, req=req.id, **extra)
        if _diagnostics._enabled:
            _diagnostics.record_event("serve", action=action, req=req.id,
                                      **extra)

    def _place(self, req, bucket):
        t0 = time.perf_counter()
        grp = self._groups.get(bucket)
        if grp is None:
            grp = self._groups[bucket] = _Group(
                bucket, self.model._alloc_caches(self._slots, bucket))
        i = grp.free_slot()
        grp.slots[i] = req
        grp.pos[i] = 0
        self._note_admitted(req, bucket, t0)

    def _place_paged(self, req, bucket, got):
        """Seat an admitted request with the page table `_paged_alloc`
        built; a prefix-tree match starts it at the first unmatched
        position, skipping the matched prefix's prefill outright."""
        t0 = time.perf_counter()
        pages, matched, pos0 = got
        grp = self._groups.get(bucket)
        if grp is None:
            grp = self._groups[bucket] = _PagedGroup(
                bucket, self._slots, bucket // self._page_size)
        i = grp.free_slot()
        grp.slots[i] = req
        grp.pos[i] = pos0
        grp.pages[i] = pages
        grp.inserted[i] = False
        self._stats["prompt_tokens"] += req.prompt.size
        self._stats["prefix_tokens"] += pos0
        if matched:
            self._stats["prefix_hits"] += 1
        self._note_admitted(req, bucket, t0)

    def _note_admitted(self, req, bucket, t0):
        try:
            self._queue.remove(req)
        except ValueError:
            pass
        req.state = RUNNING
        req._admit_perf = time.perf_counter()
        if _slo._enabled and req._slo_j is not None:
            _slo.note_admit(req, bucket)
        if _telemetry._enabled:
            _M_QWAIT.observe(req.queue_wait_s)
        if _trace._enabled:
            _trace.record_span("serve.queue_wait", req._submit_perf,
                               req._admit_perf, cat="serve", req=req.id)
            _trace.record_span("serve.admit", t0, cat="serve", req=req.id,
                               bucket=bucket)

    def _vacate(self, grp, i):
        """Release slot i. Paged slots drop one pool reference per owned
        page: tree-shared pages survive with the tree's reference,
        exclusive ones return to the free list."""
        grp.slots[i] = None
        if isinstance(grp, _PagedGroup):
            for p in grp.pages[i]:
                self._pool.decref(p)
            grp.pages[i] = []
            grp.inserted[i] = False

    def _remove_from_slots(self, req):
        for g in self._groups.values():
            for i, r in enumerate(g.slots):
                if r is req:
                    self._vacate(g, i)
                    return True
        return False

    def _gc_groups(self):
        """Free the caches of drained bucket groups."""
        for L in [L for L, g in self._groups.items() if not g.active()]:
            del self._groups[L]

    # -- dispatch under the RetryPolicy ------------------------------------
    def _note_first_dispatch(self, grp, active):
        for i in active:
            r = grp.slots[i]
            if r._slo_j is not None:
                _slo.note_first_dispatch(r)

    def _retried(self, call, grp, what, lead=(), state=()):
        """Run one batched dispatch under the RetryPolicy.

        The port writes caches and pages IN PLACE (the JAX package
        donated them to the executable, so its retry first checked the
        donated buffers were intact). Rerunning in place is sound: the
        tokens, positions and tables of the retry are those of the
        failed attempt, so every cell the failed attempt wrote is written
        again with the same value before any read that the retry's
        output depends on (a step writes its position before it attends,
        and no step attends past its own position).

        Only the policy's transient classes are retried (OSError,
        ConnectionError, TimeoutError). A CUDA error is a RuntimeError,
        never one of them: it leaves the context unusable, so it
        propagates and the scheduler fails the live requests with 500."""
        def on_retry(exc, attempt, delay):
            with self._lock:
                self._stats["retries"] += 1
                if _slo._enabled:
                    for i in grp.active():
                        r = grp.slots[i]
                        if r is not None and r._slo_j is not None:
                            _slo.note_event(r, "retry", attempt=attempt,
                                            error=type(exc).__name__)
            print(f"mx.serve: retrying {what} dispatch after "
                  f"{type(exc).__name__}: {exc} (attempt {attempt + 2}/"
                  f"{self._retry.max_attempts}, backoff {delay:.2f}s, "
                  f"bucket {grp.bucket})", file=sys.stderr)

        if _check._enabled:
            key = (what, grp.bucket, tuple(tuple(x.shape) for x in lead))
            if key not in self._checked:
                call = self._checked_call(call, key, lead, state)
        if _enabled:
            note_dispatch(type(self.model).__name__)
        return self._retry.call(call, site="serve-dispatch",
                                abort=self._stop.is_set, on_retry=on_retry)

    def _checked_call(self, call, key, lead, state):
        """`call` for a dispatch at a new (what, bucket, shapes) key:
        recorded once under `check.StepRecord` and linted
        (`check.check_jit`, with the caches or page pool as the state
        that must be updated in place). Under check=error the key is not
        kept, so the next dispatch at it records and raises again."""
        model = self.model
        params = list(model.parameters())
        if self._drafter is not None:
            params += list(self._drafter.parameters())

        def checked():
            record = _check.StepRecord(
                known=list(lead) + list(state) + params
                + list(model.buffers()), state=state)
            out = record.run(call)
            # no signature history: buckets bound the shapes by
            # construction (the JAX package's decode keys are bucketed)
            _check.check_jit(
                f"serve.Server({type(model).__name__}).{key[0]}", None,
                record, params=params, can_donate=True)
            self._checked.add(key)
            return out
        return checked

    def _to_device(self, *arrays):
        dev = self.model.device
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # -- dense decode ----------------------------------------------------
    def _decode_group(self, grp):
        """One dense step: every active slot feeds one token (a prompt
        token while prefilling, then its own last sample)."""
        active = grp.active()
        tok = np.zeros((self._slots,), np.int32)
        t = np.zeros((self._slots,), np.int32)
        for i in active:
            r = grp.slots[i]
            p = grp.pos[i]
            lp = r.prompt.size
            tok[i] = r.prompt[p] if p < lp else r.tokens[p - lp]
            t[i] = p
        if _slo._enabled:
            self._note_first_dispatch(grp, active)
        tdec = time.perf_counter() if _trace._enabled else None
        lead = self._to_device(tok, t)
        run = self._runner(grp.bucket)
        logits = self._retried(lambda: run(*lead, grp.caches), grp,
                               "decode", lead, grp.caches)
        lg = logits.float().cpu().numpy()        # the host fetch syncs
        t_emit = self._trace_decode(grp, active, tdec)
        with self._lock:
            self._stats["steps"] += 1
            for i in active:
                r = grp.slots[i]
                if r is None or r.state in TERMINAL:
                    continue        # removed under the dispatch
                p = grp.pos[i]
                grp.pos[i] = p + 1
                if p < r.prompt.size - 1:
                    continue        # still prefilling the prompt
                nxt = self._sample(r, lg[i])
                self._emit(r, nxt)
                if (r.eos is not None and nxt == r.eos) \
                        or len(r.tokens) >= r.max_new_tokens:
                    grp.slots[i] = None
                    self._finish(r, DONE, "200 ok")
        if t_emit is not None:
            _trace.record_span("serve.stream", t_emit, cat="serve",
                               step=self._sched_step)

    def _trace_decode(self, grp, active, tdec, **extra):
        """The `serve.decode_step` span of one round (its dispatches
        through the host fetch of the logits, which syncs); returns the
        start of its `serve.stream` span, or None while trace is off.
        The request ids ride in the span."""
        if not _trace._enabled:
            return None
        _trace.record_span("serve.decode_step", tdec, cat="serve",
                           step=self._sched_step, bucket=grp.bucket,
                           slots=len(active),
                           reqs=[grp.slots[i].id for i in active
                                 if grp.slots[i] is not None], **extra)
        return time.perf_counter()

    # -- paged decode ----------------------------------------------------
    def _decode_group_paged(self, grp):
        """One scheduler round for a paged bucket. A SPECULATIVE round
        (draft chain + one k+1-token verify chunk) when a drafter is
        attached, every active slot is past its prompt, and at least one
        is greedy; otherwise a CHUNK round — chunked prefill for slots
        still inside their prompt, one token for the rest, all in one
        dispatch."""
        active = grp.active()
        all_decoding = True
        any_greedy = False
        max_need = 1
        for i in active:
            r = grp.slots[i]
            left = r.prompt.size - grp.pos[i]
            if left > 0:
                all_decoding = False
                max_need = max(max_need, min(self._prefill_chunk, left))
            if r.temperature == 0.0:
                any_greedy = True
        if _slo._enabled:
            self._note_first_dispatch(grp, active)
        if self._drafter is not None and all_decoding and any_greedy:
            self._spec_round(grp, active)
        else:
            self._chunk_round(grp, active, max_need)

    def _paged_inputs(self, grp, C):
        """Blank leading arrays for one chunk dispatch: empty slots run
        n=0 (every step masked into their scratch page) over table row
        zeros — valid page ids whose reads feed discarded logits."""
        B = self._slots
        toks = np.zeros((B, C), np.int32)
        t0 = np.zeros((B,), np.int32)
        n = np.zeros((B,), np.int32)
        tables = np.zeros((B, grp.n_pg), np.int32)
        return toks, t0, n, tables

    def _dispatch_paged(self, grp, fn, lead, tag, **kw):
        """One paged dispatch of `fn` (a model's `decode_paged_chunk` or
        `decode_paged_draft`) on the pool's `tag` stream, under the
        RetryPolicy. Returns its first output."""
        return self._retried(
            lambda: fn(*lead, self._pool.state[tag], self._page_size,
                       **kw)[0], grp, f"paged {tag}", lead,
            self._pool.state[tag])

    def _chunk_round(self, grp, active, max_need):
        C = self._prefill_chunk if max_need > 1 else 1
        toks, t0, n, tables = self._paged_inputs(grp, C)
        for i in active:
            r = grp.slots[i]
            lp = r.prompt.size
            p = grp.pos[i]
            if p < lp:
                ni = min(C, lp - p)
                toks[i, :ni] = r.prompt[p:p + ni]
            else:
                ni = 1
                toks[i, 0] = r.tokens[p - lp]
            t0[i] = p
            n[i] = ni
            tables[i, :len(grp.pages[i])] = grp.pages[i]
        tdec = time.perf_counter() if _trace._enabled else None
        lead = self._to_device(toks, t0, n, tables)
        logits = self._dispatch_paged(grp, self.model.decode_paged_chunk,
                                      lead, "target")
        if self._drafter is not None:
            # mirror the chunk on the drafter so its cache tracks the
            # target position for position (a later speculative round
            # starts its chain with no catch-up work)
            self._dispatch_paged(grp, self._drafter.decode_paged_chunk,
                                 lead, "draft")
        lg = logits.cpu().numpy()                # the host fetch syncs
        t_emit = self._trace_decode(grp, active, tdec, chunk=C)
        with self._lock:
            self._stats["steps"] += 1
            self._stats["chunk_dispatches"] += 1
            for i in active:
                r = grp.slots[i]
                if r is None or r.state in TERMINAL:
                    continue        # removed under the dispatch
                p = grp.pos[i]
                ni = int(n[i])
                grp.pos[i] = p + ni
                lp = r.prompt.size
                if p + ni >= lp and not grp.inserted[i]:
                    self._tree_insert(grp, i, r)
                if p + ni < lp:
                    continue        # still prefilling the prompt
                nxt = self._sample(r, lg[i])
                self._emit(r, nxt)
                if (r.eos is not None and nxt == r.eos) \
                        or len(r.tokens) >= r.max_new_tokens:
                    self._vacate(grp, i)
                    self._finish(r, DONE, "200 ok")
        if t_emit is not None:
            _trace.record_span("serve.stream", t_emit, cat="serve",
                               step=self._sched_step)

    def _spec_round(self, grp, active):
        """One speculative decoding round: the drafter chains k greedy
        proposals per greedy slot, the target verifies them all in ONE
        k+1-token chunk (every step's logits), and the host keeps the
        longest agreeing prefix plus the bonus token — exact greedy
        acceptance, so the emitted stream equals plain greedy decode.
        Non-greedy slots ride along with a single ordinary token.

        The chain runs k+1 steps, not k: step i writes the drafter's KV
        at position t0+i, and when the verify accepts all k drafts PLUS
        the bonus token the next round feeds at t0+k+1 — the extra step
        fills position t0+k so the drafter's cache never has a hole. Its
        proposal is discarded."""
        k = self._spec_k
        tok0 = np.zeros((self._slots,), np.int32)
        spec_row = np.zeros((self._slots,), bool)
        toks, t0, n, tables = self._paged_inputs(grp, k + 1)
        for i in active:
            r = grp.slots[i]
            p = grp.pos[i]
            tok0[i] = r.tokens[p - r.prompt.size]
            t0[i] = p
            tables[i, :len(grp.pages[i])] = grp.pages[i]
            spec_row[i] = r.temperature == 0.0
        t0_d, tables_d = self._to_device(t0, tables)
        tok0_d, act_d = self._to_device(tok0, spec_row)
        drafts = self._dispatch_paged(
            grp, self._drafter.decode_paged_draft,
            (tok0_d, t0_d, act_d, tables_d), "draft", n_draft=k + 1)
        drafts = drafts.cpu().numpy()[:, :k]                   # (B, k)
        for i in active:
            toks[i, 0] = tok0[i]
            if spec_row[i]:
                toks[i, 1:] = drafts[i]
                n[i] = k + 1
            else:
                n[i] = 1
        tdec = time.perf_counter() if _trace._enabled else None
        toks_d, n_d = self._to_device(toks, n)
        logits = self._dispatch_paged(
            grp, self.model.decode_paged_chunk, (toks_d, t0_d, n_d, tables_d),
            "target", full=True)
        lgs = logits.cpu().numpy()                             # (B, k+1, V)
        t_emit = self._trace_decode(grp, active, tdec, spec_k=k)
        with self._lock:
            self._stats["steps"] += 1
            self._stats["spec_rounds"] += 1
            for i in active:
                r = grp.slots[i]
                if r is None or r.state in TERMINAL:
                    continue
                p = grp.pos[i]
                if not spec_row[i]:
                    grp.pos[i] = p + 1
                    nxt = self._sample(r, lgs[i, 0])
                    self._emit(r, nxt)
                    if (r.eos is not None and nxt == r.eos) \
                            or len(r.tokens) >= r.max_new_tokens:
                        self._vacate(grp, i)
                        self._finish(r, DONE, "200 ok")
                    continue
                self._stats["drafts_proposed"] += k
                emitted = 0
                done = False
                for j in range(k + 1):
                    # the same argmax as _sample's greedy path — exact
                    # acceptance means verify-then-keep, never trust
                    nxt = int(lgs[i, j].argmax())
                    self._emit(r, nxt)
                    emitted += 1
                    if (r.eos is not None and nxt == r.eos) \
                            or len(r.tokens) >= r.max_new_tokens:
                        done = True
                        break
                    if j >= k or int(drafts[i, j]) != nxt:
                        break
                    self._stats["drafts_accepted"] += 1
                grp.pos[i] = p + emitted
                if done:
                    self._vacate(grp, i)
                    self._finish(r, DONE, "200 ok")
        if t_emit is not None:
            _trace.record_span("serve.stream", t_emit, cat="serve",
                               step=self._sched_step)

    def _tree_insert(self, grp, i, req):
        """One-time prefix-tree registration of a slot's fully prefilled
        prompt blocks (whole pages only — the partial tail stays
        exclusively owned, and decode writes land only past the prompt,
        so registered pages are immutable from here on)."""
        lp = req.prompt.size
        self._tree.insert(req.prompt, grp.pages[i][:lp // self._page_size])
        grp.inserted[i] = True

    def _sample(self, req, lg):
        """Next token from one slot's logits row (host-side, so each
        request's stream is deterministic and independent of what else
        shares the batch): greedy at temperature 0, else top-k softmax
        sampling from the request's own seeded rng."""
        if req.temperature > 0.0:
            if req._rng is None:
                req._rng = np.random.RandomState(req.seed)
            if req.top_k:
                kth = np.partition(lg, -req.top_k)[-req.top_k]
                lg = np.where(lg < kth, -np.inf, lg)
            lg = lg / req.temperature
            p = np.exp(lg - lg.max())
            p /= p.sum()
            return int(req._rng.choice(p.size, p=p))
        return int(lg.argmax())

    def _emit(self, req, tok):
        req.tokens.append(int(tok))
        self._stats["tokens"] += 1
        if _telemetry._enabled:
            _M_TOKENS.inc()
        if len(req.tokens) > req._streamed:
            req._streamed = len(req.tokens)
            if _slo._enabled and req._slo_j is not None:
                _slo.note_token(req)
            if req._first_token_perf is None:
                req._first_token_perf = time.perf_counter()
                if _telemetry._enabled:
                    _M_TTFT.observe(req.ttft_s)
            req._stream_q.put(int(tok))

    # -- terminal transitions -------------------------------------------
    _OUTCOME = {DONE: "completed", REJECTED: "rejected", SHED: "shed",
                EXPIRED: "expired", CANCELLED: "cancelled",
                FAILED: "failed"}

    def _finish(self, req, state, verdict):
        if req.state in TERMINAL:
            return
        req.state = state
        req.verdict = verdict
        req._finish_perf = time.perf_counter()
        # terminal requests leave the id table — a long-running server
        # must not grow with every request it ever answered (cancel by
        # id only ever targets live requests)
        self._by_id.pop(req.id, None)
        self._stats[self._OUTCOME[state]] += 1
        if state != DONE:
            print(f"mx.serve: request {req.id}: {verdict}", file=sys.stderr)
        if _telemetry._enabled:
            _M_REQUESTS.labels(outcome=self._OUTCOME[state]).inc()
            if state != DONE:
                _telemetry.event("serve", action="finish", req=req.id,
                                 state=state, verdict=verdict)
        if _slo._enabled and req._slo_j is not None:
            _slo.note_finish(req, self._OUTCOME[state], verdict)
        req._stream_q.put(_EOS_SENTINEL)
        req._done.set()


if _config.get("serve"):
    enable()
