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
  * **admit per step** — every scheduler step admits queued requests
    into free slots, runs one batched dispatch per active bucket, and
    streams the freshly sampled tokens. Sampling is host-side numpy
    with each request's own seeded RandomState, so a request's stream
    never depends on what shares its batch; `pages="on"` output equals
    `pages="off"` output.
  * **bounded queue** — at most `serve_queue_depth` requests wait;
    beyond that `serve_shed` rejects the newcomer or displaces the
    oldest waiter, each with a 503-style verdict.

Interim admission rule of this slice: a request whose pages the pool
cannot cover right now simply waits in the queue until running requests
drain (younger requests that fit may pass it); one that could never fit
the pool (or the model's max_length) is rejected at submit.

Not yet ported (listed in ROADMAP.md): memory-budget admission and its
degradation ladder, deadlines and cancellation, the transient-fault
RetryPolicy, fault injection, speculative decoding, and the telemetry,
trace, guard, slo, goodput and check hooks.
"""
from __future__ import annotations

import collections
import queue as _pyqueue
import sys
import threading
import time

import numpy as np
import torch

from . import config as _config
from . import dataflow as _dataflow
from . import pages as _pages

__all__ = ["Server", "Request", "QUEUED", "RUNNING", "DONE", "REJECTED",
           "SHED", "CANCELLED", "FAILED", "TERMINAL"]

# request lifecycle states
QUEUED = "queued"        # accepted, waiting for a slot
RUNNING = "running"      # owns a batch slot, decoding
DONE = "done"            # all tokens generated (or eos)
REJECTED = "rejected"    # can never be served (413/429-style)
SHED = "shed"            # load shedding dropped it (503-style)
CANCELLED = "cancelled"  # the server stopped under it (499-style)
FAILED = "failed"        # scheduler error surfaced to the request (500)
TERMINAL = frozenset({DONE, REJECTED, SHED, CANCELLED, FAILED})

_EOS_SENTINEL = object()


class Request:
    """One generation request moving through the serving lifecycle.

    `id` (admission-order sequence number), `state` / `verdict`
    ('200 ok', '413 ...', '429 ...', '503 ...', '499 ...', '500 ...'),
    `tokens` (generated so far) and the timings `queue_wait_s` /
    `ttft_s`. Consume with `stream()` or `result(timeout)`; both need the
    scheduler driven (`Server.start()` or `step()`/`drain()`)."""

    def __init__(self, seq, prompt, max_new_tokens, eos, temperature,
                 top_k, seed):
        self.id = seq
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos = eos
        self.temperature = float(temperature or 0.0)
        self.top_k = int(top_k or 0)
        self.seed = int(seed)
        self.state = QUEUED
        self.verdict = None
        self.tokens = []
        self._rng = None
        self._stream_q = _pyqueue.Queue()
        self._done = threading.Event()
        self._submit_perf = time.perf_counter()
        self._admit_perf = None
        self._first_token_perf = None

    def result(self, timeout=None):
        """Block until terminal; returns the generated tokens (int32)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id} still {self.state} after {timeout}s — "
                "is the server running? (Server.start() or drain())")
        return np.asarray(self.tokens, np.int32)

    def stream(self):
        """Iterate tokens as the scheduler generates them."""
        while True:
            tok = self._stream_q.get()
            if tok is _EOS_SENTINEL:
                return
            yield tok

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

    def __repr__(self):
        return (f"Request(id={self.id}, state={self.state!r}, "
                f"tokens={len(self.tokens)}/{self.max_new_tokens}"
                + (f", verdict={self.verdict!r}" if self.verdict else "")
                + ")")


class _Group:
    """Decode state of one dense length bucket: `slots` requests sharing
    (slots, H, bucket, D) caches; `pos[i]` is the next position slot i
    writes (prompt tokens first, then its own sampled tokens)."""

    __slots__ = ("bucket", "slots", "pos", "caches")

    def __init__(self, bucket, caches):
        self.bucket = bucket
        self.caches = caches
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
    `inserted[i]` latches the one-time prefix-tree insertion."""

    __slots__ = ("bucket", "n_pg", "slots", "pos", "pages", "inserted")

    def __init__(self, bucket, n_slots, n_pg):
        self.bucket = bucket
        self.n_pg = n_pg
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

    `submit()` never raises for overload: shedding and rejection are
    verdicts on the returned Request. Drive it with `start()`/`stop()`
    (a background thread), a `with` block, or synchronously with
    `step()` / `drain()`. Knobs default to the `serve_*` / `pages_*`
    config values."""

    def __init__(self, model, slots=None, queue_depth=None, shed=None,
                 buckets=None, max_len=None, pages=None, page_size=None,
                 pool_pages=None, prefill_chunk=None):
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
        self._slots = int(slots or _config.get("serve_slots"))
        self._queue_depth = int(queue_depth if queue_depth is not None
                                else _config.get("serve_queue_depth"))
        shed = shed or _config.get("serve_shed")
        if shed not in ("reject", "oldest"):
            raise ValueError(
                f"serve_shed must be 'reject' or 'oldest', got {shed!r}")
        self._shed = shed
        self._buckets = self._parse_buckets(buckets)
        self._lock = threading.RLock()
        self._queue = collections.deque()
        self._groups = {}          # bucket -> _Group / _PagedGroup
        self._by_id = {}
        self._seq = 0
        self._sched_step = 0
        self._stats = {"submitted": 0, "completed": 0, "rejected": 0,
                       "shed": 0, "cancelled": 0, "failed": 0, "tokens": 0,
                       "steps": 0}
        self._pool = None
        self._tree = None
        if self._paged:
            self._init_paged(page_size, pool_pages, prefill_chunk)
        self._thread = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._error = None
        self._stopped = False

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

    def _init_paged(self, page_size, pool_pages, prefill_chunk):
        """Build the page pool and prefix tree. The usable position range
        rounds DOWN to a page multiple and buckets round UP to one
        (`_bucket_for`), so a paged bucket's gathered KV length
        n_pg*page_size equals the bucket exactly: the same operand shapes
        as the dense cache. The default pool holds slots *
        max_len/page_size data pages (the dense worst case), plus one
        scratch page per slot."""
        ps = int(page_size or _config.get("pages_page_size"))
        if ps < 1:
            raise ValueError(f"pages_page_size must be >= 1, got {ps}")
        self._page_size = ps
        self._prefill_chunk = max(
            1, int(prefill_chunk or _config.get("pages_prefill_chunk")))
        max_paged = (self._max_len // ps) * ps
        if max_paged < 1:
            raise ValueError(
                f"pages_page_size {ps} exceeds the model's max_length "
                f"{self._max_len} — no position fits a single page")
        self._max_len = max_paged
        D = self._units // self._heads
        streams = {"target": [(self._heads, D, self._cache_dtype)]
                   * (2 * self._n_l)}
        data = int(pool_pages or _config.get("pages_pool_pages")) \
            or self._slots * (self._max_len // ps)
        self._pool = _pages.PagePool(ps, data, self._slots, streams,
                                     device=self.model.device)
        self._tree = _pages.PrefixTree(self._pool)
        self._stats.update({"prompt_tokens": 0, "prefix_tokens": 0,
                            "prefix_hits": 0, "chunk_dispatches": 0})

    # -- client surface --------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos=None, temperature=0.0,
               top_k=0, seed=0):
        """Enqueue one generation request; returns a Request immediately
        (already terminal when shed, or rejected as unservable)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0 or int(max_new_tokens) <= 0:
            raise ValueError("submit needs a non-empty prompt and "
                             "max_new_tokens >= 1")
        with self._lock:
            req = Request(self._seq, prompt, max_new_tokens, eos,
                          temperature, top_k, seed)
            self._seq += 1
            self._by_id[req.id] = req
            self._stats["submitted"] += 1
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
            if self._paged:
                n_pg = -(-need // self._page_size)
                if n_pg > self._pool.data_pages:
                    self._finish(req, REJECTED,
                                 f"429 over capacity: request needs {n_pg} "
                                 f"pages, the pool holds "
                                 f"{self._pool.data_pages}")
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
        self._wake.set()
        return req

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
                self._wake.wait(0.005)
                self._wake.clear()

    def _scheduler_failed(self, exc):
        """An error escaped a scheduler step: fail every live request
        with a 500 verdict so no client wedges on a dead scheduler, and
        keep the error for `raise_if_failed`."""
        self._error = exc
        print(f"mx.serve: scheduler error: {type(exc).__name__}: {exc}",
              file=sys.stderr)
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
        """True while any request is queued or holds a slot."""
        with self._lock:
            if self._queue:
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
        """One scheduler iteration: admit from the queue, run one batched
        dispatch per active bucket, stream the new tokens (with no
        autograd graph, also for a model trained eagerly). Returns True
        while work remains."""
        with self._lock:
            self._sched_step += 1
            self._gc_groups()
            self._admit()
            groups = [g for g in self._groups.values() if g.active()]
        for grp in groups:
            if self._paged:
                self._decode_group_paged(grp)
            else:
                self._decode_group(grp)
        with self._lock:
            self._gc_groups()
        return self.busy()

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

    def _admit(self):
        """Admit queued requests into free slots, oldest first (younger
        requests may pass one whose bucket is full or whose pages the
        pool cannot cover yet)."""
        for req in list(self._queue):
            if req.state == QUEUED:
                self._try_admit(req)

    def _try_admit(self, req):
        bucket = self._bucket_for(req.prompt.size + req.max_new_tokens)
        grp = self._groups.get(bucket)
        if grp is not None and grp.free_slot() is None:
            return False                     # bucket full: wait
        if self._paged:
            got = self._paged_alloc(req, bucket)
            if got is None:
                return False                 # pool short: wait (interim)
            self._place_paged(req, bucket, got)
            return True
        self._place(req, bucket)
        return True

    def _paged_alloc(self, req, bucket):
        """Match the prompt against the prefix tree and allocate the
        request's EXACT page need: ceil((prompt + max_new) / page_size)
        pages, not the bucket's whole table (unowned table rows pad to
        scratch page 0, whose reads are masked).

        A whole-prompt match would make the first decode write land
        inside the shared last page (the re-fed prompt tail that
        produces the sampling logits), so that page is copied
        (copy-on-write) before the shared reference is dropped.

        Returns (pages, matched_tokens, start_pos) with one pool
        reference held per page, or None when the pool cannot cover the
        need even after evicting unreferenced prefix-tree leaves."""
        ps = self._page_size
        lp = req.prompt.size
        n_pg = min(-(-(lp + req.max_new_tokens) // ps), bucket // ps)
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

    def _place(self, req, bucket):
        grp = self._groups.get(bucket)
        if grp is None:
            grp = self._groups[bucket] = _Group(
                bucket, self.model._alloc_caches(self._slots, bucket))
        i = grp.free_slot()
        grp.slots[i] = req
        grp.pos[i] = 0
        self._note_admitted(req)

    def _place_paged(self, req, bucket, got):
        """Seat an admitted request with the page table `_paged_alloc`
        built; a prefix-tree match starts it at the first unmatched
        position, skipping the matched prefix's prefill outright."""
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
        self._note_admitted(req)

    def _note_admitted(self, req):
        self._queue.remove(req)
        req.state = RUNNING
        req._admit_perf = time.perf_counter()

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

    # -- decode ----------------------------------------------------------
    def _to_device(self, *arrays):
        dev = self.model.device
        return [torch.from_numpy(a).to(dev) for a in arrays]

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
        n_l = self._n_l
        logits, _, _ = self.model.decode_step_slots(
            *self._to_device(tok, t), grp.caches[:n_l], grp.caches[n_l:])
        lg = logits.float().cpu().numpy()        # the host fetch syncs
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
                    self._vacate(grp, i)
                    self._finish(r, DONE, "200 ok")

    def _decode_group_paged(self, grp):
        """One chunk round for a paged bucket (the JAX package's
        `_chunk_round`; its speculative rounds are not ported): chunked
        prefill for slots still inside their prompt, one token for the
        rest, in one `decode_paged_chunk` dispatch of C = prefill_chunk
        (or 1 when every slot is decoding)."""
        active = grp.active()
        prefilling = any(grp.slots[i].prompt.size - grp.pos[i] > 1
                         for i in active)
        C = self._prefill_chunk if prefilling else 1
        B = self._slots
        toks = np.zeros((B, C), np.int32)
        t0 = np.zeros((B,), np.int32)
        n = np.zeros((B,), np.int32)
        # empty slots run n=0 (every step masked into their scratch page)
        # over table row zeros: valid page ids whose reads are discarded
        tables = np.zeros((B, grp.n_pg), np.int32)
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
        logits, _ = self.model.decode_paged_chunk(
            *self._to_device(toks, t0, n, tables),
            self._pool.state["target"], self._page_size)
        lg = logits.cpu().numpy()                # the host fetch syncs
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
        if req._first_token_perf is None:
            req._first_token_perf = time.perf_counter()
        req._stream_q.put(int(tok))

    # -- terminal transitions -------------------------------------------
    _OUTCOME = {DONE: "completed", REJECTED: "rejected", SHED: "shed",
                CANCELLED: "cancelled", FAILED: "failed"}

    def _finish(self, req, state, verdict):
        if req.state in TERMINAL:
            return
        req.state = state
        req.verdict = verdict
        self._by_id.pop(req.id, None)
        self._stats[self._OUTCOME[state]] += 1
        if state != DONE:
            print(f"mx.serve: request {req.id}: {verdict}", file=sys.stderr)
        req._stream_q.put(_EOS_SENTINEL)
        req._done.set()
