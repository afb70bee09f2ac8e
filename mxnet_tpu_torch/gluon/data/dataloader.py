"""DataLoader (counterpart of `mxnet_tpu/gluon/data/dataloader.py`;
reference: `python/mxnet/gluon/data/dataloader.py`).

Both of the JAX package's execution models:

  * `num_workers>0, thread_pool=False` (the reference default): forked
    worker PROCESSES, the only way a GIL-bound Python transform chain
    scales past one core. Workers run the dataset and batchify on numpy
    and ship numpy back; the parent makes the device tensors. CUDA does
    not survive `fork`, as XLA does not: a forked child must never touch
    the card. In a worker, resolving the card raises (`context`), and a
    worker whose batch holds an NDArray or a tensor fails with the JAX
    package's message, not a hang. The `fork` context keeps closures in
    transforms free of pickling.
  * `thread_pool=True`: a thread pool prefetches batches (numpy releases
    the GIL for the heavy parts); each thread runs under the context the
    iterating thread had entered.

`default_batchify_fn` stacks device samples on the device (`torch.stack`;
the JAX package goes through the host: the same values and dtypes) and
host samples through numpy. `pin_memory=True` stages each host batch in
pinned memory and copies it to the card with `non_blocking=True`. A dead
worker is fatal, or with `resilience` enabled the pool is replaced, on
queues of its own, and its in-flight batches sent again, up to the
`RetryPolicy`'s attempts; a worker pool
that sends nothing for `dataloader_timeout` seconds raises. With
telemetry on, the wait for each batch lands in `dataloader_wait_seconds`
and the batches ready ahead of the consumer in the gauge
`dataloader_prefetch_depth` (stage="host"), as in the JAX package.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import context
from ... import telemetry as _telemetry
from ...ndarray import NDArray
from ...ndarray import ndarray as _nd
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "numpy_batchify_fn",
           "in_worker"]

_IN_WORKER = False

_M_WAIT = _telemetry.histogram(
    "dataloader_wait_seconds", "time the consumer waited for the next "
    "batch (the input stall a train step sees)")
# the host-side prefetch queue: worker/thread batches ready ahead of the
# consumer, labeled stage="host"
_M_DEPTH = _telemetry.gauge(
    "dataloader_prefetch_depth", "batches ready ahead of the consumer "
    "(0 = the consumer is starved: input-bound)").labels(stage="host")
_FORK_MSG = ("DataLoader worker produced an NDArray: with num_workers>0 "
             "the transform/batchify chain must stay host-side (numpy) — "
             "CUDA cannot run in a forked worker. Use numpy transforms "
             "(gluon.data.vision.transforms are numpy-backed) or "
             "thread_pool=True.")


def in_worker():
    """True inside a forked DataLoader worker process. Dataset __getitem__
    implementations use this to return host numpy instead of device
    arrays: CUDA must not run in a forked child."""
    return _IN_WORKER


def default_batchify_fn(data):
    """Stack samples into a batch (reference: default_batchify_fn):
    NDArray samples on their device, host samples through numpy
    (float64 becomes float32, int64 int32)."""
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    if isinstance(data[0], NDArray):
        t = torch.stack([d._t for d in data])
        return NDArray(t.to(_nd._DEFAULT.get(t.dtype, t.dtype)))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return _nd.array(arr)


def numpy_batchify_fn(data):
    """Worker-process batchify: stacks to NUMPY (device arrays cannot be
    created in a forked child)."""
    if isinstance(data[0], tuple):
        return tuple(numpy_batchify_fn(list(x)) for x in zip(*data))
    if isinstance(data[0], (NDArray, torch.Tensor)):
        raise TypeError(_FORK_MSG)
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


def _to_device_tree(batch, pin=False):
    """Host numpy leaves to NDArrays on the current device (pinned and
    copied without blocking when `pin` and the device is the card)."""
    if isinstance(batch, tuple):
        return tuple(_to_device_tree(b, pin) for b in batch)
    if isinstance(batch, NDArray):
        return batch
    dev = context.resolve(None)
    if pin and dev.type == "cuda":
        host = _nd.array(batch, ctx="cpu")._t.pin_memory()
        return NDArray(host.to(dev, non_blocking=True))
    return _nd.array(batch, ctx=dev)


def _assert_numpy_tree(batch):
    """Reject device arrays produced inside a forked worker: whatever the
    batchify_fn, what crosses the fork must be host numpy."""
    if isinstance(batch, tuple):
        for b in batch:
            _assert_numpy_tree(b)
        return
    if isinstance(batch, (NDArray, torch.Tensor)):
        raise TypeError(_FORK_MSG)


def _worker_loop(dataset, batchify_fn, key_q, data_q, seed):
    """Forked worker body: indices in, (idx, numpy batch | error) out."""
    global _IN_WORKER
    _IN_WORKER = True                   # datasets switch to numpy returns
    context.refuse_card(_FORK_MSG)      # the card does not survive fork
    # fork copies the parent RNG state into EVERY worker: reseed per worker
    # or all workers draw identical crop/flip augmentation streams
    np.random.seed(seed)
    while True:
        item = key_q.get()
        if item is None:
            return
        idx, indices = item
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            _assert_numpy_tree(batch)
            data_q.put((idx, batch, None))
        except Exception as e:          # noqa: BLE001 — relayed to parent
            data_q.put((idx, None, f"{type(e).__name__}: {e}"))


def _start(workers):
    # Python warns that fork from a multithreaded process can deadlock:
    # true IF the child touches what those threads hold (CUDA), which the
    # numpy-only worker contract forbids. The reference's fork + CUDA
    # DataLoader accepts the same caveat.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*fork.*",
                                category=RuntimeWarning)
        warnings.filterwarnings("ignore", message=".*fork.*",
                                category=DeprecationWarning)
        for w in workers:
            w.start()


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = num_workers
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(num_workers, 1))

    def __len__(self):
        return len(self._batch_sampler)

    def _load_batch(self, indices):
        samples = [self._dataset[i] for i in indices]
        if self._pin_memory and self._batchify_fn is default_batchify_fn \
                and not _holds_ndarray(samples[0]):
            return _to_device_tree(numpy_batchify_fn(samples), pin=True)
        return self._batchify_fn(samples)

    def __iter__(self):
        if not _telemetry._enabled:
            yield from self._iter_impl()
            return
        # batch-wait accounting: the gap between the consumer asking for a
        # batch and one being ready is the input stall the step sees
        it = self._iter_impl()
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            _M_WAIT.observe(time.perf_counter() - t0)
            yield batch

    def _iter_impl(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._load_batch(indices)
            return
        if not self._thread_pool:
            yield from self._iter_processes()
            return
        # threaded prefetch pipeline
        entered = context.entered()

        def load(indices):
            if entered is None:
                return self._load_batch(indices)
            with entered:
                return self._load_batch(indices)

        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = queue.Queue()
            stop = object()
            # depth = completed - consumed, from done callbacks (the queue
            # holds every future of the epoch, so its size is not the
            # prefetch depth); two monotonic counts, as result() can return
            # before the done callback runs
            counts_lock = threading.Lock()
            counts = [0, 0]     # [completed, consumed], tracked futures only

            def _mark_ready(_):
                with counts_lock:
                    counts[0] += 1

            def submitter():
                for indices in self._batch_sampler:
                    fut = pool.submit(load, indices)
                    if _telemetry._enabled:
                        fut._tele_tracked = True
                        fut.add_done_callback(_mark_ready)
                    futures.put(fut)
                futures.put(stop)

            t = threading.Thread(target=submitter, daemon=True)
            t.start()
            while True:
                fut = futures.get()
                if fut is stop:
                    break
                batch = fut.result()
                if _telemetry._enabled and getattr(fut, "_tele_tracked",
                                                   False):
                    with counts_lock:
                        counts[1] += 1
                        depth = max(0, counts[0] - counts[1])
                    _M_DEPTH.set(depth)
                yield batch
            t.join()

    def _spawn_pool(self, ctx, bfn, seeds):
        """A worker pool on queues of its own: (workers, key_q, data_q)."""
        key_q = ctx.Queue()
        data_q = ctx.Queue()
        workers = [ctx.Process(target=_worker_loop,
                               args=(self._dataset, bfn, key_q, data_q, s),
                               daemon=True) for s in seeds]
        _start(workers)
        return workers, key_q, data_q

    def _respawn_or_raise(self, pool, dead, respawns, ctx, bfn, inflight):
        """A worker died silently (segfault / OOM-kill) with work
        outstanding. With resilience enabled and retry budget left,
        retire the whole pool and its queues, start a fresh pool on fresh
        queues and send it every in-flight batch; otherwise raise the
        classic fatal error. Returns (pool, respawns).

        The queues go with the pool because a process that dies inside
        `data_q.put`'s feeder thread dies holding the queue's
        cross-process writer lock (or mid-message): a worker forked onto
        that queue would block on the lock forever and the parent would
        see no batch until `dataloader_timeout`."""
        from ... import resilience as _resilience
        policy = _resilience.RetryPolicy() if _resilience._enabled else None
        if policy is None or respawns + 1 >= policy.max_attempts:
            raise RuntimeError(
                f"DataLoader worker (pid {dead[0].pid}) died with exit "
                f"code {dead[0].exitcode} without reporting a result"
                + (f" ({respawns} respawn(s) already used)" if respawns
                   else "")) from None
        respawns += 1
        print(f"mx.resilience: DataLoader worker (pid {dead[0].pid}, exit "
              f"code {dead[0].exitcode}) died — respawning and re-queuing "
              f"{len(inflight)} in-flight batch(es) (respawn "
              f"{respawns}/{policy.max_attempts - 1})", file=sys.stderr)
        _retire_pool(pool)
        pool = self._spawn_pool(
            ctx, bfn, [int(np.random.randint(0, 2 ** 31 - 1))
                       for _ in pool[0]])
        for item in sorted(inflight.items()):
            pool[1].put(item)
        return pool, respawns

    def _iter_processes(self):
        """Forked-worker pipeline (reference: _MultiWorkerIter): tasks fan
        out to `num_workers` processes, results reorder by batch index so
        iteration order matches num_workers=0 exactly. A worker that dies
        without reporting (segfault/OOM-kill) is fatal by default; with
        resilience enabled the pool is replaced and its in-flight work
        sent again, up to the RetryPolicy attempt budget."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")    # fork: closures/lambdas in
        #                                 transforms need no pickling
        bfn = self._batchify_fn
        if bfn is default_batchify_fn:
            bfn = numpy_batchify_fn     # device arrays can't cross fork
        base_seed = int(np.random.randint(0, 2 ** 31 - 1))
        pool = self._spawn_pool(ctx, bfn, [(base_seed + i) % (2 ** 32)
                                           for i in range(self._num_workers)])
        try:
            batches = iter(enumerate(self._batch_sampler))
            inflight = {}      # idx -> indices: sent to a worker, no result
            buf = {}
            respawns = 0

            def _send():
                item = next(batches, None)
                if item is None:
                    return False
                inflight[item[0]] = item[1]
                pool[1].put(item)
                return True

            for _ in range(max(self._prefetch, 1)):
                if not _send():
                    break
            next_yield = 0
            while True:
                if next_yield in buf:
                    if _telemetry._enabled:
                        _M_DEPTH.set(len(buf))
                    yield _to_device_tree(buf.pop(next_yield),
                                          self._pin_memory)
                    next_yield += 1
                    continue
                if _telemetry._enabled:
                    _M_DEPTH.set(0)     # the consumer is starved
                if not inflight:        # nothing in flight, nothing buffered
                    break
                from ... import config as _config
                stall_limit = float(_config.get("dataloader_timeout"))
                waited = 0.0
                while True:             # bounded get: a worker that died OR
                    try:                # deadlocked must not hang us forever
                        idx, batch, err = pool[2].get(timeout=1)
                        break
                    except queue.Empty:
                        waited += 1
                        dead = [w for w in pool[0] if not w.is_alive()]
                        if dead:
                            pool, respawns = self._respawn_or_raise(
                                pool, dead, respawns, ctx, bfn, inflight)
                        if stall_limit > 0 and waited >= stall_limit:
                            raise RuntimeError(
                                f"DataLoader workers produced no batch for "
                                f"{waited:.0f}s — likely a CUDA call "
                                "deadlocked inside a forked worker (keep "
                                "transforms numpy-only, or use "
                                "thread_pool=True). Override with the "
                                "dataloader_timeout config option "
                                "(MXNET_TPU_DATALOADER_TIMEOUT)."
                            ) from None
                inflight.pop(idx)
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                buf[idx] = batch
                _send()
        finally:
            workers, key_q, _ = pool
            for _ in workers:
                key_q.put(None)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()


def _retire_pool(pool):
    """Stop a pool's live workers and let go of its queues without
    waiting on them (a dead worker may hold their locks)."""
    workers, key_q, data_q = pool
    for w in workers:
        if w.is_alive():
            w.terminate()
    for w in workers:
        w.join(timeout=1)               # reap
    for q in (key_q, data_q):
        q.cancel_join_thread()
        q.close()


def _holds_ndarray(sample):
    if isinstance(sample, tuple):
        return any(_holds_ndarray(s) for s in sample)
    return isinstance(sample, NDArray)
