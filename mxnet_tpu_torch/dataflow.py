"""The input-to-device layer (counterpart of `mxnet_tpu/dataflow.py`).

MXNet hid host-side input work behind device compute with an async
`PrefetcherIter`: a background thread prepares the next batches while
the current one trains. Here a worker thread also copies them to the
device, so the host-to-device copy overlaps the step instead of
sitting between two steps:

  * `prefetch_to_mesh(it, trainer, depth=2)`: a worker thread turns
    host batches (numpy / NDArray / tensor trees) into NDArrays on the
    trainer's device for the next `depth` steps; the worker's exception
    re-raises at `next()` with its own traceback; the thread shuts down
    on close(), on garbage collection and after a partial iteration.
  * `BucketPad(axis_buckets=...)`: pads varlen batches up to configured
    or power-of-two buckets (pairing each pad with a valid-length input),
    so a stream of novel lengths runs a handful of step signatures.
  * `autofit(trainer, make_batch, ...)`: the largest batch (and the
    BucketPad buckets) whose step peak fits the device.

On the card, each prefetcher's worker makes a CUDA stream of its own
current for its whole life (`torch.cuda.set_stream` is per thread).
Host leaves go into pinned memory (torch's caching host allocator, which
keeps a pinned block from reuse until the copy that reads it has run)
and then to the card with `non_blocking=True` on that stream; so does
the copy the port's DataLoader makes when the worker iterates it. After
each batch the worker records an event; `next()` makes the consumer's
current stream wait on it and calls `record_stream` on every leaf for
the consumer's stream, so a step never reads a half-copied batch and
the caching allocator never hands a freed batch's block back to the
side stream while a step still reads it. Leaves already on the target
device pass through, as the JAX stager skips an array whose sharding
matches. A CUDA target without a card raises at construction; a failed
stage re-raises at `next()`; nothing falls back to the unstaged batch
or to the CPU.

Intended differences from the JAX package:
  * a "sharding" is a `torch.device`: the trainer's `_batch_shardings`
    gives its device for every leaf (one card, so `_data_axis_extent`
    is 1);
  * `autofit` searches over `ShardedTrainer.predict_step_bytes`, which
    measures the peak of one forward and backward at the probed shapes
    (XLA's ahead-of-time memory analysis has no eager counterpart), so
    every probe runs a real pass; the batch sizes it chooses can differ
    from XLA's;
  * `ensure_compile_cache` is not here: PyTorch compiles nothing, and
    the `compile_cache_dir` knob is the JAX package's own.

Telemetry (each series one module-bool check while off):
`dataloader_prefetch_depth{stage="device"}` (staged batches ahead of the
consumer, distinct from the host DataLoader's `stage="host"`),
`device_prefetch_wait_seconds` (the consumer blocked on staging),
`h2d_bytes_total` (bytes the stager moved to the device) and
`bucket_pad_waste_ratio`; trace spans `input.batch_wait` (consumer) and
`input.h2d_stage` (worker); goodput's `input_stall`. With resilience on
the `stall_input` fault fires at the stager's input point, and a
transient staging failure retries under one `RetryPolicy` a prefetcher.
"""
from __future__ import annotations

import math
import queue
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch
from torch.utils import _pytree

from . import _locklint
from . import config as _config
from . import context
from . import goodput as _goodput
from . import guard as _guard
from . import resilience as _resilience
from . import telemetry as _telemetry
from . import trace as _trace

__all__ = ["prefetch_to_mesh", "MeshPrefetcher", "BucketPad",
           "bucket_length", "autofit", "AutofitResult"]

_M_DEPTH = _telemetry.gauge(
    "dataloader_prefetch_depth", "batches buffered ahead of the consumer "
    "(0 while the consumer is starved = input-bound); fanned out by stage: "
    "host (DataLoader worker batches) vs device (device-staged arrays)")
_M_STAGE_WAIT = _telemetry.histogram(
    "device_prefetch_wait_seconds", "time the training loop spent blocked "
    "waiting for a device-staged batch: the staging share of the input "
    "stall (compare dataloader_wait_seconds for the host-batch share)")
_M_H2D_BYTES = _telemetry.counter(
    "h2d_bytes_total", "payload bytes staged host-to-device by "
    "prefetch_to_mesh")
_M_PAD_WASTE = _telemetry.histogram(
    "bucket_pad_waste_ratio", "fraction of each BucketPad-padded batch "
    "that is padding (0 = exact bucket fit): the overhead bought to bound "
    "the number of step signatures",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0))


def _is_leaf(x):
    from .ndarray import NDArray
    return isinstance(x, (NDArray, np.ndarray, torch.Tensor))


def _flatten(item):
    """(leaves, spec) of a batch tree (tuples, lists, dicts, namedtuples
    of NDArrays, tensors and numpy arrays)."""
    return _pytree.tree_flatten(item, is_leaf=_is_leaf)


def _raw(leaf):
    """An NDArray's tensor; anything else as it is."""
    from .ndarray import NDArray
    return leaf._t if isinstance(leaf, NDArray) else leaf


# ---------------------------------------------------------------------------
# prefetch_to_mesh
# ---------------------------------------------------------------------------

class _WorkerExit(Exception):
    """Internal: the prefetcher was closed under the worker."""


_STOP = object()


class MeshPrefetcher:
    """Background-staged iterator: host batches in, device batches out,
    `depth` steps ahead of the consumer.

    `shardings` may be a ShardedTrainer (its `_batch_shardings` decide
    placement; batches are then `(data, labels)` pairs), an explicit
    list of devices, one per leaf, or None (the current device of the
    calling thread: the eager gluon/Estimator path). `transform` (e.g. a
    BucketPad) runs inside the worker thread, so host-side padding
    overlaps device compute too. The source's iterator is taken here, on
    the caller's thread, as in the JAX package, and the worker runs under
    the context the caller had entered."""

    def __init__(self, iterator, shardings=None, depth=2, transform=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._exhausted = False
        # close() is idempotent and may be called concurrently, from a
        # SIGTERM/preemption path re-entering while the first close is
        # mid-join too, so its bookkeeping sits behind an RLock
        self._close_lock = _locklint.make_rlock("dataflow.prefetcher.close")
        self._close_done = False
        # the worker closes over locals (not self) so a consumer dropping
        # its last reference lets __del__ run while the thread is alive
        closed, q = self._closed, self._q
        stage = _Stager(shardings)
        self._stream_device = stage.cuda_device
        entered = context.entered()
        source = iter(iterator)
        policy_cell = [None]   # RetryPolicy built once, on first enabled use

        def _run():
            for item in source:
                if closed.is_set():
                    return
                if transform is not None:
                    item = transform(item)
                staged = _stage_resilient(stage, item, closed, policy_cell)
                _q_put(q, staged, closed)
            _q_put(q, _STOP, closed)

        def _worker():
            try:
                with (entered if entered is not None else nullcontext()), \
                        _side_stream(stage.cuda_device):
                    _run()
            except _WorkerExit:
                return
            except BaseException as e:   # noqa: BLE001 - relayed to consumer
                try:
                    _q_put(q, e, closed)
                except _WorkerExit:
                    return

        self._thread = threading.Thread(
            target=_worker, name="mx-dataflow-prefetch", daemon=True)
        self._thread.start()

    # -- consumer side --------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted or self._closed.is_set():
            raise StopIteration
        if _telemetry._enabled or _trace._enabled or _goodput._enabled:
            t0 = time.perf_counter()
            item = self._q.get()
            if item is not _STOP and not isinstance(item, BaseException):
                # waits that produced a batch are the staging stall;
                # waiting for the end-of-stream marker is not a stall
                t1 = time.perf_counter()
                if _telemetry._enabled:
                    _M_STAGE_WAIT.observe(t1 - t0)
                    _M_DEPTH.labels(stage="device").set(self._q.qsize())
                if _trace._enabled:
                    _trace.record_span("input.batch_wait", t0, t1,
                                       cat="input")
                if _goodput._enabled:
                    _goodput.note("input_stall", t0, t1)
        else:
            item = self._q.get()
        if item is _STOP:
            self._exhausted = True
            self._thread.join()
            raise StopIteration
        if isinstance(item, BaseException):
            self._exhausted = True
            self._thread.join()
            # the worker's exception object: its __traceback__ still
            # points at the failing frame inside the worker
            raise item
        batch, event, tensors = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._stream_device)
            consumer.wait_event(event)
            for t in tensors:
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the worker and release the staged batches. Idempotent and
        thread-safe: callable again from a SIGTERM/preemption path while
        the worker is mid-copy (the copy completes, its result is
        drained, the worker exits at its next bounded put). Called by
        __del__ and __exit__, safe mid-iteration. A worker blocked INSIDE
        the source iterator's next() cannot be interrupted; it is left as
        a daemon and exits at the source's next yield, and the join
        timeout bounds how long close() waits for that."""
        with self._close_lock:
            if self._close_done:
                return
            self._closed.set()
            self._drain()        # a worker blocked on put() sees the close
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=5)
            # a put in flight during the first drain can land in the
            # emptied queue: drain again after the join
            self._drain()
            # only a confirmed-dead worker makes close() a no-op next
            # time: a timed-out join leaves it retryable
            if not self._thread.is_alive():
                self._close_done = True

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _side_stream(device):
    """The worker's own CUDA stream, current on its thread for its whole
    life (a no-op context for a CPU target)."""
    if device is None:
        return nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device=device))


def _stage_resilient(stage, item, closed, policy_cell):
    """One batch through the stager. With resilience enabled the
    `stall_input` fault point fires here, and transient staging failures
    (OSError/ConnectionError/TimeoutError) retry under one RetryPolicy a
    prefetcher, aborting early if the prefetcher closes underneath.
    Disabled: one bool check, then the plain call."""
    if _guard._enabled:
        # liveness from the input worker: a trainer blocked on a slow
        # input queue still shows a fresh beat (phase=input)
        _guard.heartbeat(phase="input")
    if not _resilience._enabled:
        return stage(item)
    _resilience.fault_point("input")
    if policy_cell[0] is None:
        policy_cell[0] = _resilience.RetryPolicy()
    return policy_cell[0].call(
        stage, item, site="prefetch-stage", abort=closed.is_set)


def _q_put(q, item, closed):
    """Bounded put that aborts when the prefetcher closes underneath the
    worker (the consumer stopped iterating)."""
    while not closed.is_set():
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            continue
    raise _WorkerExit


def _host_tensor(x, copy):
    """A host array as a CPU tensor in the port's dtypes (float64 becomes
    float32 and int64 int32, as `nd.array` and the JAX package's
    device_put give them); a copy of the array's memory when `copy`."""
    from .ndarray.ndarray import _DEFAULT
    a = np.array(x) if copy else np.ascontiguousarray(x)
    t = torch.from_numpy(a)
    return t.to(_DEFAULT.get(t.dtype, t.dtype))


class _Stager:
    """Per-batch host-to-device staging: flatten the batch tree, move
    every leaf to its target device, rebuild the tree as NDArrays.
    Returns (batch, event, the device tensors) where `event` (None on
    the CPU) marks the end of the batch's copies on the worker's
    stream."""

    def __init__(self, shardings):
        self._shardings = shardings
        if shardings is None:
            self._default = context.resolve(None)
            devices = [self._default]
        elif isinstance(shardings, (list, tuple)):
            devices = [torch.device(d) for d in shardings]
        elif hasattr(shardings, "_batch_shardings"):
            devices = [torch.device(shardings.device)]
        else:
            raise TypeError(
                "shardings must be None, a list of devices, or a trainer "
                f"with _batch_shardings; got {type(shardings).__name__}")
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda and not torch.cuda.is_available():
            raise RuntimeError(
                f"prefetch_to_mesh: target {cuda[0]} requested but CUDA is "
                "unavailable")
        self.cuda_device = None if not cuda else context.resolve(cuda[0])

    def __call__(self, item):
        from .ndarray import NDArray
        t_trace = time.perf_counter() if _trace._enabled else None
        leaves, spec = _flatten(item)
        raw = [_raw(x) for x in leaves]
        targets = self._targets(item, raw)
        moved = 0
        staged = []
        for r, dev in zip(raw, targets):
            if isinstance(r, torch.Tensor):
                if r.device == dev:
                    staged.append(r)
                    continue
                moved += r.numel() * r.element_size()
                t = r.detach()
            else:
                # on the CPU the staged batch owns its memory, as a copy
                # to the card does
                t = _host_tensor(r, copy=dev.type == "cpu")
                moved += t.numel() * t.element_size()
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(dev, non_blocking=True)
            else:
                t = t.to(dev)
            staged.append(t)
        if _telemetry._enabled and moved:
            _M_H2D_BYTES.inc(moved)
        out = _pytree.tree_unflatten([NDArray(s) for s in staged], spec)
        event = None
        tensors = ()
        if self.cuda_device is not None:
            event = torch.cuda.Event()
            event.record()              # on the worker's current stream
            tensors = [s for s in staged if s.device.type == "cuda"]
        if t_trace is not None:
            # producer-side staging, in the worker thread: a long span
            # here that never surfaces as batch_wait means the overlap
            # worked
            _trace.record_span("input.h2d_stage", t_trace, cat="input")
        return out, event, tensors

    def _targets(self, item, raw):
        sh = self._shardings
        if sh is None:
            return [self._default] * len(raw)
        if isinstance(sh, (list, tuple)):
            if len(sh) != len(raw):
                raise ValueError(
                    f"got {len(sh)} devices for a batch of {len(raw)} "
                    "arrays")
            return [torch.device(d) for d in sh]
        # a trainer: batches are (data, labels) pairs; count leaves on
        # each side
        if isinstance(item, (tuple, list)) and len(item) == 2:
            n_data = len(_flatten(item[0])[0])
        else:
            n_data = len(raw)
        shapes = tuple(tuple(getattr(r, "shape", ())) for r in raw)
        return [torch.device(d) for d in
                sh._batch_shardings(n_data, len(raw) - n_data, shapes)]


def prefetch_to_mesh(iterator, trainer_or_shardings=None, depth=None,
                     transform=None):
    """Stage batches onto the device `depth` steps ahead of the consumer.

    Wrap any host batch iterator (a gluon DataLoader, a generator of
    `(data, labels)` pairs) and iterate the result instead: a background
    thread moves each batch to the device while the current step runs.
    Pass the ShardedTrainer to use its device, an explicit list of
    devices, or None for the current device (the eager gluon path).
    `transform` (e.g. `BucketPad`) runs in the worker thread. Close via
    `close()`, a `with` block, or by dropping the iterator; the worker's
    exceptions re-raise at `next()` with their own traceback."""
    if depth is None:
        depth = _config.get("device_prefetch_depth") or 2
    return MeshPrefetcher(iterator, trainer_or_shardings, depth=depth,
                          transform=transform)


# ---------------------------------------------------------------------------
# shape bucketing
# ---------------------------------------------------------------------------

def bucket_length(length, buckets="pow2", floor=None):
    """The bucket a raw length rounds up to: the one bucketing policy
    shared by `BucketPad` (varlen batch axes) and the server (KV-cache
    lengths). `buckets` is a sorted sequence of sizes or "pow2" (next
    power of two, floored at `floor`, default the `bucket_pad_min`
    knob). Lengths above the largest configured bucket keep their raw
    size."""
    length = int(length)
    if buckets == "pow2":
        if floor is None:
            floor = max(1, int(_config.get("bucket_pad_min")))
        return max(int(floor),
                   1 << max(0, math.ceil(math.log2(max(length, 1)))))
    for b in buckets:
        if b >= length:
            return int(b)
    return length


def _host(leaf):
    """A leaf as a host numpy array (an NDArray's or a tensor's values)."""
    leaf = _raw(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


class BucketPad:
    """Pad varlen batches up to configured (or power-of-two) buckets so a
    stream of novel raw lengths runs a bounded set of step signatures.

    axis_buckets: {axis: buckets} where buckets is a sorted sequence of
    sizes or the string "pow2" (next power of two, floored at the
    `bucket_pad_min` knob). Default: {1: "pow2"}, the sequence axis.
    Lengths above the largest configured bucket keep their raw size.

    Each padded DATA array is paired with a valid-length input (int32,
    shape (batch,), the raw length) appended to the data list, so masked
    models/losses can ignore the pad; pass append_valid_length=False for
    workloads (e.g. BERT) whose batch already carries one. Labels are
    padded along the same axes with `label_pad_value` but never grow a
    valid-length input. Padded leaves come back as host numpy arrays
    (as in the JAX package); a leaf that needs no pad comes back as it
    was given.

    Use per batch (`bp((data, labels))`), over an iterator (`bp.wrap(it)`),
    or as `prefetch_to_mesh(..., transform=bp)`: there the padding runs
    in the prefetch worker thread and overlaps device compute."""

    def __init__(self, axis_buckets=None, pad_value=0, label_pad_value=0,
                 append_valid_length=True):
        self.axis_buckets = dict(axis_buckets) if axis_buckets else {1: "pow2"}
        for axis, buckets in self.axis_buckets.items():
            if buckets != "pow2":
                bl = sorted(int(b) for b in buckets)
                if not bl:
                    raise ValueError(f"axis {axis}: empty bucket list")
                self.axis_buckets[axis] = bl
        self.pad_value = pad_value
        self.label_pad_value = label_pad_value
        self.append_valid_length = append_valid_length

    def _bucket(self, length, buckets):
        return bucket_length(length, buckets)

    def _pad_leaf(self, leaf, pad_value, collect_valid):
        arr = _raw(leaf)
        shape = tuple(arr.shape)
        padded = arr
        raw_elems = int(np.prod(shape)) if shape else 1
        valid = None
        pads = [(0, 0)] * len(shape)
        grew = False
        for axis, buckets in self.axis_buckets.items():
            if axis >= len(shape):
                continue
            length = shape[axis]
            target = self._bucket(length, buckets)
            if target > length:
                pads[axis] = (0, target - length)
                grew = True
            if collect_valid and valid is None:
                valid = np.full(shape[0] if shape else 1, length,
                                dtype=np.int32)
        if grew:
            padded = np.pad(_host(leaf), pads, constant_values=pad_value)
            if _telemetry._enabled:
                _M_PAD_WASTE.observe(
                    1.0 - raw_elems / max(int(np.prod(padded.shape)), 1))
        elif _telemetry._enabled and any(
                ax < len(shape) for ax in self.axis_buckets):
            _M_PAD_WASTE.observe(0.0)
        return padded, (valid if grew or collect_valid else None)

    def _pad_side(self, side, pad_value, collect_valid):
        single = not isinstance(side, (list, tuple))
        items = [side] if single else list(side)
        out, valids = [], []
        for leaf in items:
            padded, valid = self._pad_leaf(leaf, pad_value, collect_valid)
            out.append(padded)
            if valid is not None:
                valids.append(valid)
        if collect_valid:
            out.extend(valids)
            return out
        return out[0] if single else out

    def __call__(self, batch):
        """One batch: a `(data, labels)` pair, or a bare data array/list."""
        if isinstance(batch, tuple) and len(batch) == 2 and any(
                isinstance(s, (list, tuple)) or hasattr(_raw(s), "ndim")
                for s in batch):
            data, labels = batch
            data = self._pad_side(data, self.pad_value,
                                  self.append_valid_length)
            labels = self._pad_side(labels, self.label_pad_value, False)
            return (data, labels)
        return self._pad_side(batch, self.pad_value, self.append_valid_length)

    def wrap(self, iterator):
        """Generator applying the pad to every batch of `iterator`."""
        for batch in iterator:
            yield self(batch)


# ---------------------------------------------------------------------------
# auto-fit: the largest batch/bucket configuration that fits the device
# ---------------------------------------------------------------------------


class AutofitResult:
    """What `autofit` chose and how it got there.

    Fields: `batch_size` (largest fitting global batch), `predicted_bytes`
    / `exec_peak_bytes` / `resident_bytes` (the chosen configuration's
    plan), `capacity_bytes`, `headroom_bytes`, `buckets` (the BucketPad
    boundaries that fit at the chosen batch, when bucket lengths were
    probed), `next_larger` ({"batch_size", "predicted_bytes"} of the
    smallest probed configuration that did NOT fit; None when the search
    was capped by max_batch), and `probes` (every plan, in probe order).
    `bucket_pad(**kwargs)` builds the matching BucketPad."""

    def __init__(self, batch_size, plan, capacity_bytes, probes,
                 buckets=None, next_larger=None):
        self.batch_size = batch_size
        self.predicted_bytes = plan["predicted_bytes"]
        self.exec_peak_bytes = plan["exec_peak_bytes"]
        self.resident_bytes = plan["resident_bytes"]
        self.capacity_bytes = capacity_bytes
        self.headroom_bytes = capacity_bytes - plan["predicted_bytes"]
        self.buckets = list(buckets) if buckets is not None else None
        self.next_larger = next_larger
        self.probes = list(probes)

    def bucket_pad(self, axis=1, **kwargs):
        """A BucketPad over the bucket boundaries that fit (only when
        autofit probed buckets)."""
        if not self.buckets:
            raise ValueError("autofit ran without bucket candidates: "
                             "pass buckets=[...] to probe them")
        return BucketPad(axis_buckets={axis: list(self.buckets)}, **kwargs)

    def as_dict(self):
        return {
            "batch_size": self.batch_size,
            "predicted_bytes": self.predicted_bytes,
            "exec_peak_bytes": self.exec_peak_bytes,
            "resident_bytes": self.resident_bytes,
            "capacity_bytes": self.capacity_bytes,
            "headroom_bytes": self.headroom_bytes,
            "buckets": self.buckets,
            "next_larger": self.next_larger,
            "probes": self.probes,
        }

    def __repr__(self):
        extra = f", buckets={self.buckets}" if self.buckets else ""
        return (f"AutofitResult(batch_size={self.batch_size}, "
                f"predicted={self.predicted_bytes}, "
                f"capacity={self.capacity_bytes}{extra})")


def autofit(trainer, make_batch, max_batch=1024, capacity=None,
            buckets=None, multiple_of=None, verbose=True):
    """Binary-search the largest batch size (and optionally the BucketPad
    bucket boundaries) whose train-step peak fits the device, from
    `trainer.predict_step_bytes` at each probed shape: one forward and
    backward, measured, that leaves the trainer's state as it was (no
    step is taken).

    `make_batch(batch_size)` (or `make_batch(batch_size, seq_len)` when
    `buckets` is given) returns one `(data, labels)` host batch.
    Candidates are multiples of `multiple_of` (default: the data-axis
    extent, 1 on one card). `capacity` defaults to
    `memsafe.capacity_bytes()` (the `device_bytes_limit` knob, else the
    card's memory). When `buckets` (sequence lengths) is given, the
    batch search runs at the LARGEST bucket that fits at the smallest
    batch and each other bucket is then checked at the chosen batch; the
    result's `.bucket_pad()` keeps exactly the fitting boundaries. A
    probe that ran out of memory on the card does not fit.

    Returns an AutofitResult; raises MemoryBudgetError when even the
    smallest candidate does not fit (carrying that candidate's plan)."""
    from . import memsafe as _memsafe

    cap = capacity if capacity is not None else _memsafe.capacity_bytes()
    if not cap:
        raise ValueError(
            "autofit needs a device capacity: set the device_bytes_limit "
            "knob (simulated capacity), pass capacity=, or run on the card")
    cap = int(cap)
    m = int(multiple_of) if multiple_of else _data_axis_extent(trainer)
    k_max = max(1, int(max_batch) // m)
    probes = []

    def plan(batch_size, seq_len=None):
        batch = make_batch(batch_size) if seq_len is None \
            else make_batch(batch_size, seq_len)
        data, labels = batch
        info = trainer.predict_step_bytes(data, labels)
        # capacity/headroom/fits against THE SEARCH capacity (the
        # caller's capacity= may differ from the one predict_step_bytes
        # consulted)
        info = dict(info, batch_size=batch_size, seq_len=seq_len,
                    capacity_bytes=cap,
                    headroom_bytes=cap - info["predicted_bytes"],
                    fits=not info.get("oom")
                    and info["predicted_bytes"] <= cap)
        probes.append(info)
        if verbose:
            print(f"mx.dataflow.autofit: batch {batch_size}"
                  + (f" seq {seq_len}" if seq_len is not None else "")
                  + f" -> predicted {info['predicted_bytes']} bytes "
                  f"({'fits' if info['fits'] else 'over'} capacity {cap})",
                  file=sys.stderr)
        return info

    # anchor the batch search at the LARGEST bucket that fits at the
    # minimum batch; buckets too big even for that are dropped (logged);
    # only when NOTHING fits does autofit raise
    dropped = []
    top_seq = None
    lo_info = None
    for cand in (sorted((int(b) for b in buckets), reverse=True)
                 if buckets else [None]):
        lo_info = plan(m, cand)
        if lo_info["fits"]:
            top_seq = cand
            break
        dropped.append(cand)
    if lo_info is None or not lo_info["fits"]:
        raise _memsafe.MemoryBudgetError(
            f"autofit(batch={m})", lo_info["predicted_bytes"], cap,
            exec_peak_bytes=lo_info["exec_peak_bytes"],
            resident_bytes=lo_info["resident_bytes"])
    if dropped and verbose:
        print(f"mx.dataflow.autofit: bucket(s) {sorted(dropped)} exceed "
              f"capacity even at batch {m}: dropped", file=sys.stderr)
    # largest fitting k in [1, k_max]: invariant fits(lo), not fits(hi)
    lo, hi = 1, None
    best = lo_info
    next_larger = None
    if k_max > 1:
        hi_info = plan(k_max * m, top_seq)
        if hi_info["fits"]:
            lo, best = k_max, hi_info
        else:
            hi = k_max
            next_larger = hi_info
            while hi - lo > 1:
                mid = (lo + hi) // 2
                info = plan(mid * m, top_seq)
                if info["fits"]:
                    lo, best = mid, info
                else:
                    hi, next_larger = mid, info
    chosen = lo * m
    fitting_buckets = None
    if buckets:
        fitting_buckets = []
        for L in sorted(int(b) for b in buckets):
            if L in dropped:
                continue
            if L == top_seq:
                fitting_buckets.append(L)   # the batch search ran here
                continue
            if plan(chosen, L)["fits"]:
                fitting_buckets.append(L)
    nl = None
    if next_larger is not None:
        nl = {"batch_size": next_larger["batch_size"],
              "predicted_bytes": next_larger["predicted_bytes"]}
    result = AutofitResult(chosen, best, cap, probes,
                           buckets=fitting_buckets, next_larger=nl)
    if verbose:
        print(f"mx.dataflow.autofit: chose batch {chosen} "
              f"(predicted {result.predicted_bytes} of {cap} bytes, "
              f"headroom {result.headroom_bytes})"
              + (f", buckets {fitting_buckets}" if buckets else "")
              + (f"; batch {nl['batch_size']} would NOT fit "
                 f"({nl['predicted_bytes']} bytes)" if nl else
                 "; search capped at max_batch"),
              file=sys.stderr)
    return result


def _data_axis_extent(trainer):
    """Devices the batch axis shards over: 1, as the port trains on one
    device (the JAX package's dp*fsdp of a mesh)."""
    return 1
