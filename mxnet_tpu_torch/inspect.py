"""mx.inspect — per-step cost attribution (counterpart of
`mxnet_tpu/inspect.py`).

The JAX package compiles each new step signature once more for XLA's
`cost_analysis()` / `memory_analysis()`. Eager PyTorch compiles nothing,
so here the first step at each new signature (the same miss the
telemetry and flight-ring hooks see) runs under `count_step`:

  * **flops** — `torch.utils.flop_counter.FlopCounterMode` counts the
    step's ATen matmul-class ops (mm, bmm, addmm, convolutions, their
    backward). The port's hand-written kernels are launched through
    ctypes, where no dispatch mode sees them, so each kernel wrapper adds
    its launch's matmul FLOPs from its shapes (`cuda_ops._build.
    cost_tally`): flash forward 2 L x L products, dq 3 and dkv 4 (the
    backward recomputes the scores, as the plain versions do), paged
    attention 2 over the table's width, the int8 GEMM 2MKO. Elementwise
    work (the optimizers, MoE dispatch/combine, norms) counts 0, as
    FlopCounterMode counts it;
  * **bytes accessed** — the bytes every ATen op of the step reads and
    writes (a dispatch mode; views move none) plus each kernel launch's
    tensors: what an eager step moves, XLA's `bytes accessed` for a
    program of unfused ops;
  * **device memory** — the JAX package's fields from what the step
    holds and allocates: `argument_bytes` the resident tensors it is
    handed (parameters, optimizer state, batch), `temp_bytes` its
    measured peak above what was allocated when it began
    (`torch.cuda.max_memory_allocated` after a peak reset on the card;
    the memory events of a CPU `torch.profiler` session on the CPU),
    `peak_bytes` their sum;
  * **MFU** — achieved FLOP/s (flops / measured step time of the later
    steps at that signature) against the card's peak: the `peak_flops`
    knob, else a table keyed by `torch.cuda.get_device_name()` that holds
    the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s). Cards the table
    does not know, and the CPU, report null, never 0 or inf;
  * **collective traffic** — `estimate_collectives` keeps the JAX
    package's ring-algorithm estimate from sharding specs and a mesh
    shape (the port trains on one device, where it is empty).

Surfaced as in the JAX package: telemetry gauges/counters
(`executable_flops`, `executable_peak_bytes`, `mfu_ratio`,
`collective_bytes_est{op=...}`) and `cost` events, the flight-recorder
ring and the post-mortem JSON, and `dump()` for `tools/inspect_report.py`.

Cost model: DISABLED (the default) is the production fast path — every
hook site checks one module-level bool and falls through. ENABLED, the
counting step runs under the dispatch mode (slower, once per signature,
and excluded from the timed steps), and the trainers fence every step so
recorded step time is device time.
"""
from __future__ import annotations

import atexit
import json
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import _locklint
from . import config
from . import diagnostics as _diagnostics
from . import telemetry as _telemetry

__all__ = [
    "enable", "disable", "enabled", "reset",
    "CostRecord", "analyze_jit", "record_compiled", "count_step",
    "note_step",
    "records", "get", "snapshot", "summary", "dump", "memory_breakdown",
    "peak_flops_per_chip", "peak_bandwidth_per_chip",
    "estimate_collectives", "key_repr",
]

_lock = _locklint.make_rlock("inspect.registry")
_enabled = False                  # the fast-path bool; see enable()/disable()
# plain dict when tsan-lite is off; armed, every mutation asserts _lock
# is held (the shared-structure half of the concurrency analysis)
_registry = _locklint.guarded_dict(_lock, "inspect.registry")
# (name, key) -> CostRecord
_last_live_dump = 0.0
_LIVE_DUMP_INTERVAL = 30.0        # seconds between inspect_dir refreshes

# Per-card dense bf16 peak FLOP/s and memory bandwidth, matched against
# torch.cuda.get_device_name() substrings (lower case). The H100 SXM's
# published figures; other cards (the H100 PCIe and NVL parts included)
# set the `peak_flops` knob.
_PEAK_FLOPS_TABLE = (
    ("h100 80gb hbm3", 989e12), ("h100 sxm", 989e12),
)
_PEAK_BW_TABLE = (
    ("h100 80gb hbm3", 3.35e12), ("h100 sxm", 3.35e12),
)

# memory-bound remediation hints: the port's kernel that applies, by
# executable-name fragment, most specific first
_KERNEL_HINTS = (
    ("moe", "cuda_ops.moe_kernels: fused MoE dispatch/combine without "
            "the (N,E,C) one-hot tensor"),
    ("serve", "cuda_ops.int8_matmul via "
              "contrib.quantization.quantize_block: int8 decode matmuls "
              "with the per-channel rescale fused"),
    ("generate", "cuda_ops.int8_matmul via "
                 "contrib.quantization.quantize_block: int8 decode "
                 "matmuls with the per-channel rescale fused"),
    ("trainer", "cuda_ops.fused_update: one-pass optimizer update (LAMB "
                "flat master, Adam list kernel)"),
)
_KERNEL_HINT_DEFAULT = (
    "cuda_ops/: a hand-written kernel can beat the eager op chain where "
    "the roofline says memory-bound")

# telemetry series (get-or-create; updates are no-ops while telemetry is
# disabled, so inspect-without-telemetry costs nothing here)
_M_EXEC_FLOPS = _telemetry.gauge(
    "executable_flops", "counted flops of one step at one signature "
    "(labeled by executable name)")
_M_EXEC_PEAK = _telemetry.gauge(
    "executable_peak_bytes", "measured peak device bytes allocated while "
    "the counted step ran")
_M_MFU = _telemetry.gauge(
    "mfu_ratio", "achieved FLOP/s over per-chip peak for one executable "
    "(null-backed: stays unset when peak flops is unknown)")
_M_COLL_EST = _telemetry.counter(
    "collective_bytes_est", "estimated collective payload bytes per "
    "executed step, from sharding specs + mesh shape (ring-algorithm "
    "per-device cost), labeled by collective op")


def enabled():
    """True when cost attribution is on (hook sites read the module global
    `_enabled` directly — this accessor is the public spelling)."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def reset():
    """Drop every CostRecord (tests and run boundaries; the cached
    device-kind lookup drops too, for tests that swap backends)."""
    global _kind_cache
    with _lock:
        _registry.clear()
        _kind_cache = None


# ---------------------------------------------------------------------------
# backend peaks
# ---------------------------------------------------------------------------

_kind_cache = None                # the card's name can't change mid-process


def _device_kind():
    """torch.cuda.get_device_name() of the current card, '' when this
    process has not initialised CUDA (never initialises it — the same
    rule as the diagnostics memory poll). Cached after the first
    lookup."""
    global _kind_cache
    if _kind_cache is not None:
        return _kind_cache
    if not _diagnostics._cuda_devices_if_initialized():
        return ""
    _kind_cache = torch.cuda.get_device_name()
    return _kind_cache


def _table_lookup(table, kind):
    kind = kind.lower()
    for frag, value in table:
        if frag in kind:
            return value
    return None


def peak_flops_per_chip():
    """Per-card peak FLOP/s: the `peak_flops` knob when set, else the
    table by the card's name, else None (the CPU and unknown cards: MFU
    is then reported null)."""
    knob = float(config.get("peak_flops"))
    if knob > 0:
        return knob
    return _table_lookup(_PEAK_FLOPS_TABLE, _device_kind())


def peak_bandwidth_per_chip():
    """Per-card memory bandwidth (bytes/s) from the table, None when
    unknown — the roofline ridge point needs both peaks."""
    return _table_lookup(_PEAK_BW_TABLE, _device_kind())


# ---------------------------------------------------------------------------
# collective-traffic estimate
# ---------------------------------------------------------------------------

def estimate_collectives(mesh, sized_shardings, zero=None):
    """Estimated collective payload bytes per train step for one
    executable, from its parameter shardings + mesh shape.

    `sized_shardings`: [(nbytes, sharding_or_spec), ...] for every trained
    parameter. Ring-algorithm per-device costs: all-reduce moves
    2*(n-1)/n of the payload, all-gather and reduce-scatter (n-1)/n.
    Model: replicated params all-reduce (psum) their gradient over the
    data axes; fsdp-sharded params all-gather before use and
    reduce-scatter the gradient over fsdp, then all-reduce the shard over
    dp. `zero`: optional per-entry bools — a mx.zero'd parameter's
    would-be gradient psum is replaced by the reduce-scatter(grad) +
    all-gather(updated param) pair the zero step actually runs: the SAME
    ring bytes ((n-1)/n each way vs 2*(n-1)/n), attributed to the real
    ops. Tensor-parallel activation collectives are not modeled — this is
    the data-parallel budget, labeled an estimate everywhere it surfaces.
    Returns {} when no data axis spans more than one device."""
    dp = int(mesh.shape.get("dp", 1))
    fsdp = int(mesh.shape.get("fsdp", 1))
    n = dp * fsdp
    if n <= 1:
        return {}
    out = {"psum": 0.0, "all_gather": 0.0, "reduce_scatter": 0.0}

    def _reduce(nbytes, degree, zeroed):
        # one gradient reduction over `degree` devices: psum classically,
        # the rs/ag split (half the 2(n-1)/n each) when zero'd
        cost = 2.0 * (degree - 1) / degree * nbytes
        if zeroed:
            out["reduce_scatter"] += cost / 2.0
            out["all_gather"] += cost / 2.0
        else:
            out["psum"] += cost

    for i, (nbytes, sharding) in enumerate(sized_shardings):
        nbytes = float(nbytes)
        zeroed = bool(zero[i]) if zero else False
        spec = getattr(sharding, "spec", sharding)
        axes = set()
        for entry in (spec or ()):
            if entry is None:
                continue
            axes.update(entry if isinstance(entry, tuple) else (entry,))
        if "fsdp" in axes and fsdp > 1:
            out["all_gather"] += (fsdp - 1) / fsdp * nbytes
            out["reduce_scatter"] += (fsdp - 1) / fsdp * nbytes
            if dp > 1:
                _reduce(nbytes / fsdp, dp, zeroed)
        else:
            _reduce(nbytes, n, zeroed)
    return {k: int(v) for k, v in out.items() if v > 0}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def key_repr(key):
    """Stable string form of a step-signature key (the registry key
    component). repr() is deterministic for the shape/dtype/flag tuples
    the hooks use."""
    return repr(key)


class CostRecord:
    """Cost attribution for ONE step signature: the counted FLOPs and
    measured peak of its first step plus step-time accounting fed from
    the trainer. Fields the counting could not fill stay None."""

    def __init__(self, name, key):
        self.name = name
        self.key = key
        self.created = time.time()
        self.compiles = 0
        self.flops = None             # counted flops per execution
        self.bytes_accessed = None    # device bytes touched per execution
        self.argument_bytes = None
        self.output_bytes = None
        self.temp_bytes = None
        self.donated_bytes = None     # alias/donation savings
        self.peak_bytes = None        # args + outputs + temps - donated
        self.generated_code_bytes = None
        self.collectives = {}         # op -> estimated bytes per step
        self.steps = 0
        self.step_time_s = 0.0
        self.analysis_error = None    # str when cost/memory analysis failed

    # -- derived metrics ------------------------------------------------
    def avg_step_s(self):
        return self.step_time_s / self.steps if self.steps else None

    def achieved_flops(self):
        """Achieved FLOP/s over measured step time (None until both the
        cost analysis and at least one timed step exist)."""
        avg = self.avg_step_s()
        if self.flops is None or not avg:
            return None
        return self.flops / avg

    def mfu(self, peak=None):
        """Achieved/peak FLOP/s; None (never 0 or inf) when either the
        achieved rate or the per-chip peak is unknown."""
        ach = self.achieved_flops()
        peak = peak if peak is not None else peak_flops_per_chip()
        if ach is None or not peak:
            return None
        return ach / peak

    def arithmetic_intensity(self):
        """flops per byte accessed (the roofline x-axis)."""
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def roofline(self, peak=None, bandwidth=None):
        """'compute-bound' or 'memory-bound' against the backend ridge
        point (peak flops / memory bandwidth); None when any input is
        unknown."""
        ai = self.arithmetic_intensity()
        peak = peak if peak is not None else peak_flops_per_chip()
        bandwidth = bandwidth if bandwidth is not None \
            else peak_bandwidth_per_chip()
        if ai is None or not peak or not bandwidth:
            return None
        return "compute-bound" if ai >= peak / bandwidth else "memory-bound"

    def comm_bytes_per_step(self):
        return sum(self.collectives.values()) if self.collectives else None

    def kernel_hint(self):
        """The remediation for a memory-bound executable: which of the
        port's kernels applies, matched on the executable name (None
        unless the roofline verdict is memory-bound)."""
        if self.roofline() != "memory-bound":
            return None
        name = (self.name or "").lower()
        for frag, hint in _KERNEL_HINTS:
            if frag in name:
                return hint
        return _KERNEL_HINT_DEFAULT

    def as_dict(self):
        d = {
            "name": self.name, "key": self.key, "created": self.created,
            "compiles": self.compiles, "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "donated_bytes": self.donated_bytes,
            "peak_bytes": self.peak_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "collectives": dict(self.collectives),
            "comm_bytes_per_step": self.comm_bytes_per_step(),
            "steps": self.steps,
            "step_time_s": round(self.step_time_s, 6),
            "avg_step_s": self.avg_step_s(),
            "achieved_flops": self.achieved_flops(),
            "mfu": self.mfu(),
            "arithmetic_intensity": self.arithmetic_intensity(),
            "roofline": self.roofline(),
            "kernel_hint": self.kernel_hint(),
        }
        if self.analysis_error:
            d["analysis_error"] = self.analysis_error
        return d


def _get_record(name, key):
    with _lock:
        rec = _registry.get((name, key))
        if rec is None:
            rec = CostRecord(name, key)
            _registry[(name, key)] = rec
        return rec


def memory_breakdown(mem):
    """(argument, output, temp, alias, peak) bytes from an object with
    the JAX package's CompiledMemoryStats fields — peak is args + outputs
    + temps - donated, None when any component is missing."""
    if mem is None:
        return None, None, None, None, None
    arg = getattr(mem, "argument_size_in_bytes", None)
    out = getattr(mem, "output_size_in_bytes", None)
    tmp = getattr(mem, "temp_size_in_bytes", None)
    alias = getattr(mem, "alias_size_in_bytes", None)
    peak = None
    if None not in (arg, out, tmp):
        peak = arg + out + tmp - (alias or 0)
    return arg, out, tmp, alias, peak


def _first_dict(analysis):
    """A cost analysis given as a dict or as a list of per-module dicts
    (the JAX package's two forms), normalized to the first dict ({} when
    absent or unrecognizable)."""
    if isinstance(analysis, dict):
        return analysis
    if isinstance(analysis, (list, tuple)) and analysis \
            and isinstance(analysis[0], dict):
        return analysis[0]
    return {}


def record_compiled(name, key, compiled, collectives=None):
    """Attribute one analysed step from an object with the JAX package's
    `cost_analysis()` / `memory_analysis()` surface (partial or raising
    analyses degrade to null fields) and fold the result into the
    registry, the telemetry gauges + `cost` event, and the diagnostics
    flight ring. Returns the CostRecord. Never raises."""
    rec = _get_record(name, key)
    errors = []
    cost = {}
    try:
        cost = _first_dict(compiled.cost_analysis())
    except Exception as e:
        errors.append(f"cost_analysis: {type(e).__name__}: {e}")
    mem = None
    try:
        mem = compiled.memory_analysis()
    except Exception as e:
        errors.append(f"memory_analysis: {type(e).__name__}: {e}")
    with _lock:
        rec.compiles += 1
        if "flops" in cost:
            rec.flops = float(cost["flops"])
        if "bytes accessed" in cost:
            rec.bytes_accessed = float(cost["bytes accessed"])
        if mem is not None:
            arg, out, tmp, alias, peak = memory_breakdown(mem)
            rec.argument_bytes = arg
            rec.output_bytes = out
            rec.temp_bytes = tmp
            rec.donated_bytes = alias
            rec.generated_code_bytes = getattr(
                mem, "generated_code_size_in_bytes", None)
            if peak is not None:
                rec.peak_bytes = peak
        if collectives:
            rec.collectives = dict(collectives)
        if errors:
            rec.analysis_error = "; ".join(errors)
    _publish(name, key, rec)
    return rec


def _publish(name, key, rec):
    """The telemetry gauges + `cost` event and the flight-ring entry of
    a freshly attributed record."""
    if _telemetry._enabled:
        if rec.flops is not None:
            _M_EXEC_FLOPS.labels(executable=name).set(rec.flops)
        if rec.peak_bytes is not None:
            _M_EXEC_PEAK.labels(executable=name).set(rec.peak_bytes)
        _telemetry.event(
            "cost", executable=name, key=key, flops=rec.flops,
            bytes_accessed=rec.bytes_accessed, peak_bytes=rec.peak_bytes,
            argument_bytes=rec.argument_bytes,
            output_bytes=rec.output_bytes, temp_bytes=rec.temp_bytes,
            donated_bytes=rec.donated_bytes,
            collectives=dict(rec.collectives),
            peak_flops=peak_flops_per_chip(),
            peak_bandwidth=peak_bandwidth_per_chip(),
            backend=_device_kind() or None)
    if _diagnostics._enabled:
        # the ring entry makes shape-churn-into-OOM diagnosable: a
        # post-mortem whose last compiles show growing peak_bytes is the
        # smoking gun
        _diagnostics.record_event(
            "cost", executable=name, flops=rec.flops,
            peak_bytes=rec.peak_bytes, bytes_accessed=rec.bytes_accessed)


class _BytesMode(TorchDispatchMode):
    """Sums the bytes every ATen op of the step reads and writes (each
    tensor argument and result once; a view moves none): what an eager
    step moves through memory, the counterpart of XLA's `bytes accessed`
    for a program of unfused ops. `observer(func, args, kwargs, out)`,
    when given, sees every op too: mx.check's `StepRecord` rides this
    mode, so a first call that both modules watch runs under one
    dispatch mode."""

    def __init__(self, observer=None):
        super().__init__()
        self.bytes = 0
        self.observer = observer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if schema.is_mutable or not any(r.alias_info is not None
                                        for r in schema.returns):
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        if self.observer is not None:
            self.observer(func, args, kwargs, out)
        return out


def _cpu_peak(prof):
    """Peak of the bytes a CPU profiler session saw allocated above its
    start (its memory events, in time order)."""
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name() == "[memory]"), key=lambda e: e.start_ns())
    cur = peak = 0
    for e in evs:
        cur += e.nbytes()
        peak = max(peak, cur)
    return peak


def _nbytes(tensors):
    """Bytes of the distinct storages among `tensors`."""
    seen, n = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                n += st.nbytes()
    return n


def count_step(name, key, fn, args=(), collectives=None, observer=None):
    """Run `fn()` (the first step at signature `key`) once, counting its
    FLOPs (FlopCounterMode plus the kernel wrappers' tallies), the bytes
    its ops and kernels read and write (`_BytesMode` plus the tallies),
    and its memory, the JAX package's fields: `argument_bytes` the
    resident tensors `args` (parameters, optimizer state, batch),
    `output_bytes` fn's result tensors, `temp_bytes` the measured peak of
    what the step allocated above what was allocated when it began (the
    caching allocator's peak on the card; on the CPU, a `torch.profiler`
    session's memory events), `peak_bytes` arguments + temps. Folds them
    into the record of (`name`, `key`), the telemetry gauges and `cost`
    event, and the flight ring. `observer` (mx.check's `StepRecord`)
    rides the same dispatch mode and sees every op and kernel launch.
    Returns fn's result; fn's exceptions propagate."""
    from torch.utils.flop_counter import FlopCounterMode
    from .cuda_ops import _build
    rec = _get_record(name, key)
    on_card = bool(_diagnostics._cuda_devices_if_initialized())
    prof = None
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    elif not torch.autograd.profiler._is_profiler_enabled:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            profile_memory=True)
    tally = [0, 0]
    prev, _build.cost_tally = _build.cost_tally, tally
    prev_obs = _build.launch_observer
    if observer is not None:
        _build.launch_observer = observer.note_launch
    flops, moved = FlopCounterMode(display=False), _BytesMode(observer)
    try:
        if prof is not None:
            prof.start()
        try:
            with flops, moved:
                out = fn()
        finally:
            if prof is not None:
                prof.stop()
    finally:
        _build.cost_tally = prev
        _build.launch_observer = prev_obs
    temp = None
    if on_card:
        torch.cuda.synchronize()
        temp = int(torch.cuda.max_memory_allocated()) - base
    elif prof is not None:
        temp = _cpu_peak(prof)
    arg = _nbytes(args)
    with _lock:
        rec.compiles += 1
        rec.flops = float(flops.get_total_flops() + tally[0])
        rec.bytes_accessed = float(moved.bytes + tally[1])
        rec.argument_bytes = arg
        rec.output_bytes = _nbytes(torch.utils._pytree.tree_leaves(
            getattr(out, "_t", out)))
        rec.temp_bytes = temp
        rec.peak_bytes = None if temp is None else arg + temp
        if collectives:
            rec.collectives = dict(collectives)
    _publish(name, key, rec)
    return out


def analyze_jit(name, key, jitted, *args, collectives=None):
    """The JAX package's analysis entry for an object with its
    `lower(*args).compile()` surface: record what the compiled object's
    `cost_analysis()` / `memory_analysis()` report (`record_compiled`),
    or an analysis_error when it cannot lower/compile. The port's own
    steps are counted by `count_step`. Never raises."""
    if not _enabled:
        return None
    try:
        compiled = jitted.lower(*args).compile()
    except Exception as e:
        rec = _get_record(name, key)
        with _lock:
            rec.compiles += 1
            rec.analysis_error = f"lower/compile: {type(e).__name__}: {e}"
            if collectives:
                rec.collectives = dict(collectives)
        return rec
    return record_compiled(name, key, compiled, collectives=collectives)


def note_step(name, key, dur_s):
    """Fold one measured step execution into the record: step count +
    wall time (the MFU denominator), the mfu_ratio gauge, and the per-op
    collective_bytes_est counters. Hook sites guard on `_enabled`
    themselves; this re-checks for direct callers."""
    if not _enabled:
        return
    with _lock:
        rec = _registry.get((name, key))
        if rec is None:
            return
        rec.steps += 1
        rec.step_time_s += float(dur_s)
    if _telemetry._enabled:
        m = rec.mfu()
        if m is not None:
            _M_MFU.labels(executable=name).set(m)
        for op, nbytes in rec.collectives.items():
            _M_COLL_EST.labels(op=op).inc(nbytes)
    _maybe_live_dump()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def records():
    """All CostRecords, insertion-ordered."""
    with _lock:
        return list(_registry.values())


def get(name, key=None):
    """The CostRecord for `name` (+ `key` when several signatures exist);
    None when absent."""
    with _lock:
        if key is not None:
            return _registry.get((name, key))
        for (n, _), rec in _registry.items():
            if n == name:
                return rec
    return None


def snapshot():
    """The registry as plain data (what dump() writes and the post-mortem
    embeds): the card + peaks, every record, and the executable with the
    largest peak_bytes — the first thing to read after an OOM."""
    with _lock:
        recs = [r.as_dict() for r in _registry.values()]
    largest = None
    best = -1
    for r in recs:
        if r["peak_bytes"] is not None and r["peak_bytes"] > best:
            best, largest = r["peak_bytes"], r["name"]
    return {
        "backend": _device_kind() or None,
        "peak_flops_per_chip": peak_flops_per_chip(),
        "peak_bandwidth_per_chip": peak_bandwidth_per_chip(),
        "largest_peak_bytes_executable": largest,
        "records": recs,
    }


def summary():
    """Headline efficiency numbers for the hottest executable (most flops
    among those with timed steps, else most flops overall). All values
    nullable; {} when the registry is empty."""
    with _lock:
        recs = list(_registry.values())
    timed = [r for r in recs if r.steps and r.flops is not None] or \
        [r for r in recs if r.flops is not None] or recs
    if not timed:
        return {}
    rec = max(timed, key=lambda r: r.flops or 0.0)
    ach = rec.achieved_flops()
    return {
        "executable": rec.name,
        "flops": rec.flops,
        "mfu": rec.mfu(),
        "achieved_tflops": ach / 1e12 if ach is not None else None,
        "peak_device_bytes": rec.peak_bytes,
        "comm_bytes_per_step": rec.comm_bytes_per_step(),
        "arithmetic_intensity": rec.arithmetic_intensity(),
        "roofline": rec.roofline(),
    }


def _default_dump_path():
    d = config.get("inspect_dir")
    if not d:
        return None
    return os.path.join(d, str(_diagnostics._rank()), "inspect.json")


def dump(path=None):
    """Write snapshot() as JSON to `path` (default:
    inspect_dir/<rank>/inspect.json — the file tools/inspect_report.py
    reads). Returns the path, or None when there is no target."""
    path = path or _default_dump_path()
    if not path:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot(), f, default=str)
    os.replace(tmp, path)  # readers (live report) never see a torn file
    return path


def _maybe_live_dump():
    """Periodic inspect_dir refresh so the report CLI can watch a live
    run; rate-limited, and any write failure is swallowed (attribution
    must never kill the step it is observing)."""
    global _last_live_dump
    if not config.get("inspect_dir"):
        return
    now = time.monotonic()
    if now - _last_live_dump < _LIVE_DUMP_INTERVAL:
        return
    _last_live_dump = now
    try:
        dump()
    except OSError:
        pass


@atexit.register
def _dump_at_exit():
    if not _enabled or not config.get("inspect_dir"):
        return
    try:
        dump()
    except OSError:
        pass    # nothing useful to do with a write error at interpreter exit


if config.get("inspect"):
    enable()
