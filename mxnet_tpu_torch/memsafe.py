"""Never-OOM execution (counterpart of `mxnet_tpu/memsafe.py`): the
budget check, the graduated remat policies and the trainer's
degradation ladder.

  * **budget check** — serving admits a request only when its bucket's
    predicted peak fits the device: resident bytes (parameters, KV
    caches or the page pool) plus the step's execution peak, against the
    capacity. A predicted overrun raises `MemoryBudgetError` BEFORE any
    allocation or dispatch, and the server turns it into its degradation
    ladder or a 429 verdict. The JAX package predicts the execution peak
    from XLA's AOT memory analysis; PyTorch runs eagerly and has none, so
    the server measures the peak once per executable shape on the card
    (`Server._exec_peak`) and passes it in here; on the CPU it passes
    None, and the check compares resident bytes alone, as the JAX
    package does when analysis is withheld.
  * **graduated remat policies** — `Block.remat(policy)` with `POLICIES`
    ("none" | "dots_saveable" | "layers" | "full", in increasing memory
    savings and recompute cost; `models._remat` builds each on
    `torch.utils.checkpoint`); the `remat_policy` knob is the default of
    every block, and the per-model `remat=True` config flag stays the
    "layers" alias (`effective_policy`). BERT and GPT consume the policy
    per layer; any other block gets it around its whole forward in the
    trainer (`block_wrap_policy`).
  * **the trainer's ladder** — with `oom_recover="auto"`, an
    out-of-memory at the `ShardedTrainer` step (`is_oom`: a real
    `torch.cuda.OutOfMemoryError`, `MemoryBudgetError`, or the `oom`
    fault's `SimulatedResourceExhausted`) raised before the optimizer
    touched any state walks `LADDER` instead of crashing
    (`recover_trainer`): the remat policy one rung up, then (where there
    are data replicas to shard over; never on one card, and the port
    trains on one) optimizer-state sharding, then gradient accumulation
    x2 while the batch divides; after each rung the step runs again.
    Each transition is recorded (`transitions()`, `snapshot()`) and
    printed. `oom_recover="off"` (default) fails fast.

  * **the pre-flight check at a new signature** — with memsafe armed,
    the first `ShardedTrainer` step at a batch signature measures its
    forward and backward (`measure_peak`) and `preflight_step` compares
    resident bytes (parameters, optimizer state, aux tensors, batch)
    plus that peak with the capacity after the backward and before the
    optimizer touches state, so it costs no extra pass and a
    `MemoryBudgetError` enters the ladder with the state intact (the aux
    tensors a training forward updated are put back). The JAX package
    predicts the peak before dispatch from XLA's AOT analysis; the port
    has none and measures the pass it runs. A hybridized block's first
    call at a signature is checked on its resident bytes (parameters and
    inputs) alone, before it runs.
    `ShardedTrainer.predict_step_bytes`, which `dataflow.autofit`
    searches over, measures the same way without updating anything.

`maybe_enable()` (called at trainer construction) arms the trainer hook
when `oom_recover="auto"` or `device_bytes_limit` is set; disabled (the
default), the step's hook is one module-bool read on an already failing
path.

Observers, as in the JAX package: telemetry's `memory_headroom_bytes`
gauge (each budget check), `oom_events_total` (device OOMs and budget
rejections, with an `oom` event) and `oom_recoveries_total`,
`memsafe_warning` and `memsafe` (ladder rung) events, and the same
records in the diagnostics flight ring; the post-mortem carries
`snapshot()`.
"""
from __future__ import annotations

import gc
import sys
import threading
import time
import traceback

import torch

from . import config as _config
from . import diagnostics as _diagnostics
from . import goodput as _goodput
from . import telemetry as _telemetry

__all__ = ["enable", "disable", "enabled", "maybe_enable",
           "MemoryBudgetError", "SimulatedResourceExhausted", "is_oom",
           "capacity_bytes", "resident_bytes", "check_budget", "last_check",
           "measure_peak", "preflight_step",
           "last_headroom_bytes", "reset", "POLICIES", "LADDER",
           "validate_policy", "effective_policy", "policy_marker",
           "block_wrap_policy", "recover_trainer", "note_eager_oom",
           "transitions", "snapshot", "oom_events"]

_lock = threading.RLock()
_enabled = False              # the trainer hook's fast-path bool
_last_check = None            # dict of the most recent budget check
_warned = set()               # executables already headroom-warned
_totals = {}                  # CUDA device index -> its total memory
_transitions = []             # degradation-ladder transitions this process
_oom_events = 0

_M_HEADROOM = _telemetry.gauge(
    "memory_headroom_bytes", "device capacity minus the predicted peak of "
    "the last budget-checked executable (resident state + execution "
    "peak); negative would have been an OOM — the check raises instead")
_M_OOM_EVENTS = _telemetry.counter(
    "oom_events_total", "out-of-memory events seen at the trainer boundary "
    "(device out-of-memory errors) plus budget-check rejections")
_M_OOM_RECOVERIES = _telemetry.counter(
    "oom_recoveries_total", "OOM events survived by the oom_recover=auto "
    "degradation ladder (the step completed after remat escalation and/or "
    "gradient-accumulation microbatching)")


def _fmt(n):
    """Human bytes for messages: '1.50 GiB (1610612736 bytes)'."""
    n = int(n)
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit} ({n} bytes)"
    return f"{n} bytes"


class MemoryBudgetError(RuntimeError):
    """The budget check predicted an out-of-memory: the executable's
    predicted peak (execution peak + resident state) exceeds the device
    capacity. Raised BEFORE any device dispatch. Carries the accounting
    so callers (the serving ladder) can act on it."""

    def __init__(self, executable, predicted_bytes, capacity_bytes,
                 exec_peak_bytes=None, resident_bytes=None):
        self.executable = executable
        self.predicted_bytes = int(predicted_bytes)
        self.capacity_bytes = int(capacity_bytes)
        self.exec_peak_bytes = exec_peak_bytes
        self.resident_bytes = resident_bytes
        self.headroom_bytes = int(capacity_bytes) - int(predicted_bytes)
        short = -self.headroom_bytes
        parts = ""
        if exec_peak_bytes is not None and resident_bytes is not None:
            parts = (f" ({_fmt(exec_peak_bytes)} execution peak + "
                     f"{_fmt(resident_bytes)} resident params/optimizer/"
                     "batch)")
        super().__init__(
            f"predicted peak device memory for executable '{executable}' is "
            f"{_fmt(predicted_bytes)}{parts} but device capacity is "
            f"{_fmt(capacity_bytes)} — {_fmt(short)} short. Remediations, "
            "cheapest first: (1) rematerialization — "
            "block.remat(policy='dots_saveable'|'layers'|'full') or the "
            "remat_policy knob trades recompute for activation memory; "
            "(2) shard optimizer state across the data replicas — set "
            "zero=auto (mx.zero) or trainer.set_zero(True): resident "
            "opt-state bytes drop by (D-1)/D with values unchanged; "
            "(3) a smaller batch or BucketPad bucket — dataflow.autofit() "
            "binary-searches the largest configuration that fits. "
            "Set oom_recover=auto to walk these "
            "automatically, or raise device_bytes_limit if the simulated "
            "capacity is wrong.")


class SimulatedResourceExhausted(RuntimeError):
    """Synthetic device OOM raised by the `oom@step:N` fault
    (`resilience.FaultInjector`) at the dispatch of step N, before the
    step touches any state: every rung of the ladder is drivable on the
    CPU. The message carries the JAX package's RESOURCE_EXHAUSTED
    marker."""

    def __init__(self, step=None):
        super().__init__(
            "RESOURCE_EXHAUSTED: synthetic out-of-memory injected by "
            f"resilience fault_inject oom@step:{step} (no device "
            "allocation actually failed)")


def enabled():
    """True when the trainer's OOM hook is armed."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def maybe_enable():
    """Arm the trainer hook iff the knobs ask for it (`oom_recover=auto`
    or a positive `device_bytes_limit`); called at trainer construction,
    so a `config.set` after import takes effect."""
    if not _enabled and (_config.get("oom_recover") == "auto"
                         or int(_config.get("device_bytes_limit")) > 0):
        enable()
    return _enabled


def is_oom(exc):
    """True for anything the ladder can act on: a device out-of-memory
    (`torch.cuda.OutOfMemoryError`), the budget check's
    MemoryBudgetError, or the `oom` fault's SimulatedResourceExhausted."""
    return isinstance(exc, (MemoryBudgetError, SimulatedResourceExhausted,
                            torch.cuda.OutOfMemoryError))


def reset():
    """Drop the recorded check, warnings, transitions and OOM count
    (tests and run boundaries)."""
    global _last_check, _oom_events
    with _lock:
        _last_check = None
        _oom_events = 0
        del _transitions[:]
        _warned.clear()


def capacity_bytes(device=None):
    """Device memory capacity in bytes: the `device_bytes_limit` knob when
    positive (tests simulate any capacity this way), else the total
    memory of the CUDA device `device` (the current one when None) as
    `torch.cuda.mem_get_info` reports it, else None: a CPU device, or
    CUDA not initialised yet by anything else (this never initialises
    it)."""
    knob = int(_config.get("device_bytes_limit"))
    if knob > 0:
        return knob
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_initialized():
        return None
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _totals:       # read once: the scheduler asks every step
        try:
            _totals[idx] = int(torch.cuda.mem_get_info(idx)[1])
        except Exception:
            return None
    return _totals[idx]


def resident_bytes(tensors):
    """Total bytes of the given tensors — the state that stays resident
    while the executable runs (parameters, caches, the page pool)."""
    return sum(int(t.numel()) * int(t.element_size()) for t in tensors)


def check_budget(executable, exec_peak, resident, capacity=None):
    """Compare one executable's predicted peak (execution peak + resident
    state) against capacity. Records the check (last_check), warns when
    headroom drops below the `memory_headroom_warn` fraction of
    capacity, and raises MemoryBudgetError on a predicted overrun.
    `exec_peak` None (no measurement) checks resident state alone."""
    global _last_check
    capacity = capacity if capacity is not None else capacity_bytes()
    predicted = int(resident or 0) + int(exec_peak or 0)
    headroom = None if capacity is None else int(capacity) - predicted
    with _lock:
        _last_check = {
            "executable": executable,
            "exec_peak_bytes": exec_peak,
            "resident_bytes": int(resident or 0),
            "predicted_bytes": predicted,
            "capacity_bytes": capacity,
            "headroom_bytes": headroom,
            "ts": time.time(),
        }
    if capacity is None:
        return _last_check
    if _telemetry._enabled:
        _M_HEADROOM.set(headroom)
    if headroom < 0:
        _count_oom("budget", executable)
        raise MemoryBudgetError(executable, predicted, capacity,
                                exec_peak_bytes=exec_peak,
                                resident_bytes=int(resident or 0))
    warn_frac = float(_config.get("memory_headroom_warn"))
    if warn_frac > 0 and headroom < warn_frac * capacity \
            and executable not in _warned:
        _warned.add(executable)
        print(f"mx.memsafe: WARNING — executable '{executable}' leaves only "
              f"{_fmt(headroom)} headroom ({headroom / capacity:.1%} of "
              f"capacity, warn threshold {warn_frac:.1%}); one larger bucket "
              "or a fragmentation spike away from an out-of-memory",
              file=sys.stderr)
        if _telemetry._enabled:
            _telemetry.event("memsafe_warning", executable=executable,
                             headroom_bytes=headroom,
                             predicted_bytes=predicted,
                             capacity_bytes=capacity)
        if _diagnostics._enabled:
            _diagnostics.record_event(
                "memsafe_warning", executable=executable,
                headroom_bytes=headroom, predicted_bytes=predicted)
    return _last_check


def measure_peak(fn, device):
    """(fn(), the peak bytes fn allocated above what was allocated when
    it began): the caching allocator's peak on the card (after a peak
    reset, with a sync on each side); on the CPU the memory events of a
    `torch.profiler` run, as `inspect.count_step` reads them (None
    when a profiler is running already). A garbage collection runs
    first: unreachable tensors that a collection inside fn would free
    would lower the allocation under fn's own and hide its peak."""
    gc.collect()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        torch.cuda.synchronize(device)
        return out, int(torch.cuda.max_memory_allocated(device)) - base
    if torch.autograd.profiler._is_profiler_enabled:
        return fn(), None
    from .inspect import _cpu_peak
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        profile_memory=True)
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, _cpu_peak(prof)


def preflight_step(trainer, fn, batch):
    """The check of a `ShardedTrainer` step at a new signature: `fn` is
    the step's forward and backward, run here and measured; its peak plus
    the resident state and `batch` is checked against the capacity
    (`check_budget`, which raises MemoryBudgetError on an overrun) before
    fn's result goes back to the optimizer. On a raise the aux tensors
    (BatchNorm's running statistics) are put back as fn found them. With
    no capacity known, fn runs unmeasured and the resident bytes are
    recorded."""
    name = f"ShardedTrainer({type(trainer.block).__name__})"
    resident = resident_bytes(trainer._resident() + list(batch))
    capacity = capacity_bytes(trainer.device)
    if capacity is None:
        check_budget(name, None, resident, capacity=None)
        return fn()
    aux = [trainer.block.get_parameter(n) for n in trainer._aux_names]
    saved = [a.detach().clone() for a in aux]
    out, peak = measure_peak(fn, trainer.device)
    try:
        check_budget(name, peak, resident, capacity=capacity)
    except MemoryBudgetError:
        with torch.no_grad():
            for a, s in zip(aux, saved):
                a.copy_(s)
        raise
    return out


def last_check():
    """The most recent budget check's accounting dict (None before
    any)."""
    with _lock:
        return dict(_last_check) if _last_check else None


def last_headroom_bytes():
    """Headroom recorded by the most recent budget check (None before
    any check, or when capacity was unknown)."""
    with _lock:
        return _last_check.get("headroom_bytes") if _last_check else None


# ---------------------------------------------------------------------------
# graduated remat policies
# ---------------------------------------------------------------------------

#: valid policies, in INCREASING memory savings (and recompute cost)
POLICIES = ("none", "dots_saveable", "layers", "full")

#: the oom_recover=auto escalation order (same tuple; alias for intent)
LADDER = POLICIES


def validate_policy(policy):
    if policy not in POLICIES:
        raise ValueError(
            f"remat policy {policy!r}: expected one of {POLICIES}")
    return policy


def effective_policy(explicit, legacy=False):
    """The policy of one block: an explicit `.remat(policy=...)` wins,
    else the `remat_policy` knob, else the model config's `remat` (a
    policy name, or True as the "layers" alias), else "none"."""
    if explicit:
        return validate_policy(explicit)
    knob = _config.get("remat_policy")
    if knob:
        return validate_policy(knob)
    if isinstance(legacy, str):
        return validate_policy(legacy)
    return "layers" if legacy else "none"


def _policy_block(block):
    """The first block of the subtree that consumes remat policies per
    layer (BERTModel, GPTModel), or None."""
    for m in block.modules():
        if getattr(type(m), "_remat_handles_policy", False):
            return m
    return None


def policy_marker(block):
    """The effective remat policy of a block tree."""
    b = _policy_block(block) or block
    return effective_policy(getattr(b, "_remat_policy", None),
                            getattr(b, "_remat", False))


def block_wrap_policy(block):
    """The policy to apply around a block's WHOLE forward (the generic
    wrap for blocks without per-layer handling), or None. A per-layer
    handler anywhere in the subtree owns the policy instead: wrapping the
    root too would checkpoint twice."""
    if _policy_block(block) is not None:
        return None
    pol = effective_policy(getattr(block, "_remat_policy", None), False)
    return None if pol == "none" else pol


# ---------------------------------------------------------------------------
# graceful OOM degradation (the ladder)
# ---------------------------------------------------------------------------

def _count_oom(kind, executable=None, step=None):
    global _oom_events
    with _lock:
        _oom_events += 1
    if _telemetry._enabled:
        _M_OOM_EVENTS.inc()
        _telemetry.event("oom", cause=kind, executable=executable, step=step)
    if _diagnostics._enabled:
        _diagnostics.record_event("oom", cause=kind, executable=executable,
                                  step=step)


def _release(exc):
    """Drop the locals of the frames an exception's traceback holds: a
    failed forward's activations must not stay alive through the retry."""
    traceback.clear_frames(exc.__traceback__)
    return exc


def _next_rung(trainer, data, labels):
    """The next degradation to try: the remat policy one rung up while
    possible, then (never on one device: there are no data replicas to
    shard optimizer state over) optimizer-state sharding, then gradient
    accumulation x2 while every batch array's leading dimension
    divides. None when the ladder is exhausted."""
    cur = policy_marker(trainer.block)
    if hasattr(trainer.block, "remat") and cur != LADDER[-1]:
        return ("remat", LADDER[LADDER.index(cur) + 1])
    new_accum = int(getattr(trainer, "_accum", 1)) * 2
    shapes = [tuple(getattr(b, "shape", ())) for b in
              list(data) + list(labels)]
    if shapes and new_accum <= 256 and all(
            s and s[0] % new_accum == 0 for s in shapes):
        return ("accum", new_accum)
    return None


def _note_transition(trainer, kind, value, step):
    entry = {"kind": kind, "value": value, "step": step, "ts": time.time(),
             "policy": policy_marker(trainer.block),
             "accum": int(getattr(trainer, "_accum", 1)), "zero": False}
    with _lock:
        _transitions.append(entry)
    what = f"remat policy -> {value!r}" if kind == "remat" else \
        f"gradient accumulation x{value} (microbatch = batch/{value})"
    print(f"mx.memsafe: degradation ladder at step {step}: {what}",
          file=sys.stderr)
    if _telemetry._enabled:
        _telemetry.event("memsafe", action=kind, value=value, step=step)
    if _diagnostics._enabled:
        _diagnostics.record_event("memsafe", action=kind, value=value,
                                  step=step)


def recover_trainer(trainer, exc, data, labels):
    """Walk the ladder after an OOM at the trainer step (called by
    `ShardedTrainer.step` outside its except block, with `exc`'s frames
    released; memsafe enabled and `is_oom(exc)` established). With
    `oom_recover` not "auto" the error propagates (fail-fast). An OOM
    after the optimizer began updating state in place
    (`trainer._state_touched`) cannot be retried and raises, as the JAX
    package raises when the failed dispatch consumed its donated state.
    Otherwise: apply the next rung, run the step again, and repeat until
    it completes or the ladder is exhausted (then `exc` propagates).
    `trainer._step_once` restores the random streams a failed attempt
    drew from, so a recovered step draws what an uninterrupted one would
    have."""
    step = int(trainer.num_update) + 1
    t_rung = time.perf_counter() if _goodput._enabled else None
    if not isinstance(exc, MemoryBudgetError):
        _count_oom("device", step=step)
    if _config.get("oom_recover") != "auto":
        raise exc
    while True:
        if getattr(trainer, "_state_touched", False):
            raise RuntimeError(
                "mx.memsafe: the out-of-memory came after the optimizer "
                "began updating the train state in place, so the step "
                "cannot be retried; restore from the last checkpoint") \
                from exc
        rung = _next_rung(trainer, data, labels)
        if rung is None:
            exc.add_note("mx.memsafe: degradation ladder exhausted (remat "
                         "at 'full', batch no longer divisible)")
            raise exc
        kind, value = rung
        if kind == "remat":
            trainer.block.remat(value)
        else:
            trainer.set_grad_accum(value)
        _note_transition(trainer, kind, value, step)
        if _goodput._enabled:
            # the ladder walk so far (failed attempt + re-plan) is
            # badput:oom_recovery, and so is the retried step below
            # (note_oom_begin re-categorizes its first-step interval)
            now = time.perf_counter()
            _goodput.note("oom_recovery", t_rung, now, step=step, rung=kind)
            t_rung = now
            _goodput.note_oom_begin(step)
        failed = None
        try:
            out = trainer._step_once(data, labels)
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_oom(e):
                raise
            failed = _release(e)
        if failed is None:
            if _telemetry._enabled:
                _M_OOM_RECOVERIES.inc()
            return out
        if not isinstance(failed, MemoryBudgetError):
            _count_oom("device", step=step)
        exc = failed


def note_eager_oom(exc, step=None):
    """Record an OOM of the eager `gluon.Trainer` (which cannot
    microbatch a tape that already ran) and annotate the exception with
    the remediation before it propagates."""
    _count_oom("device", step=step)
    exc.add_note(
        "mx.memsafe: eager-path OOM — the gluon Trainer cannot degrade a "
        "step whose tape already ran. Remat the model "
        "(block.remat(policy=...)), reduce the batch, or move to "
        "parallel.ShardedTrainer where oom_recover=auto walks the "
        "degradation ladder automatically.")


def transitions():
    """Degradation-ladder transitions recorded this process (copies)."""
    with _lock:
        return [dict(t) for t in _transitions]


def snapshot():
    """Plain-data summary: the last budget check, every ladder transition
    and the OOM event count."""
    with _lock:
        return {"oom_events": _oom_events,
                "last_check": dict(_last_check) if _last_check else None,
                "transitions": [dict(t) for t in _transitions]}


def oom_events():
    """Out-of-memory events seen at the trainer boundary this process."""
    return _oom_events
