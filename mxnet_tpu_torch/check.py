"""mx.check — graph and concurrency analysis (counterpart of
`mxnet_tpu/check.py`).

The JAX package lints the traced jaxpr of every fresh executable. The
port has no jaxpr: PyTorch runs eagerly and compiles nothing. So the
port keeps the rules and changes what they read. At each of the port's
cache-miss sites — a hybridized `Block`'s first call at a cache key,
`ShardedTrainer`'s first step at a signature, and the server's first
dispatch at a bucket — the call runs once under a recording dispatch
mode (`StepRecord`; with mx.inspect on, inspect's own bytes-counting
mode carries the recorder, so the call runs under one mode, never two),
and the rules read the recorded ATen ops. What each rule means here:

  * `large-constant` — a tensor an op of the recorded call reads that
    is none of: an argument, a parameter or buffer of the block (or the
    trainer's state), a value an op of the call produced. That is a
    closure-captured tensor (`torch.as_tensor(self._big)` in a forward),
    the port's counterpart of a constant baked into an executable. At
    or above `check_large_const_bytes`. The hand-written kernels launch
    through ctypes, where a dispatch mode sees no read: each wrapper
    reports its launch's tensors (`cuda_ops._build.tally`) and the
    recorder counts them as arguments of the op, so a kernel's operand
    is never taken for a captured constant.
  * `dtype-promotion` — an op that reads a bfloat16/float16 tensor and
    writes a float32/float64 one of at least
    `check_promotion_min_bytes`, in a block none of whose parameters is
    float32 or wider (the JAX package's `convert_element_type` rule;
    torch's promotion keeps a 0-d float32 tensor from upcasting a
    bfloat16 one, so the JAX rule's "non-weak scalar" case cannot
    occur, and what fires is an explicit cast or a product with a
    float32 tensor).
  * `donation-miss` — trainer or server state (parameters, optimizer
    state, caches) of at least `check_donation_min_bytes` that the
    recorded call replaced with a new allocation instead of updating in
    place: the storage pointers before and after the call differ. The
    port's step and decode update in place, and `ShardedTrainer`
    accepts `donate=False` without changing that, so the JAX package's
    `donate=False` finding has no port meaning and does not fire.
  * `retrace-hazard` — `note_signature` over the cache keys' shapes, as
    in the JAX package (one input axis seen at `check_retrace_limit`
    sizes, not a power-of-two bucket set). `note_scalar` is here, but
    no port site calls it: the learning rate is a host float argument
    of the kernels and the optimizer, never part of a step's signature,
    so changing it re-runs nothing.
  * `degenerate-sharding` — needs a data mesh of more than one device;
    the port trains on one, so it never fires.
  * `degenerate-paging` — `lint_paging`, as in the JAX package, at a
    `pages="on"` server's construction (the port refuses a drafter with
    another vocabulary at construction before the lint can see it).
  * `lock-order-cycle` and `unguarded-mutation` — the port's
    `_locklint` (tsan-lite under `MXNET_TPU_CHECK_THREADS=1`), as in the
    JAX package.

Findings surface as structured records (`tools/check_graph.py` reads the
`check_dir` dumps), the `check_findings_total{rule=...}` telemetry
counter and diagnostics ring events. The `check` knob is
`off|warn|error`: off (default) keeps every hook site at one module-bool
check, with no recording and no registry; warn reports; error raises
`CheckError` naming the rule, location and remediation, and the hook
site forgets the cache key, so the next call records and raises again.
Recording runs only at a cache miss: on the card it adds the dispatch
mode's host time to that one call and no synchronisation. The first
dispatch mode of a process also pays, once, for the modules torch
imports for it (seconds; mx.inspect's first count pays the same).
Suppress a finding with `with mx.check.suppress("rule"): ...`.
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import sys
import time

import torch

from . import _locklint
from . import config as _config
from . import diagnostics as _diagnostics
from . import telemetry as _telemetry
from ._locklint import (LockOrderError, make_lock, make_rlock,  # noqa: F401
                        guarded_dict)
from .util import fmt_bytes as _fmt_bytes  # shared with memsafe._fmt

__all__ = [
    "enable", "disable", "enabled", "maybe_enable", "reset",
    "CheckError", "RULES", "report_finding", "suppress",
    "check_jit", "check_step", "lint_jaxpr", "lint_paging",
    "note_signature", "StepRecord", "owner_token", "tensors_of",
    "note_scalar", "findings", "thread_findings", "snapshot", "dump",
    "make_lock", "make_rlock", "LockOrderError",
]

#: rule catalog — name -> one-line description (README + report CLI)
RULES = {
    "large-constant": "closure-captured tensor read by a recorded call "
                      "(not an argument, parameter, buffer or value made "
                      "in the call) at/above check_large_const_bytes",
    "donation-miss": "trainer or server state replaced with a new "
                     "allocation by the recorded call instead of updated "
                     "in place — the old and new buffers are both live",
    "dtype-promotion": "bf16/f16 -> f32/f64 upcast of a whole tensor "
                       "at/above check_promotion_min_bytes in a block "
                       "whose parameters are lower-precision",
    "retrace-hazard": "a signature component (input-shape axis or baked "
                      "python scalar) observed varying across "
                      "check_retrace_limit compiles — and predicted to "
                      "keep varying, one full recompile each",
    "degenerate-sharding": "large fully-replicated params or batch "
                           "inputs on a mesh whose data axes span >1 "
                           "device (every device holds the full array)",
    "degenerate-paging": "a pages=on server whose page size exceeds its "
                         "smallest bucket (prefix sharing can never "
                         "engage) or whose drafter's vocabulary differs "
                         "from the target's (speculative proposals are "
                         "meaningless token ids)",
    "lock-order-cycle": "two contexts acquire the same locks in opposite "
                        "orders (tsan-lite; reported with both "
                        "acquisition stacks)",
    "unguarded-mutation": "guarded shared structure mutated without "
                          "holding its lock (tsan-lite)",
}

_lock = make_rlock("check.registry")
_enabled = False              # the fast-path bool; hook sites read it directly
_findings = []                # finding dicts, append-only this process
_fired = set()                # (rule, dedupe-key) already reported
_sig_axis = {}                # (owner, name, input, axis, rest) -> set(values)
_sig_scalar = {}              # (owner, name, slot) -> set(values)
_SIG_CAP = 4096               # drop-oldest bound on the signature history
_suppressed = set()           # rules currently suppressed (suppress())
_owner_counter = itertools.count(1)

_M_FINDINGS = _telemetry.counter(
    "check_findings_total", "mx.check analysis findings, labeled by rule "
    "(the rules over recorded first calls at cache misses + tsan-lite "
    "concurrency findings)")


class CheckError(RuntimeError):
    """A finding under check=error. Carries the finding dict; the message
    names the rule, the location, and the remediation."""

    def __init__(self, finding):
        self.finding = dict(finding)
        super().__init__(
            f"mx.check [{finding['rule']}] at {finding['location']}: "
            f"{finding['message']} Remediation: {finding['remediation']} "
            "(suppress with `with mx.check.suppress("
            f"{finding['rule']!r}): ...`, relax the rule's threshold "
            "knob, or set check=warn)")


# ---------------------------------------------------------------------------
# enable / disable
# ---------------------------------------------------------------------------

def enabled():
    """True when graph lint is armed (hook sites read the module global
    `_enabled` directly — this accessor is the public spelling)."""
    return _enabled


def enable(mode=None):
    """Arm graph lint; `mode` ('warn'|'error') also sets the knob."""
    global _enabled
    if mode is not None:
        _config.set("check", mode)
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def maybe_enable():
    """Arm iff the `check` knob asks (construction-time config read only —
    the step hot path keeps its single module-bool check)."""
    if _enabled:
        return True
    if _config.get("check") != "off":
        enable()
    return _enabled


def reset():
    """Drop findings and signature history (tests and run boundaries);
    the lock-order graph resets through _locklint.reset()."""
    with _lock:
        del _findings[:]
        _fired.clear()
        _sig_axis.clear()
        _sig_scalar.clear()


def owner_token(obj):
    """A process-unique identity token for `obj`, assigned once and
    stored on the instance. Raw id() would be wrong here: CPython reuses
    addresses after GC, so a sweep loop constructing trainers would
    inherit dead instances' retrace histories (false hazards) or their
    dedupe entries (suppressed real ones)."""
    tok = getattr(obj, "_mx_check_token", None)
    if tok is None:
        tok = next(_owner_counter)
        try:
            obj._mx_check_token = tok
        except Exception:
            pass     # unsettable (slots): the token is still unique
    return tok


def _cap_history(d):
    """Drop-oldest bound (called under _lock): the signature history must
    not grow without limit in a long-lived process compiling many
    blocks — dict insertion order makes the first key the oldest."""
    while len(d) > _SIG_CAP:
        del d[next(iter(d))]


@contextlib.contextmanager
def suppress(*rules):
    """Inline suppression: findings for `rules` inside the block are
    dropped (not recorded, not raised). The README documents this as the
    per-call-site escape hatch; prefer fixing or re-thresholding."""
    with _lock:
        added = [r for r in rules if r not in _suppressed]
        _suppressed.update(added)
    try:
        yield
    finally:
        with _lock:
            _suppressed.difference_update(added)


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------

def report_finding(rule, location, message, remediation, dedupe=None,
                   **details):
    """Record one finding: registry + check_findings_total{rule=} +
    diagnostics ring + stderr (warn mode) or CheckError (error mode).
    `dedupe` bounds repeats: the same (rule, dedupe) RECORDS once — but
    under check=error every recurrence still raises (the hazard is still
    there; a dedupe that swallowed the raise would let the evicted-and-
    recompiled executable dispatch on retry). Returns the finding dict,
    or None when deduped (warn) / suppressed."""
    mode = _config.get("check")
    with _lock:
        if rule in _suppressed:
            return None
        fkey = (rule, dedupe if dedupe is not None else location)
        repeat = fkey in _fired
        finding = {"rule": rule, "location": location, "message": message,
                   "remediation": remediation, "ts": time.time()}
        if details:
            finding["details"] = details
        if repeat:
            if mode == "error":
                raise CheckError(finding)
            return None
        _fired.add(fkey)
        _findings.append(finding)
    if _telemetry._enabled:
        _M_FINDINGS.labels(rule=rule).inc()
        _telemetry.event("check", rule=rule, location=location,
                         message=message)
    if _diagnostics._enabled:
        _diagnostics.record_event("check", rule=rule, location=location,
                                  message=message)
    if mode == "error":
        _maybe_dump()
        raise CheckError(finding)
    print(f"mx.check: [{rule}] {location}: {message} — {remediation}",
          file=sys.stderr)
    _maybe_dump()
    return finding


def findings(rule=None):
    """Graph-lint findings recorded this process (copies)."""
    with _lock:
        out = [dict(f) for f in _findings]
    return [f for f in out if rule is None or f["rule"] == rule]


def thread_findings():
    """Concurrency findings from the tsan-lite lock layer (cycles +
    unguarded mutations), as finding dicts in the same shape."""
    out = []
    for f in _locklint.findings():
        rule = f.get("rule", "lock-order-cycle")
        if rule == "unguarded-mutation":
            location = f.get("structure", "?")
            remediation = (f"take the guard lock "
                           f"'{f.get('guard', '?')}' around the "
                           "mutation (every other mutation site of this "
                           "structure already does)")
        else:
            locks = f.get("locks")
            location = ",".join(locks) if isinstance(locks, list) \
                else str(f.get("lock", "?"))
            remediation = ("make the acquisition order consistent (or "
                           "drop to one lock); for signal paths, set a "
                           "flag and do the work on the main loop")
        out.append({
            "rule": rule,
            "location": location,
            "message": f.get("message", ""),
            "remediation": remediation,
            "details": {k: v for k, v in f.items()
                        if k not in ("rule", "message")},
        })
    return out


# ---------------------------------------------------------------------------
# the recorded call (the port's jaxpr)
# ---------------------------------------------------------------------------

_SMALL_FLOATS = ("bfloat16", "float16")
_BIG_FLOATS = ("float32", "float64")
# ops whose input is a freshly built host value, not a read of state:
# `torch.tensor(data)` dispatches lift_fresh on the new tensor
_FRESH = ("lift_fresh", "lift_fresh_copy")


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _storage(t):
    try:
        return t.untyped_storage().data_ptr()
    except Exception:
        return None


class StepRecord:
    """What one call did, op by op: the port's stand-in for a traced
    jaxpr. Built with the tensors the call may read without their being
    constants (`known`: arguments, parameters, buffers, trainer state)
    and the state it should update in place (`state`); `run(fn)` runs
    the call under inspect's recording dispatch mode with this record as
    its observer (or inspect's `count_step` does, when inspect is on).
    The record keeps the captured constants it saw (storage -> (nbytes,
    dtype, shape)), the bf16/f16 -> f32/f64 upcasts (src, dst, shape,
    nbytes) and, after `finish()`, the state tensors whose storage the
    call replaced."""

    def __init__(self, known=(), state=()):
        self.known = {p for p in (_storage(t) for t in known
                                  if isinstance(t, torch.Tensor))
                      if p is not None}
        self.made = set()
        self.consts = {}
        self.upcasts = []
        self._state = [t for t in state if isinstance(t, torch.Tensor)]
        self._before = [_storage(t) for t in self._state]
        self.replaced = []

    @staticmethod
    def _tensors(tree):
        return [t for t in torch.utils._pytree.tree_leaves(tree)
                if isinstance(t, torch.Tensor)]

    def note_launch(self, tensors):
        """A kernel launch's tensors (reported by the wrapper): arguments
        of the op, never captured constants."""
        for t in tensors:
            if isinstance(t, torch.Tensor):
                p = _storage(t)
                if p is not None:
                    self.known.add(p)

    def __call__(self, func, args, kwargs, out):
        ins = self._tensors((args, kwargs))
        outs = self._tensors(out)
        name = func.__name__.split(".")[0]
        if name in _FRESH:
            for t in ins:
                self.made.add(_storage(t))
        for t in ins:
            p = _storage(t)
            if p is None or p in self.known or p in self.made:
                continue
            if t.device.type == "meta":
                continue
            nbytes = t.untyped_storage().nbytes()
            prev = self.consts.get(p)
            if prev is None or prev[0] < nbytes:
                self.consts[p] = (nbytes, _dtype_name(t), tuple(t.shape))
        for t in outs:
            p = _storage(t)
            if p is not None:
                self.made.add(p)
        small = [t for t in ins if t.is_floating_point()
                 and _dtype_name(t) in _SMALL_FLOATS]
        if small:
            for t in outs:
                if t.is_floating_point() and _dtype_name(t) in _BIG_FLOATS:
                    self.upcasts.append(
                        (_dtype_name(small[0]), _dtype_name(t),
                         tuple(t.shape), t.numel() * t.element_size()))

    def run(self, fn):
        """fn() under the recording mode; returns fn's result."""
        from . import inspect as _inspect
        from .cuda_ops import _build
        prev, _build.launch_observer = _build.launch_observer, \
            self.note_launch
        try:
            with _inspect._BytesMode(observer=self):
                return fn()
        finally:
            _build.launch_observer = prev

    def finish(self):
        """After the call: which `state` tensors now live in another
        storage (the call replaced them instead of updating in place)."""
        self.replaced = [
            (t, b) for t, b in zip(self._state, self._before)
            if _storage(t) != b]
        return self


def tensors_of(obj):
    """The tensors among `obj`'s attributes, also inside tuples, lists and
    dicts (one level deep): what a hook site passes as `known` for a
    helper object that holds tensors of its own (FusedLamb's row tables,
    built once and read by every step)."""
    out = []
    for v in vars(obj).values():
        items = v.values() if isinstance(v, dict) else \
            v if isinstance(v, (tuple, list)) else (v,)
        for x in items:
            xs = x if isinstance(x, (tuple, list)) else (x,)
            out.extend(t for t in xs if isinstance(t, torch.Tensor))
    return out


# ---------------------------------------------------------------------------
# rules over a recorded call
# ---------------------------------------------------------------------------

def lint_jaxpr(name, record, low_precision=True, can_donate=False):
    """The rules over one recorded call (the JAX package's jaxpr walk;
    the name is kept): captured constants, upcasts — when
    `low_precision`, the block holding no float32-or-wider parameter —
    and, at call sites that update state (`can_donate`: the trainer
    step, the server's dispatch), state replaced by a new allocation."""
    if record is None:
        return
    const_thresh = int(_config.get("check_large_const_bytes"))
    promo_thresh = int(_config.get("check_promotion_min_bytes"))
    donate_thresh = int(_config.get("check_donation_min_bytes")) \
        if can_donate else 0
    if const_thresh > 0:
        for nbytes, dtype, shape in record.consts.values():
            if nbytes >= const_thresh:
                report_finding(
                    "large-constant", name,
                    f"a {_fmt_bytes(nbytes)} {dtype} tensor of shape "
                    f"{shape} is read by the call but is not an "
                    "argument, a parameter or buffer, or a value the call "
                    "made: a closure-captured constant, held outside "
                    "every parameter list (never saved, moved or "
                    "donated with the model).",
                    "pass the tensor as an argument (register it as a "
                    "Parameter with grad_req='null', or thread it "
                    "through the call), or shrink it below the "
                    "check_large_const_bytes knob",
                    dedupe=(name, "const", shape, dtype), nbytes=nbytes)
    if promo_thresh > 0 and low_precision:
        for src, dst, shape, nbytes in record.upcasts:
            if nbytes >= promo_thresh:
                report_finding(
                    "dtype-promotion", name,
                    f"a {src} tensor of shape {shape} is upcast to {dst} "
                    f"({_fmt_bytes(nbytes)} after the upcast) inside the "
                    "call of a lower-precision block — the rest of the "
                    f"path then runs at {dst} bandwidth.",
                    "keep the operands in the block's dtype (python "
                    "scalars, or an explicit .astype at the intended "
                    "boundary); raise check_promotion_min_bytes if this "
                    "upcast is deliberate",
                    dedupe=(name, "promo", shape, src, dst),
                    nbytes=nbytes, src=src, dst=dst)
    if donate_thresh > 0:
        hits = [(tuple(t.shape), _dtype_name(t),
                 t.numel() * t.element_size())
                for t, _ in record.replaced]
        hits = [h for h in hits if h[2] >= donate_thresh]
        if hits:
            total = sum(h[2] for h in hits)
            shapes = ", ".join(f"{s}/{d} ({_fmt_bytes(n)})"
                               for s, d, n in hits[:4])
            more = f" (+{len(hits) - 4} more)" if len(hits) > 4 else ""
            report_finding(
                "donation-miss", name,
                f"{len(hits)} state buffer(s) totalling {_fmt_bytes(total)} "
                f"were replaced by new allocations ({shapes}{more}) "
                "instead of updated in place: old and new state are live "
                "together during the call.",
                "update the state in place (copy_ / the in-place optimizer "
                "kernels), or stop holding the old buffers",
                dedupe=(name, "donate"), nbytes=total, n_buffers=len(hits))


def _low_precision(params):
    """True when no floating parameter is float32 or wider (vacuously for
    a block without parameters)."""
    return not any(p.is_floating_point()
                   and _dtype_name(p) in _BIG_FLOATS for p in params)


def note_signature(name, shapes, owner=None):
    """Record one compile signature and fire `retrace-hazard` when ONE
    axis of one input has taken `check_retrace_limit` distinct values
    with everything else fixed: each value is a full recompile and the
    axis is predicted to keep varying (the BEFORE-the-fact complement of
    telemetry's recompile-cause diff). `owner` is the INSTANCE identity
    (the hook sites pass id(block)/id(trainer)): two blocks of the same
    class each compiling once must not pool into one false hazard —
    only one cache re-jitting is a hazard."""
    limit = int(_config.get("check_retrace_limit"))
    if limit <= 0:
        return
    owner = owner if owner is not None else name
    shapes = tuple(tuple(s) for s in shapes)
    with _lock:
        for i, shape in enumerate(shapes):
            for ax, val in enumerate(shape):
                rest = (shapes[:i],
                        shape[:ax] + ("*",) + shape[ax + 1:],
                        shapes[i + 1:])
                key = (owner, name, i, ax, rest)
                seen = _sig_axis.setdefault(key, set())
                seen.add(val)
                _cap_history(_sig_axis)
                if len(seen) >= limit and not _looks_bucketed(seen):
                    vals = sorted(seen)
                    report_finding(
                        "retrace-hazard", name,
                        f"input[{i}] axis {ax} has compiled at "
                        f"{len(seen)} distinct sizes "
                        f"({vals[:6]}{'...' if len(vals) > 6 else ''}) "
                        "with every other signature component fixed — "
                        "each new size is a new cache key (a full "
                        "recompile in the JAX package; first-call work "
                        "and memory here), and this axis is predicted to "
                        "keep varying (varlen inputs).",
                        "bucket the axis with dataflow.BucketPad (bounded "
                        "executable count, padding overhead visible in "
                        "bucket_pad_waste_ratio) or pad to a fixed shape",
                        dedupe=(owner, name, "axis", i, ax),
                        input=i, axis=ax, sizes=vals[:16])


def _looks_bucketed(values):
    """True when every observed axis size is a power of two at or above
    the bucket_pad_min floor — the exact output of dataflow.BucketPad's
    default policy. A stream that FOLLOWED the retrace-hazard remediation
    must not keep tripping the rule: its executable count is bounded by
    the bucket set, which is the point. Explicit non-pow2 bucket lists
    are rarer; suppress() or a higher check_retrace_limit covers them."""
    try:
        floor = max(1, int(_config.get("bucket_pad_min")))
    except Exception:
        floor = 1
    return all(isinstance(v, int) and v >= floor and v > 0
               and (v & (v - 1)) == 0 for v in values)


def note_scalar(name, slot, value, owner=None):
    """Record one baked-scalar signature component (e.g. the in-jit lr
    key) and fire `retrace-hazard` once it has taken
    `check_retrace_limit` distinct values: the python scalar is baked
    into the executable, so every new value re-jits. `owner` is the
    instance identity, like note_signature's. Kept for the JAX package's
    surface: no port site calls it (the learning rate is no part of a
    port signature)."""
    limit = int(_config.get("check_retrace_limit"))
    if limit <= 0 or value is None:
        return
    owner = owner if owner is not None else name
    with _lock:
        try:
            seen = _sig_scalar.setdefault((owner, name, slot), set())
            seen.add(value)
        except TypeError:
            return      # unhashable component: nothing to track
        _cap_history(_sig_scalar)
        n = len(seen)
    if n >= limit:
        report_finding(
            "retrace-hazard", name,
            f"python-scalar signature component '{slot}' has compiled at "
            f"{n} distinct values — the scalar is baked into the "
            "executable (a mutated learning rate / schedule "
            "hyperparameter), so every new value is a full re-jit.",
            "move the scalar into the computation (a traceable "
            "lr_scheduler computes lr IN-jit; see "
            "FunctionalOptimizer.lr_traced) or stop mutating it per step",
            dedupe=(owner, name, "scalar", slot), slot=slot, values=n)


# ---------------------------------------------------------------------------
# hook entry points (gluon/block.py, parallel/trainer.py, serve.py)
# ---------------------------------------------------------------------------

def check_jit(name, key, record, owner=None, params=(), can_donate=False):
    """The rules over one hybridized block's (or one server bucket's)
    recorded first call at cache key `key`. CheckError (check=error)
    propagates to the caller, which forgets the key. `owner`: the
    instance's identity for the retrace history; `params`: the block's
    parameters (the dtype-promotion condition); `can_donate`: True at
    sites whose state must be updated in place (the server)."""
    lint_jaxpr(name, record.finish(),
               low_precision=_low_precision(params), can_donate=can_donate)
    # signature history uses the CACHE KEY's shape component — the stable
    # spelling of what a new key costs
    if isinstance(key, tuple) and key and isinstance(key[0], tuple):
        note_signature(name, [tuple(s) for s, _ in key[0]
                              if isinstance(s, tuple)], owner=owner)
    return True


def check_step(trainer, key, record, batch=()):
    """The rules over ShardedTrainer's recorded first step at signature
    `key`: constants, upcasts, state replaced instead of updated in
    place, sharding (none on one device) and the shape signature. The
    learning rate is no part of the port's signature (see the module
    docstring), so no scalar is noted."""
    name = f"ShardedTrainer({type(trainer.block).__name__})"
    params = trainer.params if isinstance(trainer.params, (list, tuple)) \
        else list(trainer.block.parameters())
    lint_jaxpr(name, record.finish(), low_precision=_low_precision(params),
               can_donate=True)
    _lint_sharding(trainer, name, key, batch)
    if isinstance(key, tuple) and len(key) > 2:
        note_signature(name, key[2], owner=owner_token(trainer))
    return True


def _lint_sharding(trainer, name, key, batch):
    """Degenerate sharding: on a mesh whose data axes span >1 device,
    large fully-replicated trained params (every device holds and
    updates the full array — the mx.zero gap) or fully-replicated batch
    inputs (every device receives the full batch: the implicit
    all-gather a sharded step should never contain)."""
    thresh = int(_config.get("check_replicated_min_bytes"))
    if thresh <= 0:
        return
    mesh = getattr(trainer, "mesh", None)
    if mesh is None:
        return
    try:
        extent = int(mesh.shape.get("dp", 1)) * \
            int(mesh.shape.get("fsdp", 1))
    except Exception:
        return
    if extent <= 1:
        return
    if getattr(trainer, "param_mode", "replicate") == "replicate" \
            and not getattr(trainer, "_zero", False):
        # a zero'd trainer already shards its optimizer state and updates
        # per-shard (reduce-scatter/all-gather weight update) — exactly
        # the remediation this finding names, so it goes quiet
        from . import memsafe as _memsafe
        pbytes = int(_memsafe.resident_bytes(
            (trainer.params, trainer.opt_state)))
        if pbytes >= thresh:
            report_finding(
                "degenerate-sharding", name,
                f"params + optimizer state ({_fmt_bytes(pbytes)}) are "
                f"fully replicated across {extent} data-parallel "
                "devices: every device holds and updates the complete "
                "train state.",
                "set zero='auto' (mx.zero: shard optimizer state across "
                "the data replicas with a reduce-scatter/all-gather "
                "weight update — resident opt-state bytes /= data "
                "extent, values unchanged), or param_mode='fsdp' to "
                "shard params + optimizer state over the data axes; "
                "raise check_replicated_min_bytes if this model is "
                "small enough to replicate deliberately",
                dedupe=(name, "replicated-params"),
                nbytes=pbytes, devices=extent)
    # batch inputs: re-derive the shardings the step will use
    try:
        n_data, n_label, shapes = int(key[0]), int(key[1]), key[2]
        shardings = trainer._batch_shardings(n_data, n_label, shapes)
    except Exception:
        return
    for i, (sh, arr) in enumerate(zip(shardings, batch or ())):
        spec = getattr(sh, "spec", None)
        axes = set()
        for entry in (spec or ()):
            if entry is None:
                continue
            axes.update(entry if isinstance(entry, tuple) else (entry,))
        nbytes = int(getattr(arr, "nbytes", 0) or 0)
        if not axes and nbytes >= thresh:
            report_finding(
                "degenerate-sharding", name,
                f"batch input[{i}] ({_fmt_bytes(nbytes)}, shape "
                f"{tuple(getattr(arr, 'shape', ()))}) is fully "
                f"replicated across the {extent}-device data mesh: "
                "every device receives and stages the whole array.",
                "give the input a sharded PartitionSpec via "
                "data_specs/label_specs (batch axis on the data axes), "
                "or raise check_replicated_min_bytes for genuinely "
                "replicated inputs (lookup tables)",
                dedupe=(name, "replicated-batch", i),
                input=i, nbytes=nbytes, devices=extent)


def lint_paging(location, page_size, min_bucket, target_vocab,
                drafter_vocab=None):
    """Degenerate paging configuration lint, run once at pages=on
    Server construction (mirrors `degenerate-sharding`: a setup that
    silently voids the feature's benefit rather than crashing).

    Two shapes: (1) a page size larger than the smallest bucket — every
    short request rounds its bucket UP to one page, prompts shorter
    than a page never produce a full (shareable) block, and the prefix
    tree can never engage for exactly the traffic paging targets;
    (2) a speculative drafter whose vocabulary differs from the
    target's — its argmax proposals index a different token space, so
    every verify round rejects at the first token and the extra
    dispatches are pure overhead (or worse: out-of-range ids)."""
    if not _enabled:
        return
    if int(page_size) > int(min_bucket):
        report_finding(
            "degenerate-paging", location,
            f"pages_page_size {page_size} exceeds the smallest serve "
            f"bucket {min_bucket}: every request shorter than a page "
            "rounds up to a full page and never yields a sharable "
            "prefix block — the prefix tree cannot engage for short "
            "traffic.",
            "lower pages_page_size to at most the smallest bucket (a "
            "divisor of the common bucket sizes keeps tables dense), "
            "or raise bucket_pad_min/serve_buckets so the smallest "
            "bucket covers at least one page",
            dedupe=(location, "page-size"),
            page_size=int(page_size), min_bucket=int(min_bucket))
    if drafter_vocab is not None \
            and int(drafter_vocab) != int(target_vocab):
        report_finding(
            "degenerate-paging", location,
            f"speculative drafter vocabulary ({drafter_vocab}) differs "
            f"from the target's ({target_vocab}): draft proposals "
            "index a different token space, so exact-acceptance "
            "verification rejects every round and speculative decoding "
            "only adds dispatches.",
            "use a drafter trained on the same tokenizer/vocabulary as "
            "the target model, or detach the drafter "
            "(Server(drafter=None))",
            dedupe=(location, "drafter-vocab"),
            target_vocab=int(target_vocab),
            drafter_vocab=int(drafter_vocab))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def snapshot():
    """All findings (graph + concurrency) as plain data — what dump()
    writes and tools/check_graph.py renders."""
    by_rule = {}
    all_f = findings() + thread_findings()
    for f in all_f:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    return {
        "mode": _config.get("check"),
        "tsan": _locklint.armed(),
        "counts": by_rule,
        "findings": all_f,
        "lock_graph_edges": len(_locklint.lock_graph()),
    }


def _default_dump_path():
    d = _config.get("check_dir")
    if not d:
        return None
    return os.path.join(d, str(_diagnostics._rank()), "check.json")


def dump(path=None):
    """Write snapshot() as JSON to `path` (default:
    check_dir/<rank>/check.json — what tools/check_graph.py reads).
    Returns the path, or None when there is no target."""
    path = path or _default_dump_path()
    if not path:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(snapshot(), f, default=str)
    os.replace(tmp, path)   # readers never see a torn file
    return path


def _maybe_dump():
    """Refresh the check_dir dump after a new finding (findings are rare;
    failures are swallowed — analysis must never kill the step)."""
    if not _config.get("check_dir"):
        return
    try:
        dump()
    except OSError:
        pass


@atexit.register
def _dump_at_exit():
    if not _enabled or not _config.get("check_dir"):
        return
    try:
        dump()
    except OSError:
        pass


if _config.get("check") != "off":
    enable()
