"""ShardedTrainer: the train step on one device (counterpart of
`mxnet_tpu/parallel/trainer.py`).

The JAX package jits forward, loss, backward and optimizer into one
computation over a mesh. The port runs the same step eagerly on one
device, on one of two paths, as the JAX package chooses them:
  * LAMB, in its fused flat-master form (`FusedLamb`, the JAX package's
    path for LAMB in 'replicate' mode): the parameters live as one flat
    float32 master; each step runs the block in training mode on
    `unflatten(master)` through `torch.func.functional_call`, so autograd
    delivers the gradient already flat in float32, and `apply_flat`
    updates master and moments in place;
  * SGD, NAG, Adam and AdamW, per parameter: the trainer holds its own
    detached copies of the trainable parameters in the model dtype (as
    the JAX trainer keeps `params` apart from the block until
    `sync_to_block`) and the optimizer's float32 state for each; each
    step runs the block on those copies through `functional_call`,
    `torch.autograd.grad` returns one gradient per parameter in its
    dtype, and `FunctionalOptimizer.apply` updates copies and state in
    place.
The step counter goes up first; the bias-correction constants and the
learning rate are host floats.

The async half, as in the JAX package: `step_async` is `step` without
the periodic fence that the `trainer_async_fence_every` knob asks of
`step` (`_fence`, which waits on the trainer's current stream and counts
in `fences`); `_t_dev` is the step counter as a 0-d int32 tensor on the
trainer's device, advanced only by a completed step (a failed one
leaves it equal to `num_update`) and re-seeded by `load_states`;
`_batch_shardings` gives the trainer's device for every leaf of a batch
(what `dataflow.prefetch_to_mesh` stages to); `_step_cache` holds the
step signatures seen (the JAX package's jit cache keys, with no
executable). `predict_step_bytes` is the memory plan `dataflow.autofit`
searches over: one measured forward and backward at the batch's shapes,
with nothing updated (the JAX package analyses the compiled step
instead).

The user's boundary is the JAX package's: `loss_fn` gets the model's
outputs and the labels as NDArrays and may return an NDArray (or a
tensor), and `step` takes NDArrays, tensors or numpy arrays and returns
the loss as an NDArray holding the 0-d float32 tensor, without waiting
for the card. So a `loss_fn` written for the JAX package, as
`nd.ctc_loss(...).mean()` in `examples/ocr/train_crnn.py`, runs
unchanged, and `step(...).asscalar()` reads the loss.

Parameters with grad_req 'null' (BatchNorm's running statistics) stay
out of training: `functional_call` leaves them the block's own tensors,
and a training forward updates them in place, so they carry from step
to step as the JAX trainer's aux state does. A block whose parameters
still wait for their shapes gets them from one evaluation-mode forward
on the first step's batch (the probe pass) before the trainer collects
its parameters. `set_grad_accum(n)` splits every batch into n equal
microbatches: their gradients are summed and divided by n, the loss is
the mean of theirs, BatchNorm statistics chain through them and each
draws its own dropout.

LAMB's moments are stored in the `lamb_moments_dtype` knob's dtype
(float32 by default, or bfloat16: `FusedLamb`), read when the trainer
collects its parameters.

Checkpoints (the JAX package's `_state_pytree` layout, per tensor):
`save_states(directory)` writes the float32 master (or, on the
per-parameter path, each parameter in its dtype), the optimizer state of
each tensor (LAMB's m and v in their storage dtype), the aux tensors
(BatchNorm's running statistics), `num_update` and the state of the
port's random streams (`random.get_state`: the host stream that seeds
every flash-dropout Philox mask and each device stream), so a restored
trainer's next step equals an uninterrupted one's bit for bit. The JAX
package writes this with orbax, which the port cannot read or write: the
port's payload is one `torch.save` file of CPU tensors, `state.pt`,
read back with `weights_only=True`. On the card every resident tensor
is copied into pinned host buffers the trainer keeps (one a dtype), with
one sync.
While `resilience` is enabled the write goes through
`resilience.write_checkpoint` (temp directory, manifest with sizes and
CRC32, atomic rename) and `load_states` verifies checksums and the
fingerprint first. `load_states` copies the tensors back into the
resident flat layout in place. `save_checkpoint(prefix)` writes the
parameters to `prefix.params` (`Block.save_parameters`).

Hooks, as in the JAX package's step: with memsafe armed (`oom_recover`
or `device_bytes_limit` set) the first step at a signature is checked
against the capacity between its backward and its update
(`memsafe.preflight_step`), and an out-of-memory (or the check's
MemoryBudgetError) raised before the
optimizer touched any state walks the degradation ladder
(`memsafe.recover_trainer`), the failed attempt's frames released and
its random draws rewound; with resilience enabled the `oom` fault fires
at the step's dispatch (`fault_point("dispatch")`), `on_step` runs
after the update (periodic checkpoint, fault injection, preemption
exit), and construction auto-resumes under the `resume` knob
(`on_trainer_init`). A block whose remat policy no layer structure
consumes (`memsafe.block_wrap_policy`) runs its whole forward under that
policy's checkpoint.

Observers, as in the JAX package's step, each behind one module bool
(with all of them off a step creates no event, thread or fence):
telemetry (`trainer_step_seconds`, a `step` event; at a new signature
`compile_total`, `recompile_total`, `compile_seconds` and a compile or
recompile event with the signature diff), trace (spans `step.compile`
at a new signature, else `step.dispatch` and `step.fence`, the sampled
step inside an "mx.trace.step" profiler range, the skew probe),
diagnostics (the flight-ring record, the watchdog's scope) and the
`nan_sentinel` knob (the loss fetched and checked; NonFiniteError after
a post-mortem), and inspect (the first step at a signature counted by
`inspect.count_step`, later ones timed). PyTorch compiles nothing: "a
new signature" is the first step at a batch shape, grad-accumulation
factor and remat policy, the probe pass included. Where the JAX package
fences (telemetry, the sentinel, inspect, a traced step; not
diagnostics alone), the step records a CUDA event pair on the current
stream around its work and waits on the second: the step time is the
events' elapsed time on the card, the host clock on the CPU.

The constructor is the JAX package's: `optimizer` defaults to "sgd";
`donate` is accepted and changes nothing (the step updates in place);
`data_specs` and `label_specs` are accepted when they are None or hold
only None (the default batch layout). Single device and
`param_mode="replicate"` only: meshes, fsdp/tp modes, sharding specs and
zero are not in the port yet, and ask for ROADMAP.md queue 1's
"Multi-device".

The operations layer, as in the JAX package: construction arms check,
guard and scope when their knobs ask (`maybe_enable`); goodput accounts
each completed step (`compile` for the first step at a signature,
`replay` at or below the step-id high-water mark, else `step`; it fences
as telemetry does); guard beats at the dispatch (suspending its
deadline across a first step at a new signature) and after the step
(then the SDC digest vote every `sdc_check_every` steps), after
resilience's hook, so a `corrupt_grad` fault of that step is voted on
at once; scope stamps the completed step and drives an armed
/profilez capture at the boundary. With check on, the first step at a
signature runs under `check.StepRecord` (inside inspect's counting
pass when inspect is on too: one dispatch mode) and `check.check_step`
lints it; under check=error the signature is forgotten, so the next
step records and raises again (the step itself has run: the port
records a call by running it).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.func import functional_call

from .. import check as _check
from .. import config as _config
from .. import context
from .. import diagnostics as _diagnostics
from .. import goodput as _goodput
from .. import guard as _guard
from .. import inspect as _inspect
from .. import memsafe as _memsafe
from .. import optimizer as opt_mod
from .. import random as _random
from .. import resilience as _resilience
from .. import scope as _scope
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..models import _remat
from ..ndarray.ndarray import NDArray
from .functional_opt import FunctionalOptimizer
from .fused_lamb import FusedLamb

_STATE_FILE = "state.pt"
_STATE_FORMAT = "mxnet_tpu_torch.ShardedTrainer/1"

__all__ = ["ShardedTrainer", "call_loss"]

# reusable do-nothing context for the unsampled/disabled trace path
_NULLCTX = contextlib.nullcontext()

# shared, framework-wide series (get-or-create: the same objects the
# hybridized blocks and the gluon Trainer register)
_M_COMPILES = _telemetry.counter("compile_total")
_M_RECOMPILES = _telemetry.counter("recompile_total")
_M_COMPILE_SECONDS = _telemetry.histogram("compile_seconds")
_M_STEP_SECONDS = _telemetry.histogram("trainer_step_seconds")


def call_loss(loss_fn, outs, labels):
    """The user loss over the model outputs and labels, given as
    NDArrays as the JAX package gives them, reduced to its float32 mean
    (a scalar loss stays itself) as a tensor."""
    loss = loss_fn(*[NDArray(o) for o in outs],
                   *[NDArray(y) for y in labels])
    if isinstance(loss, NDArray):
        loss = loss._t
    return loss.float().mean()


@contextlib.contextmanager
def _zip_crc32(on):
    """torch.save with (default) or without the CRC32 of each zip record,
    where this torch has the switch."""
    try:
        from torch.utils.serialization import config as ser
    except ImportError:
        ser = None
    if on or ser is None:
        yield
        return
    prev, ser.save.compute_crc32 = ser.save.compute_crc32, False
    try:
        yield
    finally:
        ser.save.compute_crc32 = prev


def _as_tensor(x, device):
    if isinstance(x, NDArray):
        x = x._t
    elif isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class ShardedTrainer:
    def __init__(self, block, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_mode="replicate", donate=True,
                 data_specs=None, label_specs=None, device=None):
        specs = list(data_specs or []) + list(label_specs or [])
        if mesh is not None or param_mode != "replicate" or any(
                s is not None for s in specs):
            raise NotImplementedError(
                "the port trains on one device: meshes, sharded param "
                "modes and sharding specs are not in it yet (ROADMAP.md "
                "queue 1, \"Multi-device\")")
        self.device = context.resolve(device)
        self.block = block
        self.loss_fn = loss_fn
        self.param_mode = param_mode
        self._opt = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.num_update = 0
        self._accum = 1
        self._ready = False
        self._state_touched = False
        self._host_bufs = {}            # dtype -> pinned host buffer
        # the step signatures seen (the JAX package's jit cache keys)
        self._step_cache = set()
        # the step counter on the device: advanced only by a completed
        # step, re-seeded by load_states
        self._t_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self.fences = 0                 # trainer_async_fence_every fences
        # the JAX package's flag for a learning rate computed inside the
        # jitted step: the port's learning rate is always a host float
        self._lr_inside = False
        self._observer_fenced = False   # the last step fenced for observers
        self._tele_sig = None           # last new signature (telemetry)
        # construction-time knob reads only: the step keeps one module
        # bool a subsystem
        _memsafe.maybe_enable()
        _check.maybe_enable()
        _guard.maybe_enable()
        _scope.maybe_enable()
        if not any(getattr(p, "mx_deferred", False)
                   for p in block.parameters()):
            self._setup()
        if _resilience._enabled:
            _resilience.on_trainer_init(self)

    def _setup(self):
        block = self.block
        params = [(n, p) for n, p in block.named_parameters()
                  if getattr(p, "grad_req", "write") != "null"]
        for name, p in params:
            if p.device != self.device:
                raise ValueError(f"ShardedTrainer: parameter {name} is on "
                                 f"{p.device}, the trainer on {self.device}")
        self._names = [n for n, _ in params]
        self._aux_names = [n for n, p in block.named_parameters()
                           if getattr(p, "grad_req", "write") == "null"]
        self.fopt = FunctionalOptimizer(self._opt, self._names)
        o = self.fopt.opt
        if self.fopt.kind != "lamb":
            self._fl = None
            self.params = [p.detach().clone() for _, p in params]
            self.opt_state = self.fopt.init(self.params)
            self._ready = True
            return
        self._fl = FusedLamb(
            [p.shape for _, p in params], [p.dtype for _, p in params],
            [self.fopt._wd_for(i) for i in range(len(params))],
            o.beta1, o.beta2, o.epsilon, o.bias_correction, o.rescale_grad,
            o.clip_gradient or -1.0, o.lower_bound or -1.0,
            o.upper_bound or -1.0,
            moments_dtype=_config.get("lamb_moments_dtype"))
        self.params = self._fl.flatten([p for _, p in params])
        self.opt_state = self._fl.zeros_moments(self.device)
        self._ready = True

    def _finish_setup(self, data):
        """The probe pass: one evaluation-mode forward on `data` with no
        gradient gives the deferred parameters their shapes (filling
        them as `initialize` asked); then the trainer collects them."""
        was_training = self.block.training
        self.block.eval()
        try:
            with torch.no_grad():
                self.block(*data)
        finally:
            self.block.train(was_training)
        self._setup()

    def set_grad_accum(self, accum):
        """Split every later step's batch into `accum` equal microbatches
        (every data and label array's leading dimension must divide by
        it), summing their gradients: activation memory is one
        microbatch's."""
        accum = int(accum)
        if accum < 1:
            raise ValueError(f"grad accumulation factor must be >= 1, "
                             f"got {accum}")
        self._accum = accum
        return self

    def _batch_shardings(self, n_data, n_label, shapes):
        """Where each leaf of a `(data, labels)` batch goes (the JAX
        package's shardings): the trainer's device, for every leaf."""
        return [self.device] * (n_data + n_label)

    def step(self, data, labels):
        """One train step on a batch: `data` and `labels` are NDArrays,
        tensors or numpy arrays (or lists of them), moved to the
        trainer's device. Returns the float32 loss: an NDArray of a 0-d
        tensor, not synchronised. The `trainer_async_fence_every` knob
        adds a fence every N steps (`_fence`) to bound how far dispatch
        runs ahead of the card."""
        loss = self._step_outer(data, labels)
        every = int(_config.get("trainer_async_fence_every") or 0)
        if every and not self._observer_fenced \
                and self.num_update % every == 0:
            self._fence()
        return loss

    def step_async(self, data, labels):
        """`step` without the periodic fence: nothing waits for the card
        until the loss is read (`.asscalar()`, `asnumpy()`) or an
        observer that fences (telemetry, nan_sentinel) is on. Pair it
        with `dataflow.prefetch_to_mesh`, so that neither the batch's
        copy to the card nor host bookkeeping sits between two steps."""
        return self._step_outer(data, labels)

    def _fence(self):
        """The periodic fence of `step`: wait for the work queued on the
        trainer's current stream (nothing to wait for on the CPU); each
        call counts in `fences`."""
        self.fences += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _step_outer(self, data, labels):
        data = data if isinstance(data, (list, tuple)) else [data]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        data = [_as_tensor(x, self.device) for x in data]
        labels = [_as_tensor(x, self.device) for x in labels]
        failed = None
        try:
            loss = self._step_once(data, labels)
        except Exception as e:  # noqa: BLE001 - classified below
            if not _memsafe._enabled or not _memsafe.is_oom(e):
                raise
            failed = _memsafe._release(e)
        if failed is not None:
            # outside the handler: the failed attempt's frames are gone
            loss = _memsafe.recover_trainer(self, failed, data, labels)
        if _resilience._enabled:
            _resilience.on_step(self)
        if _guard._enabled:
            # the completed-step beat (re-arms the deadline), then the
            # SDC vote on its cadence: after resilience, so a corrupt_grad
            # fault of this step is caught at this same boundary
            _guard.on_step(self, self.num_update)
        if _scope._enabled:
            _scope.on_step(self, self.num_update)
        return loss

    def _step_once(self, data, labels):
        """One attempt at the step. With memsafe armed, a failure before
        the optimizer touched any state rewinds the random streams to
        where the attempt found them, so a retry draws the same masks."""
        rng = _random.get_state() if _memsafe._enabled else None
        self._state_touched = False
        try:
            return self._step_impl(data, labels)
        except BaseException:
            if rng is not None and not self._state_touched:
                _random.set_state(rng)
            raise

    def _step_impl(self, data, labels):
        batch = list(data) + list(labels)
        shapes = tuple(tuple(b.shape) for b in batch)
        # the effective remat policy joins the key only with memsafe
        # armed (its ladder changes it mid-run), as in the JAX package
        key = (len(data), len(labels), shapes, self._accum,
               _memsafe.policy_marker(self.block) if _memsafe._enabled
               else None)
        is_miss = key not in self._step_cache
        step_no = self.num_update + 1
        # per-step config read so mx.config.set("nan_sentinel", ...)
        # takes effect mid-run
        sentinel = _config.get("nan_sentinel")
        tracing = _trace._enabled and (is_miss or _trace.sampled(step_no))
        accounting = _goodput._enabled
        observing = (_telemetry._enabled or _diagnostics._enabled
                     or sentinel or _inspect._enabled or tracing
                     or accounting)
        t_build = time.perf_counter() if (is_miss and observing) else None
        if not self._ready:
            self._finish_setup(data)
        micro = self._microbatches(data, labels)
        if _resilience._enabled:
            # the `oom@step:N` fault fires here, before anything runs
            _resilience.fault_point("dispatch", step=step_no)
        if _guard._enabled:
            # beat the dispatch; a first step at a new signature is a
            # legitimate long region, so the deadline is suspended
            _guard.step_begin(step_no, compiling=is_miss)
        lr = self.fopt.lr_at(step_no)
        # the JAX package fences for these, not for diagnostics alone
        fencing = _telemetry._enabled or sentinel or _inspect._enabled \
            or tracing or accounting
        self._observer_fenced = fencing
        # memsafe's check at a new signature, between the backward and
        # the optimizer update
        preflight = batch if is_miss and _memsafe._enabled else None
        record = None
        if is_miss and _check._enabled:
            resident = self._resident()
            held = [] if self._fl is None else _check.tensors_of(self._fl)
            record = _check.StepRecord(
                known=resident + batch + held + list(self.block.parameters())
                + list(self.block.buffers()), state=resident)
        events = None
        if fencing and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t_step = time.perf_counter() if observing else None
        in_scope = _diagnostics._enabled
        if in_scope:
            # what the watchdog names when the step never completes
            _diagnostics._scope_begin("sharded_step(dispatch)", step_no)
        try:
            ann = _trace.annotate(step_no) if tracing else _NULLCTX
            with ann:
                if is_miss and _inspect._enabled:
                    loss = _inspect.count_step(
                        self._cost_name(), _inspect.key_repr(key),
                        lambda: self._update(micro, step_no, lr, preflight),
                        args=self._resident() + batch, observer=record)
                elif record is not None:
                    loss = record.run(
                        lambda: self._update(micro, step_no, lr, preflight))
                else:
                    loss = self._update(micro, step_no, lr, preflight)
            t_disp = time.perf_counter() if tracing else None
            self.num_update = step_no
            self._t_dev.fill_(step_no)
            self._step_cache.add(key)
            if record is not None:
                try:
                    _check.check_step(self, key, record, batch=batch)
                except _check.CheckError:
                    # check=error: forget the signature, so the next step
                    # at it records and raises again
                    self._step_cache.discard(key)
                    raise
            if observing:
                if events is not None:
                    # the fence: where the JAX package blocks on the loss
                    events[1].record()
                    events[1].synchronize()
                t_done = time.perf_counter()
                dur = t_done - t_step if events is None \
                    else events[0].elapsed_time(events[1]) / 1e3
                if _telemetry._enabled:
                    self._tele_record_step(batch, t_build, dur)
                if _diagnostics._enabled or sentinel:
                    self._diag_record_step(loss, lr, shapes, t_build,
                                           sentinel)
                if tracing:
                    self._trace_record_step(step_no, t_build, t_step,
                                            t_disp, t_done)
                if accounting:
                    # before inspect: the step's interval ends at the
                    # fence
                    _goodput.note_step(step_no, t_build, t_step, t_done)
                if _inspect._enabled and t_build is None:
                    _inspect.note_step(self._cost_name(),
                                       _inspect.key_repr(key), dur)
        finally:
            if in_scope:
                _diagnostics._scope_end()
        return NDArray(loss.detach())

    def _leaves(self):
        """(the leaves the gradient is taken with respect to, the
        function that builds the block's parameter tensors from them)."""
        if self._fl is None:
            leaves = [p.detach().requires_grad_(True) for p in self.params]
            return leaves, lambda: leaves
        master = self.params.detach().requires_grad_(True)
        return [master], lambda: self._fl.unflatten(master)

    def _update(self, micro, t, lr, preflight=None):
        """Forward, backward and the optimizer update of step t; returns
        the float32 loss tensor. With `preflight` (the step's batch; a
        new signature with memsafe armed) the forward and backward are
        measured and `memsafe.preflight_step` checks the budget before
        the optimizer touches any state."""
        leaves, views = self._leaves()
        if preflight is None:
            loss, grads = self._accumulate(leaves, views, micro)
        else:
            loss, grads = _memsafe.preflight_step(
                self, lambda: self._accumulate(leaves, views, micro),
                preflight)
        if self._fl is None:
            self._state_touched = True
            self.fopt.apply(self.params, grads, self.opt_state, t, lr)
        else:
            (grad,) = grads
            m, v = self.opt_state
            self._state_touched = True
            self._fl.apply_flat(self.params, grad, m, v, t, lr)
        return loss

    def _resident(self):
        """The tensors the step holds between steps: trained parameters,
        optimizer state and aux tensors."""
        state = [t for st in self.opt_state
                 for t in (st if isinstance(st, (list, tuple)) else [st])]
        params = [self.params] if self._fl is not None else list(self.params)
        return params + state + [self.block.get_parameter(n)
                                 for n in self._aux_names]

    def _cost_name(self):
        return f"ShardedTrainer({type(self.block).__name__})"

    def _trace_record_step(self, step_no, t_build, t_step, t_disp, t_done):
        """mx.trace spans of one sampled step: host dispatch
        (t_step→t_disp) and the fence (t_disp→t_done), plus the skew
        probe's tick. A new-signature step records ONE `step.compile`
        span (probe pass through the fenced step) instead."""
        if t_build is not None:
            _trace.record_span("step.compile", t_build, t_done,
                               step=step_no, cat="compile", always=True,
                               block=type(self.block).__name__)
        else:
            _trace.record_span("step.dispatch", t_step, t_disp,
                               step=step_no, cat="step")
            _trace.record_span("step.fence", t_disp, t_done, step=step_no,
                               cat="step")
        _trace.skew_tick(step_no)

    def _diag_record_step(self, loss, lr, shapes, t_build, sentinel):
        """Flight-recorder entry for one step; with the nan_sentinel knob
        on (with diagnostics off too — the dump then has an empty ring)
        the loss is fetched and checked here, and NonFiniteError
        propagates after the post-mortem."""
        if t_build is not None:
            _diagnostics.record_event(
                "compile", block=self._cost_name(),
                compile_time_s=round(time.perf_counter() - t_build, 6),
                step=self.num_update)
        loss_val = _diagnostics._scalar(loss) if sentinel else None
        _diagnostics.record_step(
            self.num_update, loss=loss_val, lr=float(lr), shapes=shapes,
            trainer="ShardedTrainer", compiled=t_build is not None)
        if sentinel:
            # checked AFTER recording so the fatal step is the ring's last
            # entry in the post-mortem
            _diagnostics.sentinel_check(loss_val, "loss", self.num_update)

    def _tele_record_step(self, batch, t_build, dur):
        """Telemetry of one step: at a new signature the compile
        accounting (with a signature diff explaining it), else the step
        latency histogram and a `step` event."""
        if t_build is None:
            _M_STEP_SECONDS.observe(dur)
            _telemetry.event("step", dur_s=round(dur, 6),
                             step=self.num_update)
            return
        dt = time.perf_counter() - t_build
        _M_COMPILES.inc()
        _M_COMPILE_SECONDS.observe(dt)
        sig = _telemetry.signature(batch)
        causes, changed = _telemetry.diff_signature(self._tele_sig, sig)
        kind = "compile" if self._tele_sig is None else "recompile"
        if self._tele_sig is not None:
            _M_RECOMPILES.inc()
        self._tele_sig = sig
        _telemetry.event(kind, block=self._cost_name(),
                         compile_time_s=round(dt, 6), causes=causes,
                         changed=changed, signature=sig)

    def _microbatches(self, data, labels):
        """[(data, labels)] of the step's `accum` equal microbatches."""
        n = self._accum
        if n == 1:
            return [(data, labels)]
        for b in list(data) + list(labels):
            if b.dim() == 0 or b.shape[0] % n:
                raise ValueError(
                    f"grad accumulation x{n}: every batch/label array "
                    f"needs a leading dim divisible by {n}, got shape "
                    f"{tuple(b.shape)}")
        data = [x.chunk(n) for x in data]
        labels = [x.chunk(n) for x in labels]
        return [([x[i] for x in data], [y[i] for y in labels])
                for i in range(n)]

    def _accumulate(self, leaves, views, micro):
        """The mean loss and the mean gradients over the microbatches
        (the plain loss and gradients for one)."""
        loss, grads = self._loss_and_grads(leaves, views, *micro[0])
        if len(micro) == 1:
            return loss, grads
        grads = list(grads)
        for data, labels in micro[1:]:
            l_i, g_i = self._loss_and_grads(leaves, views, data, labels)
            loss = loss + l_i
            torch._foreach_add_(grads, list(g_i))
        n = len(micro)
        return loss / n, torch._foreach_div(grads, n)

    def _loss_and_grads(self, leaves, views, data, labels):
        """Forward in training mode on the parameter tensors that
        `views()` builds (inside the recorded region), the float32 mean
        loss and its gradients with respect to `leaves`."""
        was_training = self.block.training
        self.block.train()
        policy = _memsafe.block_wrap_policy(self.block)
        try:
            with torch.enable_grad():
                tensors = views()
                if policy is None:
                    outs = functional_call(self.block,
                                           dict(zip(self._names, tensors)),
                                           tuple(data))
                else:
                    n = len(tensors)
                    outs = _remat.wrap_call(
                        self.block, lambda *a: functional_call(
                            self.block, dict(zip(self._names, a[:n])),
                            a[n:]), list(tensors) + list(data), policy)
                outs = outs if isinstance(outs, (list, tuple)) else (outs,)
                loss = call_loss(self.loss_fn, outs, labels)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            self.block.train(was_training)
        return loss, grads

    def sync_to_block(self):
        """Write the trained parameters (the LAMB master, or the Adam
        copies) back into the block's parameters (model dtype), e.g.
        before serving or saving them."""
        trained = self.params if self._fl is None \
            else self._fl.unflatten_master(self.params)
        with torch.no_grad():
            for name, w in zip(self._names, trained):
                p = self.block.get_parameter(name)
                p.copy_(w.to(p.dtype))

    # -- checkpoints ------------------------------------------------------
    def save_checkpoint(self, prefix):
        """Write the trained parameters into the block and save them to
        `prefix.params` (`Block.save_parameters`: the JAX package's
        file)."""
        self.sync_to_block()
        self.block.save_parameters(prefix + ".params")

    def _to_host(self, tensors):
        """CPU copies of `tensors`. On the card each goes into its slice of
        a pinned host buffer of its dtype that the trainer keeps (grown
        when too small), and one sync ends the copies; CPU tensors are
        the live ones (they are written before the next step changes
        them)."""
        if self.device.type != "cuda":
            return [t.detach() for t in tensors]
        need = {}
        for t in tensors:
            need[t.dtype] = need.get(t.dtype, 0) + t.numel()
        bufs = self._host_bufs
        for dt, n in need.items():
            if dt not in bufs or bufs[dt].numel() < n:
                bufs.pop(dt, None)
                bufs[dt] = torch.empty(n, dtype=dt, pin_memory=True)
        used = dict.fromkeys(need, 0)
        out = []
        for t in tensors:
            off, n = used[t.dtype], t.numel()
            dst = bufs[t.dtype][off:off + n].view(t.shape)
            dst.copy_(t.detach(), non_blocking=True)
            used[t.dtype] = off + n
            out.append(dst)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _state(self):
        """The checkpoint payload (CPU tensors): the per-tensor layout of
        the JAX package's `_state_pytree`, plus the names and the random
        streams."""
        if not self._ready:
            raise RuntimeError(
                "save_states needs the trainer's parameters: run one step "
                "first (the block still has deferred shapes)")
        aux = [self.block.get_parameter(n) for n in self._aux_names]
        if self._fl is None:
            flat = list(self.params) + [s for st in self.opt_state
                                        for s in st]
        else:
            flat = [self.params, *self.opt_state]
        host = self._to_host(flat + aux)
        flat, aux = host[:len(flat)], host[len(flat):]
        if self._fl is None:
            n = len(self.params)
            params, rest = flat[:n], iter(flat[n:])
            opt_state = [[next(rest) for _ in st] for st in self.opt_state]
        else:
            params = self._fl.unflatten_master(flat[0])
            opt_state = [list(mv) for mv in zip(
                self._fl.unflatten_master(flat[1]),
                self._fl.unflatten_master(flat[2]))]
        return {"format": _STATE_FORMAT, "names": list(self._names),
                "params": params, "aux_names": list(self._aux_names),
                "aux": aux, "opt_state": opt_state,
                "num_update": int(self.num_update),
                "rng": _random.get_state()}

    def _write_state(self, directory, zip_crc=True):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, _STATE_FILE)
        with open(path, "wb") as f, _zip_crc32(zip_crc):
            torch.save(self._state(), f)
            f.flush()
            os.fsync(f.fileno())

    def save_states(self, directory):
        """Write the train state into `directory` (`state.pt`): atomic and
        verified (`resilience.write_checkpoint`) while resilience is
        enabled, a plain write otherwise. Under the manifest, whose CRC32
        of the whole file is checked before any load, the zip records
        carry none of their own (torch's per-record CRC32 is a third of
        the write's time at BERT-large)."""
        if not _resilience._enabled:
            self._write_state(directory)
            return
        _resilience.write_checkpoint(
            directory, lambda tmp: self._write_state(tmp, zip_crc=False),
            step=int(self.num_update),
            fingerprint=_resilience.trainer_fingerprint(self))

    def load_states(self, directory):
        """Restore a `save_states` directory into this trainer, in place:
        master (or parameters), optimizer state (cast to this trainer's
        moment dtype), aux tensors, `num_update` and the random streams.
        While resilience is enabled and the directory has a manifest,
        checksums and the fingerprint are verified first."""
        directory = str(directory)
        if _resilience._enabled and os.path.exists(
                os.path.join(directory, "manifest.json")):
            manifest = _resilience.verify_checkpoint(directory)
            _resilience.check_fingerprint(
                manifest, _resilience.trainer_fingerprint(self), directory)
        if not self._ready:
            raise RuntimeError(
                "load_states needs the trainer's parameters: run one step "
                "first (the block still has deferred shapes)")
        state = torch.load(os.path.join(directory, _STATE_FILE),
                           map_location="cpu", weights_only=True, mmap=True)
        if state.get("format") != _STATE_FORMAT \
                or state["names"] != self._names \
                or state["aux_names"] != self._aux_names:
            raise ValueError(
                f"{directory}: the checkpoint's parameters do not match "
                "this trainer's (another model or optimizer)")
        with torch.no_grad():
            if self._fl is None:
                for p, src in zip(self.params, state["params"]):
                    p.copy_(src)
                for st, src in zip(self.opt_state, state["opt_state"]):
                    if len(st) != len(src):
                        raise ValueError(f"{directory}: optimizer state of "
                                         "another optimizer")
                    for dst, s in zip(st, src):
                        dst.copy_(s)
            else:
                self._fl.load_flat(self.params, state["params"])
                for i, flat in enumerate(self.opt_state):
                    self._fl.load_flat(flat, [mv[i] for mv in
                                              state["opt_state"]])
            for name, src in zip(self._aux_names, state["aux"]):
                self.block.get_parameter(name).copy_(src)
        self.num_update = int(state["num_update"])
        self._t_dev.fill_(self.num_update)
        _random.set_state(state["rng"])

    def predict_step_bytes(self, data, labels):
        """The memory plan of one train step at these batch shapes:
        {"exec_peak_bytes", "resident_bytes", "predicted_bytes",
        "capacity_bytes", "headroom_bytes", "fits"}, as the JAX
        package's. `resident_bytes` is the train state (parameters,
        optimizer state, aux tensors) plus the batch; `exec_peak_bytes`
        is what one forward and backward at these shapes allocate above
        that (`memsafe.measure_peak`: the caching allocator's peak on the
        card, a profiler's memory events on the CPU). The JAX package
        predicts it from XLA's ahead-of-time analysis without running
        anything; the port has no such analysis and runs the pass (the
        batch is copied to the device), with no optimizer update: the
        parameters, optimizer state, aux tensors, `num_update` and the
        random streams are left exactly as they were. A pass that runs
        out of memory on the card is not retried: it gives `"oom": True`,
        `fits` False and `exec_peak_bytes` None. Capacity, headroom and
        fits are None when no capacity is known. This is what
        `dataflow.autofit` searches over."""
        data = data if isinstance(data, (list, tuple)) else [data]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        if not self._ready:
            raise RuntimeError(
                "predict_step_bytes needs materialized parameters: run one "
                "step before planning (the block has deferred shapes)")
        data = [_as_tensor(x, self.device) for x in data]
        labels = [_as_tensor(x, self.device) for x in labels]
        resident = _memsafe.resident_bytes(self._resident() + data + labels)
        rng = _random.get_state()
        aux = [self.block.get_parameter(n) for n in self._aux_names]
        saved = [a.detach().clone() for a in aux]
        oom = False
        try:
            leaves, views = self._leaves()
            micro = self._microbatches(data, labels)
            _, exec_peak = _memsafe.measure_peak(
                lambda: self._accumulate(leaves, views, micro), self.device)
        except torch.cuda.OutOfMemoryError as e:
            _memsafe._release(e)
            oom, exec_peak = True, None
        finally:
            _random.set_state(rng)
            with torch.no_grad():
                for a, s in zip(aux, saved):
                    a.copy_(s)
        capacity = _memsafe.capacity_bytes(self.device)
        predicted = int(resident) + int(exec_peak or 0)
        out = {
            "exec_peak_bytes": exec_peak,
            "resident_bytes": int(resident),
            "predicted_bytes": predicted,
            "capacity_bytes": capacity,
            "headroom_bytes": None if capacity is None
            else int(capacity) - predicted,
            "fits": None if capacity is None
            else not oom and predicted <= capacity,
        }
        if oom:
            out["oom"] = True
        return out

    @property
    def _fused(self):
        """True on the fused flat-master LAMB path (the JAX trainer's
        attribute name)."""
        return self._fl is not None

    @property
    def param_count(self):
        if self._fl is None:
            return sum(p.numel() for p in self.params)
        return sum(self._fl.sizes)
