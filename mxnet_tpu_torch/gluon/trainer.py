"""Trainer: applies an Optimizer to a set of Parameters (counterpart of
`mxnet_tpu/gluon/trainer.py`), the eager loop's update:

    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

`step(batch_size)` sets the optimizer's `rescale_grad` to 1/batch_size
and updates every trainable parameter (grad_req not 'null'), in place,
under `torch.no_grad()`: with one `optimizer.update_multi(indices,
params, grads, states)` call where the optimizer has it (Adam, AdamW:
one kernel launch for each weight dtype; LAMB: one launch of each LAMB
pass), else `optimizer.update(i, param, param.grad, state)` per
parameter; the optimizer's state is created at the first step. A
parameter listed under two paths (a block added twice) is updated once a
step. A parameter that no backward has reached updates with a zero
gradient, as the JAX package's zero-initialised gradient buffers do. One device:
there is no kvstore to reduce through, so `kvstore` and
`update_on_kvstore` are accepted and `allreduce_grads` does nothing;
`compression_params` raises as in the JAX package.

The states are the optimizer's NDArrays (`create_state`).
`save_states(fname)` writes the optimizer state as the JAX package does:
one `nd.save` dict, key "i" for a single state tensor of parameter i and
"i.j" for entry j of a tuple state (absent entries, as SGD without
momentum's None, are left out); `load_states(fname)` copies such a file,
of either package, into the state tensors in place (creating them first
if no step has). Like the JAX package's, the file holds neither the
update counts nor the learning rate.

An out-of-memory error of a step under memsafe (`oom_recover` or
`device_bytes_limit` set) is counted and annotated
(`memsafe.note_eager_oom`) before it propagates: the eager loop cannot
degrade a step whose tape already ran.

Observers, as in the JAX package: with telemetry on, a step's host wall
time lands in `trainer_step_seconds`; with diagnostics on or the
`nan_sentinel` knob set, the step is recorded in the flight ring before
the update, and the sentinel checks the gradients' global norm there
(one host fetch) and raises NonFiniteError after a post-mortem, before
any parameter changes. Where an AMP loss scaler with a scale other than
1 is attached (`_amp_loss_scaler`, the JAX package's attribute) the
sentinel stands down: an Inf gradient there is the scaler's routine
overflow. The AMP scaler itself is not in the port.
"""
from __future__ import annotations

import time

import torch

from .. import config as _config
from .. import diagnostics as _diagnostics
from .. import memsafe as _memsafe
from .. import optimizer as opt_mod
from .. import telemetry as _telemetry
from .parameter import ParameterDict, zero_grad

__all__ = ["Trainer"]

_M_STEP_SECONDS = _telemetry.histogram(
    "trainer_step_seconds", "Trainer.step / ShardedTrainer.step time "
    "(gluon Trainer: host wall time of the optimizer apply; "
    "ShardedTrainer: the fenced step, on the card by CUDA events)")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, ParameterDict):
            params = list(params.values())
        elif isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        # a block added twice lists its parameters under both paths: each
        # parameter object is updated once a step, as upstream MXNet does
        seen = set()
        params = [p for p in params if id(p) not in seen
                  and not seen.add(id(p))]
        if compression_params is not None:
            raise ValueError(
                "Trainer does not route gradients through a kvstore (one "
                "device: nothing is reduced), so compression_params has "
                "nothing to compress here")
        self._params = [p for p in params if p.grad_req != "null"]
        self._all_params = list(params)
        self._optimizer = opt_mod.create(
            optimizer, param_dict=dict(enumerate(self._params)),
            **(optimizer_params or {}))
        self._states = [None] * len(self._params)
        self._states_created = False
        self._kvstore_type = kvstore
        self._num_update = 0

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _create_states(self):
        for i, p in enumerate(self._params):
            self._states[i] = self._optimizer.create_state(i, p)
        self._states_created = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Scale the gradients by 1/batch_size and apply the updates."""
        if _telemetry._enabled:
            t0 = time.perf_counter()
            try:
                self._step_guarded(batch_size, ignore_stale_grad)
            finally:
                _M_STEP_SECONDS.observe(time.perf_counter() - t0)
            return
        self._step_guarded(batch_size, ignore_stale_grad)

    def _step_guarded(self, batch_size, ignore_stale_grad):
        self._num_update += 1
        sentinel = _config.get("nan_sentinel")
        if _diagnostics._enabled or sentinel:
            self._diag_record_step(sentinel)
        self._optimizer.rescale_grad = 1.0 / batch_size
        try:
            self._update(ignore_stale_grad)
        except Exception as e:  # noqa: BLE001 - classified below
            if _memsafe._enabled and _memsafe.is_oom(e):
                _memsafe.note_eager_oom(e, step=self._num_update)
            raise

    def _diag_record_step(self, sentinel):
        """The flight-ring record of this step, before the update; with
        the sentinel (and no scaling AMP scaler) the gradients' global
        norm is checked after recording, so the fatal step is the ring's
        last entry and no parameter has changed."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        amp_scaled = scaler is not None and scaler.loss_scale != 1.0
        gnorm = None
        if sentinel and not amp_scaled:
            gnorm = _diagnostics.grad_global_norm(
                [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params])
        _diagnostics.record_step(self._num_update, lr=self.learning_rate,
                                 grad_norm=gnorm, trainer="Trainer")
        if gnorm is not None:
            _diagnostics.sentinel_check(gnorm, "grad_norm",
                                        self._num_update)

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to do: one device holds every gradient."""

    def _update(self, ignore_stale_grad=False):
        if not self._states_created:
            self._create_states()
        opt = self._optimizer
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
            if hasattr(opt, "update_multi"):
                opt.update_multi(range(len(self._params)), self._params,
                                 grads, self._states)
                return
            for i, (p, g) in enumerate(zip(self._params, grads)):
                opt.update(i, p, g, self._states[i])

    def zero_grad(self):
        for p in self._params:
            zero_grad(p)

    # -- optimizer state checkpointing (reference: trainer.save_states) --
    def save_states(self, fname):
        from ..ndarray import ndarray as _nd
        if not self._states_created:
            self._create_states()
        flat = {}
        for i, st in enumerate(self._states):
            if st is None:
                continue
            if isinstance(st, tuple):
                for j, t in enumerate(st):
                    if t is not None:
                        flat[f"{i}.{j}"] = t
            else:
                flat[f"{i}"] = st
        _nd.save(fname, flat)

    def load_states(self, fname):
        from ..ndarray import ndarray as _nd
        if not self._states_created:
            self._create_states()
        kind, flat = _nd.load_arrays(fname)
        if kind != "dict":
            raise ValueError(f"{fname} holds a {kind} of arrays, not "
                             "optimizer states")
        with torch.no_grad():
            for key, arr in flat.items():
                if "." in key:
                    i, j = map(int, key.split("."))
                    dst = self._states[i][j]._t
                else:
                    dst = self._states[int(key)]._t
                if tuple(dst.shape) != tuple(arr.shape):
                    raise ValueError(
                        f"{fname}: state {key} has shape {tuple(arr.shape)}"
                        f", the trainer's {tuple(dst.shape)}")
                dst.copy_(arr.to(device=dst.device, dtype=dst.dtype))
