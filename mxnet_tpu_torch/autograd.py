"""Autograd scopes and backward (counterpart of `mxnet_tpu/autograd.py`
and of the recording and training flags of `mxnet_tpu/_engine.py`).

torch's autograd is the tape. `record()` turns torch's grad mode on and
`pause()` turns it off for the scope, so what MXNet records is what torch
records; leaving the scope puts torch's grad mode back as it found it.
The first forward of a `Block` under `record()` lets its trainable
parameters record gradients (`Block.__call__`); until then they record
none, so a model that is only served builds no graph.

The training flag has two sources. While a scope (`record`, `pause`,
`train_mode`, `predict_mode`) or `set_training` is in effect, its flag
decides for every layer; otherwise each block's own flag (`train()` /
`eval()`, which `parallel.ShardedTrainer` sets) decides
(`gluon.block.training`). A layer pays one module-global read for it.
Both flags are process-wide, not per thread as the JAX package's are.

Gradients land in each leaf's torch `.grad`. A leaf's `grad_req`
decides how a backward writes it, as MXNet's does: 'write' replaces the
gradient of the previous backward (a hook clears it before torch
accumulates), 'add' sums into it until it is zeroed. `backward` seeds
ones for a head of any shape, as MXNet does, and takes `train_mode` for
the signature's sake: torch differentiates the graph that the forward
recorded, so there is nothing to replay.
"""
from __future__ import annotations

import weakref

import torch

from .ndarray.ndarray import NDArray

__all__ = ["record", "pause", "train_mode", "predict_mode", "backward",
           "is_recording", "is_training", "set_recording", "set_training",
           "mark_variables", "grad"]

_recording = False
# None: no scope is in effect and each block's own flag decides
_training = None


def is_recording():
    return _recording


def is_training():
    return bool(_training)


def set_recording(flag):
    """Set the recording flag and torch's grad mode with it; returns the
    previous flag."""
    global _recording
    prev, _recording = _recording, bool(flag)
    torch.set_grad_enabled(_recording)
    return prev


def set_training(flag):
    """Set the training flag for every layer; returns the previous flag
    (None when none was set: `set_training(None)` hands the decision back
    to each block's own flag)."""
    global _training
    prev, _training = _training, None if flag is None else bool(flag)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_record = is_record
        self._enter_train = train_mode
        self._prev = None

    def __enter__(self):
        global _recording, _training
        self._prev = (_recording, _training, torch.is_grad_enabled())
        if self._enter_record is not None:
            _recording = self._enter_record
            torch.set_grad_enabled(self._enter_record)
        if self._enter_train is not None:
            _training = self._enter_train
        return self

    def __exit__(self, *exc):
        global _recording, _training
        prev_r, prev_t, grad_mode = self._prev
        if self._enter_record is not None:
            _recording = prev_r
            torch.set_grad_enabled(grad_mode)
        if self._enter_train is not None:
            _training = prev_t
        return False


def record(train_mode=True):
    """`with autograd.record():` records the forward (and trains)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# -- grad_req on leaves ------------------------------------------------------

def _write_hook(ref):
    """A tensor hook that clears the leaf's gradient before torch
    accumulates this backward's into it, when its grad_req is 'write'."""
    def hook(_):
        leaf = ref()
        if leaf is not None and leaf.grad_req == "write":
            leaf.grad = None
    return hook


def attach_grad_req(leaf):
    """Let `leaf` (a tensor carrying `grad_req`) record gradients, with
    the hook that gives 'write' its meaning (once per leaf)."""
    leaf.requires_grad_(True)
    if not getattr(leaf, "_mx_hooked", False):
        leaf.register_hook(_write_hook(weakref.ref(leaf)))
        leaf._mx_hooked = True


def _unwrap(x):
    return x._t if isinstance(x, NDArray) else x


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _heads(heads, head_grads):
    """(head tensors, their seeds): the given head gradient, else ones."""
    outs = [_unwrap(h) for h in _as_list(heads)]
    grads = [None] * len(outs) if head_grads is None \
        else _as_list(head_grads)
    return outs, [torch.ones_like(t) if g is None else _unwrap(g).to(t.dtype)
                  for t, g in zip(outs, grads)]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf that records gradients into the given
    buffer (an NDArray of the variable's shape), by its grad_req."""
    variables, gradients = _as_list(variables), _as_list(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._mark(g, req)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Differentiate `heads` (an NDArray or a list) into the leaves'
    gradients; a head without a head gradient is seeded with ones."""
    torch.autograd.backward(*_heads(heads, head_grads),
                            retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of `heads` with respect to `variables` (NDArrays or
    parameters), as NDArrays; the leaves' own gradients are left alone.
    A variable the heads do not reach gets zeros, as in the JAX
    package."""
    outs, seeds = _heads(heads, head_grads)
    leaves = [_unwrap(v) for v in _as_list(variables)]
    got = torch.autograd.grad(outs, leaves, seeds,
                              retain_graph=retain_graph,
                              create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v) if g is None else g)
            for v, g in zip(leaves, got)]
