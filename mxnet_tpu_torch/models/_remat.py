"""Rematerialisation shared by the model families and the trainer (the
counterpart of `_remat_call`, `_full_remat_stack` and `_stack_call` in
`mxnet_tpu/models/bert.py`, which BERT and GPT both use, and of the
whole-function wrap of `mxnet_tpu/gluon/block.py`'s `_make_pure_fn`).

The policies are `memsafe.POLICIES`, in increasing memory savings and
recompute cost, each on a non-reentrant `torch.utils.checkpoint`:
  * "none": every intermediate is saved;
  * "dots_saveable": each layer under a selective checkpoint that keeps
    the GEMMs' outputs (`aten.mm`, `addmm`, `bmm`, `linear`) and
    recomputes the rest, as `jax.checkpoint_policies.dots_saveable`
    does. The flash kernel's outputs are not GEMM outputs, so its
    forward runs again in the backward, as XLA recomputes the Pallas
    call;
  * "layers": each layer under a checkpoint that saves only its (x,
    mask) boundary;
  * "full": one checkpoint around the whole stack on top of the
    per-layer ones: only the stack's inputs outlive the forward, and the
    backward recomputes the stack (each layer again under its own
    checkpoint).
A recomputation runs on the parameter tensors, in the training modes and
from the random streams the first forward saw: the recompute context
(`_replayed`) puts the parameters the first forward ran on back into the
modules' slots (under the trainer's `functional_call` they are the
master's views, which the modules no longer hold by the time of the
backward), restores the modes (an autograd scope's flag included; the
recomputation runs outside any scope's flag), and replays the port's
random streams from a snapshot taken before the first forward
(`random.get_state` / `set_state`: `torch.utils.checkpoint` restores
only torch's default generators, which feed nothing here), then puts
all of it back where the backward found it. So every policy draws the
hidden dropout masks and attention-dropout seeds of the first forward,
and its losses and gradients equal "none"'s bit for bit.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import autograd as _autograd
from .. import memsafe as _memsafe
from .. import random as _random
from ..gluon.block import training

__all__ = ["remat_policy", "remat_call", "stack_call", "wrap_call"]

_aten = torch.ops.aten
# the ops whose outputs "dots_saveable" keeps: every GEMM a layer runs
# (a Dense is `linear`, which reaches the dispatcher as addmm or mm, a
# batched product bmm)
DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
        _aten.linear.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(remat):
    """The remat policy a config's `remat` names: True is the "layers"
    alias, False or None "none", else a policy name."""
    policy = {False: "none", None: "none", True: "layers"}.get(remat, remat)
    if policy not in _memsafe.POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}: expected one of "
                         f"{_memsafe.POLICIES} or a bool")
    return policy


@contextlib.contextmanager
def _replayed(before, modules, modes, slots):
    """The recomputation's context: the first forward's random streams,
    parameters and modes in, then everything back as it was."""
    now, now_modes = _random.get_state(), [m.training for m in modules]
    held = [m._parameters[name] for m, name, _ in slots]
    scope = _autograd.set_training(None)
    _random.set_state(before)
    for m, name, p in slots:
        m._parameters[name] = p
    for m, mode in zip(modules, modes):
        m.training = mode
    try:
        yield
    finally:
        _random.set_state(now)
        _autograd.set_training(scope)
        for (m, name, _), p in zip(slots, held):
            m._parameters[name] = p
        for m, mode in zip(modules, now_modes):
            m.training = mode


def _checkpoint(modules, fn, args, policy):
    """fn(*args) under a non-reentrant checkpoint whose recomputation
    replays what the first forward saw (`_replayed`) over `modules`;
    "dots_saveable" adds the selective policy that keeps GEMM outputs."""
    modes = [training(m) for m in modules]
    slots = [(m, name, p) for m in modules
             for name, p in m._parameters.items() if p is not None]
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    _random.generator(device)        # made before the snapshot
    before = _random.get_state()

    def context_fn():
        if policy == "dots_saveable":
            fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()

        @contextlib.contextmanager
        def recompute():
            with _replayed(before, modules, modes, slots), rec:
                yield
        return fwd, recompute()

    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=context_fn)


def remat_call(layer, x, mask, policy="layers"):
    """layer(x, mask) under `policy`'s checkpoint ("layers",
    "dots_saveable", or "full" for a layer inside the full stack, which
    checkpoints as "layers"): the backward recomputes the layer from its
    (x, mask) boundary, keeping the GEMM outputs under
    "dots_saveable"."""
    return _checkpoint(list(layer.modules()), layer, (x, mask), policy)


def stack_call(layers, x, mask, policy):
    """Apply a layer stack under `policy` (`memsafe.POLICIES`) where
    autograd records (a training step), plainly elsewhere, as the JAX
    package applies remat only inside a trace."""
    if policy == "none" or not torch.is_grad_enabled():
        for layer in layers:
            x = layer(x, mask)
        return x
    if policy == "full":
        def run(x, mask):
            for layer in layers:
                x = remat_call(layer, x, mask, "full")
            return x
        return _checkpoint(list(layers.modules()), run, (x, mask), "full")
    for layer in layers:
        x = remat_call(layer, x, mask, policy)
    return x


def wrap_call(block, fn, tensors, policy):
    """fn(*tensors) (the block's whole forward, its parameter tensors among
    `tensors`) under `policy`'s checkpoint: the generic wrap for a block
    whose policy no layer structure consumes
    (`memsafe.block_wrap_policy`). "layers" and "full" save only the
    inputs; "dots_saveable" keeps the GEMM outputs."""
    return _checkpoint(list(block.modules()), fn, tuple(tensors), policy)
