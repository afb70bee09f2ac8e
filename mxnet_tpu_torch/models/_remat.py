"""Per-layer rematerialisation shared by the model families (the
counterpart of the "layers" policy of `_remat_call` in
`mxnet_tpu/models/bert.py`, which BERT and GPT both use).

`stack_call` runs a layer stack, each layer under
`torch.utils.checkpoint` when the policy is "layers" and autograd
records. The recomputation replays the port's random streams
(`random.get_state` / `set_state`), because `torch.utils.checkpoint`
restores only torch's default generators.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd as _autograd
from .. import random as _random
from ..gluon.block import training


def remat_policy(remat):
    """The remat policy a config's `remat` names: "none" or "layers"
    (True is the "layers" alias). The JAX package's memsafe policies
    raise."""
    policy = {False: "none", None: "none", True: "layers"}.get(remat, remat)
    if policy in ("dots_saveable", "full"):
        raise NotImplementedError(
            f"remat policy {policy!r} is not in the port yet (ROADMAP "
            "queue 1, \"What bench.py's BERT-large row leaves\"); it has "
            "'layers'")
    if policy not in ("none", "layers"):
        raise ValueError(f"unknown remat policy {remat!r}")
    return policy


def remat_call(layer, x, mask):
    """layer(x, mask) under `torch.utils.checkpoint`: the backward
    recomputes the layer from its (x, mask) boundary. The recomputation
    runs on the parameter tensors and in the training modes the first
    forward saw (under the trainer's `functional_call` the parameters
    are the master's views, which the modules no longer hold by the time
    of the backward: they are put back into the modules' parameter slots
    for the recomputation; the modes are those the first forward ran in,
    an autograd scope's included, and the recomputation runs outside any
    scope's flag). It starts from a snapshot of the random
    streams taken before the first forward, so it draws exactly what the
    first forward drew, and then puts the streams back where the
    backward found them."""
    modules = list(layer.modules())
    modes = [training(m) for m in modules]
    slots = [(m, name, p) for m in modules
             for name, p in m._parameters.items() if p is not None]
    _random.generator(x.device)        # made before the snapshot
    before = _random.get_state()
    calls = []

    def run(x, mask):
        if not calls:
            calls.append(1)
            return layer(x, mask)
        now, now_modes = _random.get_state(), [m.training for m in modules]
        held = [m._parameters[name] for m, name, _ in slots]
        scope = _autograd.set_training(None)
        _random.set_state(before)
        for m, name, p in slots:
            m._parameters[name] = p
        for m, mode in zip(modules, modes):
            m.training = mode
        try:
            return layer(x, mask)
        finally:
            _random.set_state(now)
            _autograd.set_training(scope)
            for (m, name, _), p in zip(slots, held):
                m._parameters[name] = p
            for m, mode in zip(modules, now_modes):
                m.training = mode

    return checkpoint(run, x, mask, use_reentrant=False)


def stack_call(layers, x, mask, policy):
    """Apply a layer stack, each layer under remat when the policy is
    "layers" and autograd records."""
    remat = policy == "layers" and torch.is_grad_enabled()
    for layer in layers:
        x = remat_call(layer, x, mask) if remat else layer(x, mask)
    return x
