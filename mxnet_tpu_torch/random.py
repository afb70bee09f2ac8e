"""Seeded random state (counterpart of `mxnet_tpu/random.py`).

JAX keys become explicit `torch.Generator`s, in two streams seeded by
`seed`:
  * a device stream per device (`generator(device)`), from which weight
    initialisation and hidden dropout draw;
  * one host stream on the CPU (`next_seed()`), from which every call of
    attention dropout draws the 64-bit seed of its in-kernel Philox mask,
    so the draw never waits for the card.
The two frameworks give different numbers from the same seed, so nothing
that compares the two packages depends on this module: parity tests
carry weights across and run without dropout.

`get_state` / `set_state` snapshot and restore both streams: the seed,
the host generator's state (so also the counter of the flash kernels'
Philox masks, whose 64-bit seeds it draws) and each device generator's
state (seed and offset). The snapshot is a tuple of an int, byte tensors
and a dict keyed by device name, so `torch.save` writes it and
`torch.load(weights_only=True)` reads it: it is the random part of a
`ShardedTrainer` checkpoint, and after `set_state` the next step draws
the masks an uninterrupted run would have drawn. The JAX package
replays a rematerialised layer's draws from its key; the port's
rematerialised layers (`models._remat`) replay them from a snapshot
taken before the first forward, because `torch.utils.checkpoint`
restores only torch's default generators.
"""
from __future__ import annotations

import torch

from . import context

__all__ = ["seed", "generator", "next_seed", "get_state", "set_state"]

_seed = 0
_host = torch.Generator()
_host.manual_seed(_seed)
_devices = {}


def seed(seed_state, device=None):
    """Reseed both streams with `seed_state` and return the device stream
    of `device` (the card by default)."""
    global _seed
    _seed = int(seed_state)
    _host.manual_seed(_seed)
    _devices.clear()
    return generator(context.resolve(device))


def generator(device):
    """The device stream of `device`, created from the current seed on
    first use."""
    dev = context.resolve(device)
    key = str(dev)
    g = _devices.get(key)
    if g is None:
        g = _devices[key] = torch.Generator(device=dev)
        g.manual_seed(_seed)
    return g


def next_seed():
    """A fresh 64-bit seed from the host stream."""
    lo, hi = torch.randint(0, 1 << 32, (2,), generator=_host,
                           dtype=torch.int64).tolist()
    return lo | (hi << 32)


def get_state():
    """A snapshot of both streams: the seed, the host stream's state and
    the state of every device stream made so far."""
    return (_seed, _host.get_state(),
            {key: g.get_state() for key, g in _devices.items()})


def set_state(state):
    """Put both streams back where `get_state` found them. A device stream
    made since is dropped: its next use makes it again from the seed, as
    its first use did."""
    global _seed
    _seed, host, devices = state
    _host.set_state(host)
    for key in list(_devices):
        if key not in devices:
            del _devices[key]
    for key, s in devices.items():
        g = _devices.get(key)
        if g is None:
            g = _devices[key] = torch.Generator(device=torch.device(key))
        g.set_state(s)
