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
"""
from __future__ import annotations

import torch

from . import context

__all__ = ["seed", "generator", "next_seed"]

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
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
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
