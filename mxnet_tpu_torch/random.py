"""Seeded random state (counterpart of `mxnet_tpu/random.py`).

JAX keys become explicit `torch.Generator`s. The two frameworks give
different numbers from the same seed, so nothing that compares the two
packages depends on this module: parity tests carry weights across.
"""
from __future__ import annotations

import torch

from . import context

__all__ = ["seed"]


def seed(seed_state, device=None):
    """A generator on `device` (the card by default) seeded with
    `seed_state`."""
    dev = context.resolve(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed_state))
    return g
