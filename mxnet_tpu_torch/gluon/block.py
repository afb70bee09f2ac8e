"""Block (counterpart of `mxnet_tpu/gluon/block.py`).

A Block is a thin `torch.nn.Module`. Attribute paths name parameters
exactly as the JAX package's `collect_params()` does
(`gpt.layers.0.attn.qkv.weight`), so carrying weights between the two
packages is the identity on names. PyTorch runs eagerly, so there is
no hybridize/jit cache: `HybridBlock` is the same class.

A block starts in evaluation mode (`training` False), as the JAX
package runs outside a train step; `train()` (what the trainer's step
sets around its forward) turns dropout on, `eval()` off.
"""
from __future__ import annotations

import re

import torch

from .. import context
from .. import initializer as _init

__all__ = ["Block", "HybridBlock", "HybridSequential"]


class Block(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.training = False

    def collect_params(self, select=None):
        """All parameters of this subtree keyed by dotted path
        (optionally filtered by a regex)."""
        return {path: p for path, p in self.named_parameters()
                if select is None or re.search(select, path)}

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False):
        """Fill every parameter not yet initialised in place (every one
        with `force_reinit`): `init` when given, else the parameter's own
        initializer, else uniform (the JAX package's precedence), through
        the name rule of `Initializer.init_array` (biases and betas 0,
        gammas 1); a `Constant` keeps its value. `device` moves the block
        first; `generator` is the explicit random source (its device must
        be the parameters'), else the device stream of `random.seed`."""
        if device is not None:
            self.to(context.resolve(device))
        for _, p in self.named_parameters():
            if getattr(p, "mx_constant", False) or (
                    getattr(p, "mx_initialized", False) and not force_reinit):
                continue
            _init.create(init or getattr(p, "mx_init", None) or "uniform") \
                .init_array(p.mx_name, p.data, generator)
            p.mx_initialized = True
        return self


HybridBlock = Block


class HybridSequential(Block):
    """Children registered as "0", "1", ... in insertion order."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]
