"""Block (counterpart of `mxnet_tpu/gluon/block.py`).

A Block is a thin `torch.nn.Module`. Attribute paths name parameters
exactly as the JAX package's `collect_params()` does
(`gpt.layers.0.attn.qkv.weight`), so carrying weights between the two
packages is the identity on names. PyTorch runs eagerly, so there is
no hybridize/jit cache: `HybridBlock` is the same class.
"""
from __future__ import annotations

import re

import torch

from .. import context
from .. import initializer as _init

__all__ = ["Block", "HybridBlock", "HybridSequential"]


class Block(torch.nn.Module):
    def collect_params(self, select=None):
        """All parameters of this subtree keyed by dotted path
        (optionally filtered by a regex)."""
        return {path: p for path, p in self.named_parameters()
                if select is None or re.search(select, path)}

    def initialize(self, init=None, device=None, generator=None):
        """Fill every parameter in place: `init` when given, else the
        parameter's own initializer, else uniform (the JAX package's
        precedence). `device` moves the block first; `generator` is the
        explicit random source (its device must be the parameters')."""
        if device is not None:
            self.to(context.resolve(device))
        for _, p in self.named_parameters():
            _init.create(init or getattr(p, "mx_init", None) or "uniform")(
                p.data, generator)
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
