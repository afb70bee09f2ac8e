"""Weight initializers (counterpart of `mxnet_tpu/initializer.py`).

Each initializer fills a tensor in place. It draws from `generator` when
one is given, else from the device stream of the tensor's device
(`random.generator`), which `random.seed` reseeds, so `seed(s)` followed
by an initialisation repeats, as `_random.next_key()` makes it repeat in
the JAX package. Values are drawn in float32 and cast to the parameter's
dtype, as the JAX package does.
"""
from __future__ import annotations

import math

import torch

from . import random as _random

__all__ = ["Initializer", "Zero", "One", "Uniform", "Xavier", "create"]

# the JAX package's name rule (`Initializer.init_array`): these suffixes
# get zeros or ones whatever the initializer
_ZERO_NAMES = ("bias", "beta", "running_mean", "moving_mean")
_ONE_NAMES = ("gamma", "running_var", "moving_var")


class Initializer:
    def __call__(self, tensor, generator=None):
        if generator is None:
            generator = _random.generator(tensor.device)
        with torch.no_grad():
            tensor.copy_(self._init(tuple(tensor.shape), tensor.device,
                                    generator).to(tensor.dtype))
        return tensor

    def init_array(self, name, tensor, generator=None):
        """Fill `tensor`, the parameter called `name`, by the name rule:
        names ending in bias, beta, running_mean or moving_mean get
        zeros, names ending in gamma, running_var or moving_var ones,
        any other name this initializer."""
        lname = name.lower()
        if lname.endswith(_ZERO_NAMES):
            return Zero()(tensor, generator)
        if lname.endswith(_ONE_NAMES):
            return One()(tensor, generator)
        return self(tensor, generator)

    def _init(self, shape, device, generator):
        raise NotImplementedError


class Zero(Initializer):
    def _init(self, shape, device, generator):
        return torch.zeros(shape, device=device)


class One(Initializer):
    def _init(self, shape, device, generator):
        return torch.ones(shape, device=device)


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init(self, shape, device, generator):
        u = torch.rand(shape, generator=generator, device=device)
        return (u * 2.0 - 1.0) * self.scale


def _fan(shape, factor_type):
    hw = 1
    for d in shape[2:]:
        hw *= d
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    if factor_type == "avg":
        return (fan_in + fan_out) / 2.0
    if factor_type == "in":
        return fan_in
    return fan_out


class Xavier(Initializer):
    """`mx.init.Xavier(rnd_type, factor_type, magnitude)`: uniform on
    [-s, s] (or normal with std s), s = sqrt(magnitude / fan)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init(self, shape, device, generator):
        scale = math.sqrt(self.magnitude
                          / max(_fan(shape, self.factor_type), 1.0))
        if self.rnd_type == "uniform":
            u = torch.rand(shape, generator=generator, device=device)
            return (u * 2.0 - 1.0) * scale
        return scale * torch.randn(shape, generator=generator, device=device)


_REGISTRY = {"zeros": Zero, "ones": One, "uniform": Uniform,
             "xavier": Xavier}


def create(init):
    if isinstance(init, Initializer):
        return init
    return _REGISTRY[str(init).lower()]()
