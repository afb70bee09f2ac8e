"""Weight initializers (counterpart of `mxnet_tpu/initializer.py`;
reference: `python/mxnet/initializer.py`).

The surface is the JAX package's: `init(shape, dtype)` returns a new
tensor, `init.init_array(name, shape, dtype)` returns one by the name
rule, `create(init, **kwargs)` makes one from a name (`create(None)` is
`Uniform()`), and the classes are registered in a `base.Registry` under
the JAX package's names. The tensor is made on `device`, else on the
card unless the caller asks for the CPU (`context.resolve`: an entered
`mx.cpu()` is such a request).

It draws from `generator` when one is given, else from the device stream
of its device (`random.generator`), which `random.seed` reseeds, so
`seed(s)` followed by an initialisation repeats, as `_random.next_key()`
makes it repeat in the JAX package. The two packages' streams differ by
design, so the same seed gives the same distribution, not the same
numbers. Values are drawn in float32 and cast to the dtype, as the JAX
package does. `Bilinear` draws nothing and equals the JAX package's.
`Orthogonal` takes Q · sign(diag R) of the QR factorisation of a normal
draw, as the JAX package does: that is the one factor whose R has a
positive diagonal, so LAPACK's sign choices (torch's and jnp's may
differ) cannot change the result, and the same draw gives the same
matrix in both packages.

`Block.initialize` and a deferred parameter's first forward fill
parameters in place through `_fill`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import context
from . import random as _random
from .base import Registry

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "create",
           "register"]

_registry = Registry("initializer")
register = _registry.register

# the JAX package's name rule (`Initializer.init_array`): these suffixes
# get zeros or ones whatever the initializer
_ZERO_NAMES = ("bias", "beta", "running_mean", "moving_mean")
_ONE_NAMES = ("gamma", "running_var", "moving_var")


def _dtype(dtype):
    from .ndarray.ndarray import _torch_dtype
    return _torch_dtype(dtype)


class Initializer:
    """Base initializer: produces a tensor for (shape, dtype)."""

    def __call__(self, shape, dtype="float32", *, device=None,
                 generator=None):
        dev = context.resolve(device)
        if generator is None:
            generator = _random.generator(dev)
        return self._init(tuple(shape), dev, generator).to(_dtype(dtype))

    def _init(self, shape, device, generator):
        raise NotImplementedError

    def init_array(self, name, shape, dtype="float32", *, device=None,
                   generator=None):
        """The tensor of the parameter `name` by the name rule: names
        ending in bias, beta, running_mean or moving_mean get zeros,
        names ending in gamma, running_var or moving_var ones, any other
        name this initializer."""
        lname = name.lower()
        if lname.endswith(_ZERO_NAMES):
            init = Zero()
        elif lname.endswith(_ONE_NAMES):
            init = One()
        else:
            init = self
        return Initializer.__call__(init, shape, dtype, device=device,
                                    generator=generator)


def _fill(init, name, tensor, generator=None):
    """Fill `tensor`, the parameter called `name`, in place by
    `init.init_array`'s rule, on its device and in its dtype."""
    with torch.no_grad():
        tensor.copy_(init.init_array(name, tensor.shape, tensor.dtype,
                                     device=tensor.device,
                                     generator=generator))
    return tensor


@register("zeros")
class Zero(Initializer):
    def _init(self, shape, device, generator):
        return torch.zeros(shape, device=device)


@register("ones")
class One(Initializer):
    def _init(self, shape, device, generator):
        return torch.ones(shape, device=device)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init(self, shape, device, generator):
        return torch.full(shape, float(self.value), device=device)


@register("uniform")
class Uniform(Initializer):
    """Uniform on [-scale, scale]."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init(self, shape, device, generator):
        u = torch.rand(shape, generator=generator, device=device)
        return (u * 2.0 - 1.0) * self.scale


@register("normal")
class Normal(Initializer):
    """Normal with mean 0 and standard deviation `sigma`."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init(self, shape, device, generator):
        return self.sigma * torch.randn(shape, generator=generator,
                                        device=device)


def orthogonal_factor(a):
    """Q · sign(diag R) of a's reduced QR factorisation: the orthonormal
    factor whose R has a positive diagonal (unique for a of full rank)."""
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))


@register("orthogonal")
class Orthogonal(Initializer):
    """`scale` times an orthonormal (rows, prod(rest)) matrix from a
    normal draw of (max, min) of the two sides; `rand_type` is accepted
    and, as in the JAX package, the draw is normal."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale

    def _init(self, shape, device, generator):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        a = torch.randn((max(rows, cols), min(rows, cols)),
                        generator=generator, device=device)
        q = orthogonal_factor(a)
        q = q.T if rows < cols else q
        return self.scale * q[:rows, :cols].reshape(shape)


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


@register("xavier")
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


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He initialisation for PReLU: Xavier("gaussian", factor_type,
    2 / (1 + slope^2))."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register("bilinear")
class Bilinear(Initializer):
    """The bilinear upsampling kernel (an (…, H, W) weight), as the JAX
    package computes it, element by element on the host."""

    def _init(self, shape, device, generator):
        weight = np.zeros(shape, dtype="float32")
        f = shape[3] // 2 if len(shape) == 4 else 1
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        flat = weight.reshape(-1)
        for i in range(flat.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(flat.reshape(shape)).to(device)


def create(init, **kwargs):
    """An initializer from an instance (returned as it is), a registered
    name with the class's keyword arguments, or None (`Uniform()`)."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        return _registry.get(init)(**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")
