"""Sampling ops (counterpart of `mxnet_tpu/ops/random_ops.py`; reference:
`src/operator/random/sample_op.cc`, `multisample_op.cc`).

Each op draws from the port's device stream of the device it runs on
(`random.generator`, seeded by `random.seed`), through an explicit
generator: an op with an array input on that array's device, any other
on `ctx` (the entered context's device, else the card). The streams are
not the JAX package's, so the two packages agree in distribution, not
in values. torch's gamma sampler takes no generator, so gamma draws
(and the negative binomial's rates) come from Marsaglia and Tsang's
rejection method over the stream's normals and uniforms.
"""
from __future__ import annotations

import math

import torch

from . import register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dtype(dtype):
    from ..ndarray.ndarray import _torch_dtype
    return _torch_dtype(dtype)


def _stream(ctx=None, like=None):
    """(device, generator) of a draw: `like`'s device, else `ctx`'s."""
    from .. import context, random
    dev = like.device if like is not None else context.resolve(ctx)
    return dev, random.generator(dev)


def _gamma(alpha, shape, dev, gen):
    """Gamma(alpha, 1) float32 samples of `shape` (alpha a float)."""
    alpha = float(alpha)
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        k = todo.numel()
        x = torch.randn(k, generator=gen, device=dev)
        u = torch.rand(k, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38))
                        < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-38)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(n, generator=gen, device=dev)
        out = out * u.clamp_min(1e-38) ** (1.0 / alpha)
    return out.reshape(shape)


@register("_random_uniform")
def random_uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None):
    dev, gen = _stream(ctx)
    u = torch.rand(_shape(shape), generator=gen, device=dev)
    return (low + (high - low) * u).to(_dtype(dtype))


@register("_random_normal")
def random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None):
    dev, gen = _stream(ctx)
    z = torch.randn(_shape(shape), generator=gen, device=dev)
    return (loc + scale * z).to(_dtype(dtype))


@register("_random_gamma")
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None):
    dev, gen = _stream(ctx)
    return (beta * _gamma(alpha, _shape(shape), dev, gen)).to(_dtype(dtype))


@register("_random_exponential")
def random_exponential(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev, gen = _stream(ctx)
    e = torch.empty(_shape(shape), device=dev).exponential_(generator=gen)
    return (e / lam).to(_dtype(dtype))


@register("_random_poisson")
def random_poisson(lam=1.0, shape=None, dtype="float32", ctx=None):
    dev, gen = _stream(ctx)
    rates = torch.full(_shape(shape), float(lam), device=dev)
    return torch.poisson(rates, generator=gen).to(_dtype(dtype))


@register("_random_negative_binomial")
def random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                             ctx=None):
    dev, gen = _stream(ctx)
    rate = _gamma(k, _shape(shape), dev, gen) * (1 - p) / p
    return torch.poisson(rate, generator=gen).to(_dtype(dtype))


@register("_random_randint")
def random_randint(low=0, high=1, shape=None, dtype="int32", ctx=None):
    dev, gen = _stream(ctx)
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=dev).to(_dtype(dtype))


@register("_sample_multinomial")
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """data: (..., k) probabilities; draws `shape` samples from each
    distribution (one, with that axis dropped, when shape is empty)."""
    dev, gen = _stream(like=data)
    out_shape = _shape(shape)
    n = max(math.prod(out_shape), 1)
    logits = torch.log(data.float().clamp_min(1e-37))
    probs = torch.softmax(logits, -1).reshape(-1, data.shape[-1])
    samples = torch.multinomial(probs, n, replacement=True, generator=gen)
    samples = samples.reshape(data.shape[:-1] + (n,))
    samples = samples.reshape(data.shape[:-1] + out_shape) if out_shape \
        else samples[..., 0]
    out = samples.to(_dtype(dtype))
    if get_prob:
        logp = torch.gather(
            torch.log_softmax(logits, -1), -1,
            samples.reshape(data.shape[:-1] + (-1,))).reshape(samples.shape)
        return out, logp
    return out


@register("shuffle")
def shuffle(data):
    """A random permutation of the rows (axis 0)."""
    dev, gen = _stream(like=data)
    return data[torch.randperm(data.shape[0], generator=gen, device=dev)]


@register("_sample_unique_zipfian")
def sample_unique_zipfian(range_max, shape=None, ctx=None):
    """Zipfian draws in [0, range_max) by an exponentiated uniform (the
    JAX package's approximation, used by sampled softmax)."""
    dev, gen = _stream(ctx)
    u = torch.rand(_shape(shape), generator=gen, device=dev)
    out = torch.exp(u * math.log(float(range_max) + 1.0)).long() - 1
    return out.clamp(0, range_max - 1)
