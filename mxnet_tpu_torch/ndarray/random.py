"""`mx.nd.random` (counterpart of `mxnet_tpu/ndarray/random.py`;
reference: `python/mxnet/ndarray/random.py`): the sampling ops of
`ops.random_ops` by their MXNet names. A draw without an array input
lands on `ctx` (the entered context's device, else the card)."""
from __future__ import annotations

from .ndarray import registry_op

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "randint", "multinomial", "shuffle"]


def _shape_of(shape):
    return (1,) if shape is None else shape


def _draw(op, out=None, **kwargs):
    res = registry_op(op)(**kwargs)
    if out is None:
        return res
    out._check_mutable()
    out._t = res._t
    return out


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    return _draw("_random_uniform", out, low=low, high=high,
                 shape=_shape_of(shape), dtype=dtype, ctx=ctx)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    return _draw("_random_normal", out, loc=loc, scale=scale,
                 shape=_shape_of(shape), dtype=dtype, ctx=ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None):
    return _draw("_random_gamma", alpha=alpha, beta=beta,
                 shape=_shape_of(shape), dtype=dtype, ctx=ctx)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None):
    return _draw("_random_exponential", lam=1.0 / scale,
                 shape=_shape_of(shape), dtype=dtype, ctx=ctx)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None):
    return _draw("_random_poisson", lam=lam, shape=_shape_of(shape),
                 dtype=dtype, ctx=ctx)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None):
    return _draw("_random_negative_binomial", k=k, p=p,
                 shape=_shape_of(shape), dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype="int32", ctx=None):
    return _draw("_random_randint", low=low, high=high,
                 shape=_shape_of(shape), dtype=dtype, ctx=ctx)


def multinomial(data, shape=None, get_prob=False, dtype="int32"):
    return registry_op("_sample_multinomial")(data, shape=shape,
                                              get_prob=get_prob, dtype=dtype)


def shuffle(data):
    return registry_op("shuffle")(data)

