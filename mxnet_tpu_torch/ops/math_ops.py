"""Elementwise, broadcast, reduction and linear-algebra ops (counterpart of
`mxnet_tpu/ops/math_ops.py`; reference: `src/operator/tensor/
elemwise_binary_op_basic.cc`, `elemwise_unary_op_basic.cc`,
`broadcast_reduce_op_value.cc`, `dot-inl.h`, `la_op.cc`,
`ordering_op.cc`).

Every registration of the JAX module, under its MXNet name and
parameters, on torch tensors, with the JAX ops' dtypes where torch's
differ: comparisons return the left operand's dtype (0/1), `argmax`,
`argmin`, `argsort` and `topk` return float32 indices unless `dtype`
says otherwise, an integer sum, product or cumulative sum stays in its
dtype (a bool sum is int32), an integer mean is float32. `topk`, `sort`
and `argsort` order ties as `lax.top_k` and `jnp.argsort` do (a stable
sort: the lower index first; a descending `sort`/`argsort` is the
ascending one reversed). The `linalg_*` family runs `torch.linalg` in
float32; `linalg_syevd` and `linalg_gelqf` are unique up to the sign of
each vector, as LAPACK leaves it. `_zeros` and `_ones` make their tensor
on the entered context's device (the card unless the caller asks for the
CPU), as every entry point does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from . import register, alias


def _dtype(dtype):
    from ..ndarray.ndarray import _torch_dtype
    return _torch_dtype(dtype)


# --------------------------------------------------------------------------
# elementwise binary (same-shape or numpy-broadcast)
# --------------------------------------------------------------------------

_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
    "elemwise_div": torch.true_divide,
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
}
for _name, _fn in _BINARY.items():
    register(_name)(lambda lhs, rhs, _fn=_fn: _fn(lhs, rhs))

_CMP = {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}
for _name, _fn in _CMP.items():
    # MXNet comparison ops return the lhs dtype (0.0/1.0), not bool
    register(_name)(lambda lhs, rhs, _fn=_fn: _fn(lhs, rhs).to(lhs.dtype))


def _same(fn):
    """A comparison of an array with a scalar, in the array's dtype."""
    return lambda a, s: fn(a, s).to(a.dtype)


for _scalar_name, _base in [
    ("_plus_scalar", torch.add), ("_minus_scalar", torch.sub),
    ("_rminus_scalar", lambda a, s: s - a),
    ("_mul_scalar", torch.mul), ("_div_scalar", torch.true_divide),
    ("_rdiv_scalar", lambda a, s: s / a),
    ("_power_scalar", torch.pow), ("_rpower_scalar", lambda a, s: s ** a),
    ("_mod_scalar", torch.remainder),
    ("_maximum_scalar", torch.clamp_min), ("_minimum_scalar",
                                           torch.clamp_max),
    ("_equal_scalar", _same(torch.eq)),
    ("_not_equal_scalar", _same(torch.ne)),
    ("_greater_scalar", _same(torch.gt)),
    ("_greater_equal_scalar", _same(torch.ge)),
    ("_lesser_scalar", _same(torch.lt)),
    ("_lesser_equal_scalar", _same(torch.le)),
]:
    register(_scalar_name)(lambda data, scalar, _b=_base: _b(data, scalar))


# --------------------------------------------------------------------------
# elementwise unary
# --------------------------------------------------------------------------

def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "round": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc,
    "square": torch.square, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "reciprocal": torch.reciprocal,
    "negative": torch.neg,
    "logical_not": lambda x: torch.logical_not(x).to(x.dtype),
    "sigmoid": torch.sigmoid,
    "softsign": tF.softsign,
    "relu": torch.relu,
    "hard_sigmoid": lambda x, alpha=0.2, beta=0.5:
        torch.clamp(alpha * x + beta, 0, 1),
}
for _name, _fn in _UNARY.items():
    register(_name)(lambda data, _fn=_fn, **kw: _fn(data, **kw))


@register("clip")
def clip(data, a_min, a_max):
    return torch.clamp(data, a_min, a_max)


@register("cast")
def cast(data, dtype):
    return data.to(_dtype(dtype))


# the JAX package registers this alias in misc_ops.py
alias("Cast", "cast")


@register("copy")
def copy(data):
    return data.clone()


# --------------------------------------------------------------------------
# reductions (reference: `src/operator/tensor/broadcast_reduce_op_value.cc`)
# --------------------------------------------------------------------------

def _axes(data, axis, exclude=False):
    """The reduced axes as a tuple (every axis for None), `exclude`
    taking the complement."""
    if axis is None:
        return tuple(range(data.dim()))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % max(data.dim(), 1) for a in ax)
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


def _keep_int(data):
    """The dtype jnp reduces an integer or bool array to (its own; bool
    int32), or None for floats."""
    if data.dtype == torch.bool:
        return torch.int32
    return None if data.is_floating_point() else data.dtype


def _reduce(fn):
    def op(data, axis=None, keepdims=False, exclude=False):
        return fn(data, _axes(data, axis, exclude), keepdims)
    return op


def _sum(x, axes, keep):
    dt = _keep_int(x)
    return torch.sum(x, dim=axes, keepdim=keep, dtype=dt) if axes else \
        x.to(dt or x.dtype).clone()


def _mean(x, axes, keep):
    x = x if x.is_floating_point() else x.float()
    return torch.mean(x, dim=axes, keepdim=keep) if axes else x.clone()


def _prod(x, axes, keep):
    dt = _keep_int(x) or x.dtype
    out = x.to(dt)
    for a in sorted(axes, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keep, dtype=dt)
    return out


def _nansum(x, axes, keep):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return _sum(x, axes, keep)


def _nanprod(x, axes, keep):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keep)


def _max(x, axes, keep):
    return torch.amax(x, dim=axes, keepdim=keep) if axes else x.clone()


def _min(x, axes, keep):
    return torch.amin(x, dim=axes, keepdim=keep) if axes else x.clone()


register("sum")(_reduce(_sum))
register("mean")(_reduce(_mean))
register("prod")(_reduce(_prod))
register("nansum")(_reduce(_nansum))
register("nanprod")(_reduce(_nanprod))
register("max")(_reduce(_max))
register("min")(_reduce(_min))
alias("sum_axis", "sum")


@register("cumsum")
def cumsum(a, axis=None, dtype=None):
    """Reference mx.nd.cumsum: axis=None sums over the flattened array."""
    dt = _dtype(dtype) if dtype else (_keep_int(a) or a.dtype)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.cumsum(a, dim=axis, dtype=dt)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):  # noqa: A002
    axes = _axes(data, axis)
    if ord == 1:
        return torch.sum(torch.abs(data), dim=axes, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)        # MXNet returns float indices


@register("argmax")
def argmax(data, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


# --------------------------------------------------------------------------
# linalg (reference: `src/operator/tensor/dot-inl.h`, `la_op.cc`)
# --------------------------------------------------------------------------

def _t(x, flag):
    return x.transpose(-1, -2) if flag else x


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: the last axis of a with the first axis of b."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    return torch.matmul(_t(lhs, transpose_a), _t(rhs, transpose_b))


@register("linalg_gemm")
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register("linalg_gemm2")
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register("linalg_potrf")
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register("linalg_trsm")
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    a = _t(A, transpose)
    low = lower != transpose
    if rightside:
        x = torch.linalg.solve_triangular(
            a.transpose(-1, -2), B.transpose(-1, -2),
            upper=low).transpose(-1, -2)
    else:
        x = torch.linalg.solve_triangular(a, B, upper=not low)
    return alpha * x


@register("linalg_syrk")
def linalg_syrk(A, transpose=False, alpha=1.0):
    a = _t(A, transpose)
    return alpha * torch.matmul(a, a.transpose(-1, -2))


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


# --------------------------------------------------------------------------
# ordering (reference: `src/operator/tensor/ordering_op.cc`)
# --------------------------------------------------------------------------

@register("topk")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    moved = data.movedim(axis, -1)
    # a stable sort puts the lower index first among equals, as
    # lax.top_k does (of -x when ascending)
    vals, idx = torch.sort(moved, dim=-1, descending=not is_ascend,
                           stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros(moved.shape, dtype=_dtype(dtype),
                           device=data.device)
        mask.scatter_(-1, idx, 1)
        return mask.movedim(-1, axis)
    vals = vals.movedim(-1, axis)
    idx = idx.movedim(-1, axis).to(_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    raise ValueError(ret_typ)


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(_dtype(dtype))


# --------------------------------------------------------------------------
# creation ops with no inputs (reference: src/operator/tensor/init_op.cc)
# --------------------------------------------------------------------------

@register("_zeros")
def _zeros_op(shape=(), dtype="float32", ctx=None):
    from .. import context
    return torch.zeros(tuple(shape), dtype=_dtype(dtype),
                       device=context.resolve(ctx))


@register("_ones")
def _ones_op(shape=(), dtype="float32", ctx=None):
    from .. import context
    return torch.ones(tuple(shape), dtype=_dtype(dtype),
                      device=context.resolve(ctx))


# ---------------------------------------------------------------------------
# extended linalg family (reference src/operator/tensor/la_op.cc)
# ---------------------------------------------------------------------------

@register("linalg_syevd")
def linalg_syevd(A):
    """Symmetric eigendecomposition: (U, L) with A = U^T diag(L) U (rows
    of U are eigenvectors, each up to its sign)."""
    w, v = torch.linalg.eigh(A.float())
    return v.transpose(-1, -2), w


@register("linalg_gelqf")
def linalg_gelqf(A):
    """LQ factorisation A = L Q with Q row-orthonormal (each row of Q and
    column of L up to its sign)."""
    q, r = torch.linalg.qr(A.float().transpose(-1, -2))
    return r.transpose(-1, -2), q.transpose(-1, -2)


@register("linalg_inverse")
def linalg_inverse(A):
    return torch.linalg.inv(A.float())


@register("linalg_det")
def linalg_det(A):
    return torch.linalg.det(A.float())


@register("linalg_slogdet")
def linalg_slogdet(A):
    sign, logabs = torch.linalg.slogdet(A.float())
    return sign, logabs


@register("linalg_makediag")
def linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=offset)


@register("linalg_extractdiag")
def linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower):
    """Triangle selection shared by maketrian/extracttrian (offset > 0
    the upper triangle from that super-diagonal, offset < 0 the lower
    from that sub-diagonal; at offset 0 `lower` picks the side)."""
    if offset > 0:
        return np.triu_indices(n, k=offset)
    if offset < 0:
        return np.tril_indices(n, k=offset)
    return np.tril_indices(n) if lower else np.triu_indices(n)


@register("linalg_maketrian")
def linalg_maketrian(A, offset=0, lower=True):
    """Pack a vector of triangle entries into a triangular matrix."""
    k = A.shape[-1]
    n = int((math.sqrt(8 * k + 1) - 1) / 2) + abs(offset)
    rows, cols = _trian_indices(n, offset, lower)
    out = A.new_zeros(A.shape[:-1] + (n, n))
    out[..., torch.as_tensor(rows[:k]), torch.as_tensor(cols[:k])] = A
    return out


@register("linalg_extracttrian")
def linalg_extracttrian(A, offset=0, lower=True):
    rows, cols = _trian_indices(A.shape[-1], offset, lower)
    return A[..., torch.as_tensor(rows), torch.as_tensor(cols)]


@register("digamma")
def digamma(data):
    return torch.digamma(data)


@register("log_sigmoid")
def log_sigmoid(data):
    return tF.logsigmoid(data)


@register("mish")
def mish(data):
    return tF.mish(data)


@register("linalg_trmm")
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Triangular matrix multiply: alpha * op(tri(A)) * B (or B * op)."""
    tri = torch.tril(A) if lower else torch.triu(A)
    tri = _t(tri, transpose)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out
