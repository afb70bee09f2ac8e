"""NDArray (counterpart of `mxnet_tpu/ndarray/ndarray.py`).

An NDArray holds one torch tensor (`_t`) and appears only at the user's
boundary: the `nd.*` constructors, the output of a top-level
`Block.__call__` that was given an NDArray (the block's interior runs on
the plain tensors), `models.transformer.label_smoothing_loss` and the
`gluon.loss` blocks. Its operations run torch ops on the held tensor,
so inside `autograd.record()` they record as any torch op does.

Only what the eager training loop uses is ported: the constructors
`array`, `zeros`, `ones`, `full`, `arange`, `concatenate` and `waitall`;
`save` and `load` in the JAX package's two formats (below);
`shape`, `dtype` (a numpy dtype; bfloat16 is ml_dtypes', or a name that
equals "bfloat16" where ml_dtypes is missing), `size`,
`ndim`, `context`; `asnumpy` (bfloat16 comes back as float32),
`asscalar`, `item`, `astype`, `as_in_context`, `copy`, `detach`,
`attach_grad`, `grad`, `backward`; `reshape(shape=...)` with MXNet's
codes (0, -1, -2, -3, -4), `transpose(axes=...)`; arithmetic,
comparisons (0/1 in the left operand's dtype, as MXNet's), `argmax`
(float32 indices), `mean` and `sum` (with `axis`, `keepdims`,
`exclude`), `repeat`; and every op of the port's one op registry
(`ops.OPS`, by the JAX registry's names) as `nd.<name>` and as a
method (`x.flip(axis=1)`), as in the JAX package: the elementwise,
reduction, linear-algebra and ordering ops of `ops.math_ops`, the
network ops of `ops.nn_ops` (`FullyConnected`, `SoftmaxOutput`, ...),
the shape and indexing ops of `ops.shape_ops`, the detection ops
(`_contrib_box_nms`, ...; also as `nd.contrib.<name without
_contrib_>`), `RNN` and `ctc_loss` with its aliases; `out=` writes
the result into an NDArray. Any other op raises
`NotPortedError`, a NotImplementedError naming ROADMAP.md queue 1's
"The eager MXNet surface" that is also an AttributeError, so `hasattr`
and `getattr(x, name, None)` treat it as a missing attribute.

`nd.array(x)` without `ctx` puts x on the card (`context.resolve`);
`ctx=mx.cpu()` is the way onto the CPU. A float64 or int64 source
becomes float32 or int32 (MXNet's default dtypes), as in the JAX
package.

`save(fname, data, format="npz")` writes the JAX package's files byte
for byte: a numpy archive with its `__mx_meta__` entry ("single",
"list" or "dict"), or with `format="params"` the reference's dmlc::Stream
container (`params_io`; bf16 up-cast to float32 there, as the container
has no bf16 type). In the npz format a bf16 array is stored as the JAX
package stores it (ml_dtypes' bfloat16, which numpy reads back as a
2-byte void type); `load` reads that back as bf16 (the JAX package's own
`load` refuses it).
`load(fname, ctx=None)` sniffs the container magic and returns an
NDArray, a list or a dict of them on `ctx` (the card by default, as
`array`).
"""
from __future__ import annotations

import functools
import os
import weakref

import numpy as np
import torch

from .. import context
from .params_io import is_params_file, load_params, save_params

__all__ = ["NDArray", "NotPortedError", "array", "zeros", "ones", "full",
           "arange", "concatenate", "waitall", "save", "load"]

_NOT_PORTED = ("is not in the port yet (ROADMAP.md queue 1, \"The eager "
               "MXNet surface\")")
_NP = {torch.float32: np.dtype("float32"), torch.float16: np.dtype("float16"),
       torch.float64: np.dtype("float64"), torch.int32: np.dtype("int32"),
       torch.int64: np.dtype("int64"), torch.int8: np.dtype("int8"),
       torch.uint8: np.dtype("uint8"), torch.bool: np.dtype("bool")}
_TORCH = {v.name: k for k, v in _NP.items()}
_TORCH["bfloat16"] = torch.bfloat16
_DEFAULT = {torch.float64: torch.float32, torch.int64: torch.int32}


class NotPortedError(NotImplementedError, AttributeError):
    """A name of the JAX package's surface that the port lacks: a
    NotImplementedError (it names the queue item that will port it) and
    an AttributeError (so `hasattr` is False, as in the JAX package)."""


class _Bfloat16Name(str):
    """bfloat16 where numpy has no bfloat16 type (no ml_dtypes): equals
    and prints as "bfloat16", and is 2 bytes wide."""
    itemsize = 2


@functools.cache
def _bfloat16():
    """The numpy dtype of bfloat16 (ml_dtypes', as the JAX package's
    `NDArray.dtype` gives it), or a `_Bfloat16Name` without ml_dtypes."""
    try:
        import ml_dtypes
    except ImportError:
        return _Bfloat16Name("bfloat16")
    return np.dtype(ml_dtypes.bfloat16)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH[str(dtype) if isinstance(dtype, str)
                  else np.dtype(dtype).name]


def _unwrap(x):
    return x._t if isinstance(x, NDArray) else x


def _clear_for_write(ref):
    """A tensor hook: with grad_req 'write', the leaf's gradient is
    cleared before torch accumulates this backward's into it."""
    def hook(_):
        nd = ref()
        if nd is not None and nd.grad_req == "write":
            nd._t.grad = None
    return hook


def _grad_sync(ref):
    """A post-accumulate hook: the NDArray that `grad` returns follows
    the leaf's gradient buffer, whichever tensor torch left there."""
    def hook(t):
        nd = ref()
        if nd is not None and nd._grad is not None:
            nd._grad._t = t.grad
    return hook


class NDArray:
    __slots__ = ("_t", "_grad", "grad_req", "__weakref__")

    __array_priority__ = 1000.0     # beat numpy in mixed operator dispatch

    def __init__(self, tensor):
        self._t = tensor
        self._grad = None
        self.grad_req = "null"

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _registry():
            return functools.partial(registry_op(name), self)
        raise NotPortedError(f"NDArray.{name} {_NOT_PORTED}")

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        if self._t.dtype == torch.bfloat16:
            return _bfloat16()
        return _NP.get(self._t.dtype, self._t.dtype)

    @property
    def size(self):
        return self._t.numel()

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def context(self):
        return self._t.device

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # -- host interop ------------------------------------------------------
    def asnumpy(self):
        """A host copy (waits for the card); bfloat16 comes back as
        float32, which holds it exactly."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self._t.numel() != 1:
            raise ValueError("asscalar() needs an array of one element")
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __bool__(self):
        if self._t.numel() == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- autograd ----------------------------------------------------------
    def _mark(self, grad, grad_req):
        """Make the held tensor a fresh leaf that records into `grad`
        (an NDArray of its shape) by `grad_req`."""
        t = self._t = self._t.detach()
        self.grad_req = grad_req
        self._grad = None
        if grad_req == "null":
            return
        t.requires_grad_(True)
        t.grad = grad._t
        self._grad = grad
        ref = weakref.ref(self)
        t.register_hook(_clear_for_write(ref))
        t.register_post_accumulate_grad_hook(_grad_sync(ref))

    @property
    def grad(self):
        return self._grad

    def attach_grad(self, grad_req="write"):
        """Make this array a leaf that records its gradient, into a
        zeroed buffer (`grad`)."""
        self._mark(NDArray(torch.zeros_like(self._t)), grad_req)
        return self

    def detach(self):
        return NDArray(self._t.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- copies, devices and dtypes -----------------------------------------
    def copy(self):
        return NDArray(self._t.detach().clone())

    def as_in_context(self, ctx):
        return NDArray(self._t.to(context.resolve(ctx)))

    def astype(self, dtype, copy=True):
        out = self._t.to(_torch_dtype(dtype))
        return NDArray(out.clone() if copy and out is self._t else out)

    # -- shape -------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """MXNet's reshape: `reshape(shape)`, `reshape(*shape)` or
        `reshape(shape=...)`, with MXNet's codes (`shape_ops.reshape`)."""
        shape = kwargs.pop("shape", None) if not shape else shape
        if kwargs:
            raise NotPortedError(f"reshape({sorted(kwargs)}) {_NOT_PORTED}")
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = shape[0]
        from ..ops import shape_ops
        return NDArray(shape_ops.reshape(self._t, shape))

    def transpose(self, *axes, **kwargs):
        """MXNet's transpose: the axes in their new order (all reversed
        when none are given)."""
        axes = kwargs.pop("axes", None) if not axes else axes
        if kwargs:
            raise NotPortedError(f"transpose({sorted(kwargs)}) {_NOT_PORTED}")
        if axes and len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = axes[0]
        from ..ops import shape_ops
        return NDArray(shape_ops.transpose(self._t, axes))

    # -- reductions --------------------------------------------------------
    def _axes(self, axis, exclude):
        if axis is None:
            return None
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        if exclude:
            n = self._t.dim()
            axes = tuple(i for i in range(n) if i not in
                         {a % n for a in axes})
        return axes

    def sum(self, axis=None, keepdims=False, exclude=False):
        """The sum in the input's dtype (bool sums to int32), as jnp's."""
        t = self._t
        dt = torch.int32 if t.dtype == torch.bool else t.dtype
        axes = self._axes(axis, exclude)
        return NDArray(t.sum(dtype=dt) if axes is None else
                       t.sum(dim=axes, keepdim=keepdims, dtype=dt))

    def mean(self, axis=None, keepdims=False, exclude=False):
        t = self._t
        if not t.is_floating_point():
            t = t.float()
        axes = self._axes(axis, exclude)
        return NDArray(t.mean() if axes is None else
                       t.mean(dim=axes, keepdim=keepdims))

    def repeat(self, repeats, axis=None):
        """Each element `repeats` times along `axis` (the flattened
        array when None), as `jnp.repeat`."""
        from ..ops import shape_ops
        return NDArray(shape_ops.repeat(self._t, repeats, axis))

    def argmax(self, axis=None, keepdims=False):
        """Indices of the maxima as float32, as MXNet returns them."""
        return NDArray(torch.argmax(self._t, dim=axis, keepdim=keepdims)
                       .to(torch.float32))

    # -- operators ---------------------------------------------------------
    def _other(self, o):
        if isinstance(o, NDArray):
            return o._t
        if isinstance(o, (int, float, bool)):
            return o
        return array(o, ctx=self._t.device)._t

    def __add__(self, o):
        return NDArray(self._t + self._other(o))

    __radd__ = __add__

    def __sub__(self, o):
        return NDArray(self._t - self._other(o))

    def __rsub__(self, o):
        return NDArray(self._other(o) - self._t)

    def __mul__(self, o):
        return NDArray(self._t * self._other(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return NDArray(self._t / self._other(o))

    def __rtruediv__(self, o):
        return NDArray(self._other(o) / self._t)

    def __mod__(self, o):
        return NDArray(self._t % self._other(o))

    def __pow__(self, o):
        return NDArray(self._t ** self._other(o))

    def __rpow__(self, o):
        return NDArray(self._other(o) ** self._t)

    def __neg__(self):
        return NDArray(-self._t)

    def __abs__(self):
        return NDArray(self._t.abs())

    def _compare(self, o, op):
        return NDArray(op(self._t, self._other(o)).to(self._t.dtype))

    def __eq__(self, o):
        return self._compare(o, torch.eq)

    def __ne__(self, o):
        return self._compare(o, torch.ne)

    def __gt__(self, o):
        return self._compare(o, torch.gt)

    def __ge__(self, o):
        return self._compare(o, torch.ge)

    def __lt__(self, o):
        return self._compare(o, torch.lt)

    def __le__(self, o):
        return self._compare(o, torch.le)

    __hash__ = object.__hash__


# -- constructors ------------------------------------------------------------

def array(source, ctx=None, dtype=None):
    """An NDArray of `source` (an NDArray, tensor, numpy array or nested
    list) on `ctx` (the card unless the caller names another device)."""
    dev = context.resolve(ctx)
    if isinstance(source, NDArray):
        t = source._t
    elif isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        a = np.asarray(source)
        if a.dtype.name in _TORCH or a.dtype == np.float64:
            t = torch.from_numpy(np.array(a))
        else:
            t = torch.tensor(a.tolist())
        if dtype is None:
            t = t.to(_DEFAULT.get(t.dtype, t.dtype))
    if dtype is not None:
        t = t.to(_torch_dtype(dtype))
    return NDArray(t.to(dev))


def zeros(shape, ctx=None, dtype="float32"):
    return NDArray(torch.zeros(shape, dtype=_torch_dtype(dtype),
                               device=context.resolve(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    return NDArray(torch.ones(shape, dtype=_torch_dtype(dtype),
                              device=context.resolve(ctx)))


def full(shape, val, ctx=None, dtype="float32"):
    return NDArray(torch.full(shape, val, dtype=_torch_dtype(dtype),
                              device=context.resolve(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=_torch_dtype(dtype),
                       device=context.resolve(ctx))
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return NDArray(out)


def concatenate(arrays, axis=0):
    return NDArray(torch.cat([_unwrap(a) for a in arrays], dim=axis))


def waitall():
    """Wait until the card has finished everything queued."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _saved_array(t):
    """A tensor (or NDArray) as the numpy array the JAX package's `nd.save`
    writes: a bf16 tensor as ml_dtypes' bfloat16 (where ml_dtypes is
    missing, as raw 2-byte elements: the same data under numpy's `|V2`
    in place of `<V2`), any other dtype as itself."""
    t = _unwrap(t).detach()
    if t.dtype == torch.bfloat16:
        bf16 = _bfloat16()
        return t.cpu().view(torch.int16).numpy().view(
            bf16 if isinstance(bf16, np.dtype) else "V2")
    return t.cpu().numpy()


def _loaded_tensor(a):
    """The tensor of a loaded array: a 2-byte void array (a bf16 array
    saved by either package) becomes bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save(fname, data, format="npz"):  # noqa: A002 - the JAX signature
    """Save an NDArray, a list or a dict of NDArrays (or tensors):
    format='npz' a numpy archive with an `__mx_meta__` entry,
    format='params' the reference's binary container (`params_io`).
    Either file equals the JAX package's for the same arrays, byte for
    byte; `load` reads both."""
    if isinstance(data, (NDArray, torch.Tensor)):
        arrays, names, meta = [data], None, "single"
    elif isinstance(data, (list, tuple)):
        arrays, names, meta = list(data), None, "list"
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays, meta = [data[k] for k in names], "dict"
    else:
        raise TypeError(type(data))
    if format == "params":
        # the container has no bf16 type: up-cast, as the JAX package does
        arrays = [_unwrap(a).float() if _unwrap(a).dtype == torch.bfloat16
                  else a for a in arrays]
        save_params(fname, [_saved_array(a) for a in arrays], names or [])
        return
    if format != "npz":
        raise ValueError(f"unknown format '{format}' (npz|params)")
    keys = names if names is not None else [f"arr_{i}"
                                            for i in range(len(arrays))]
    payload = {k: _saved_array(a) for k, a in zip(keys, arrays)}
    # a file object keeps the EXACT filename (no ".npz" appended)
    with open(fname, "wb") as f:
        np.savez(f, __mx_meta__=meta, **payload)


def load_arrays(fname):
    """(kind, arrays) of a file `save` wrote: kind "single", "list" or
    "dict"; arrays a list of tensors (CPU), or a dict for "dict"."""
    if not os.path.exists(fname) and os.path.exists(fname + ".npz"):
        fname = fname + ".npz"
    if is_params_file(fname):
        arrays, names = load_params(fname)
        arrays = [_loaded_tensor(a) for a in arrays]
        if names:
            return "dict", dict(zip(names, arrays))
        return "single" if len(arrays) == 1 else "list", arrays
    with np.load(fname, allow_pickle=False) as z:
        meta = str(z["__mx_meta__"])
        items = {k: _loaded_tensor(z[k]) for k in z.files
                 if k != "__mx_meta__"}
    if meta == "dict":
        return meta, items
    return meta, [items[f"arr_{i}"] for i in range(len(items))]


def load(fname, ctx=None):
    """Load what `save` (of either package) wrote: an NDArray, a list or a
    dict of NDArrays on `ctx` (the card unless the caller names another
    device)."""
    dev = context.resolve(ctx)
    kind, arrays = load_arrays(fname)
    if kind == "dict":
        return {k: NDArray(t.to(dev)) for k, t in arrays.items()}
    out = [NDArray(t.to(dev)) for t in arrays]
    return out[0] if kind == "single" else out


def _registry():
    """The op registry (`ops.OPS`), imported at first use: `ops` imports
    modules that import this one."""
    from .. import ops
    return ops.OPS


def _wrap(out):
    if isinstance(out, tuple):
        return tuple(NDArray(o) for o in out)
    return NDArray(out)


def registry_op(name):
    """The registry op `name` on NDArrays: the port's op on the held
    tensors (positional and keyword arguments alike), NDArray (or a
    tuple of them) out. `out=` writes the result into that NDArray."""
    fn = _registry()[name]

    def op(*args, out=None, **kwargs):
        res = _wrap(fn(*[_unwrap(a) for a in args],
                       **{k: _unwrap(v) for k, v in kwargs.items()}))
        if out is None:
            return res
        out._t = res._t
        return out
    op.__name__ = name
    op.__doc__ = fn.__doc__
    return op


def __getattr__(name):
    if name == "OPS":
        return _registry()
    if name in _registry():
        return registry_op(name)
    if name.startswith("_") and not name.startswith("_contrib_"):
        raise AttributeError(name)
    raise NotPortedError(f"nd.{name} {_NOT_PORTED}")
