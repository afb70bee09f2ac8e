"""Parameters (counterpart of `mxnet_tpu/gluon/parameter.py`).

A parameter is a `Parameter`, a subclass of `torch.nn.Parameter`, built
as the JAX package's is: `Parameter(name, shape=None, dtype="float32",
init=None, grad_req="write", differentiable=True,
allow_deferred_init=False)`. It remembers its own initializer, so
`Block.initialize()` can apply the JAX package's rule: the initializer
passed to `initialize`, else the parameter's own, else uniform. It also
remembers whether it was initialised (`mx_initialized`, set by
`initialize` and by `weights.load_named_arrays`): a second
`initialize()` leaves it alone unless `force_reinit=True`. It also
carries the JAX package's `grad_req` ('write' trains it, 'null' leaves
it out of training). The tensor itself records no gradient until a
recorded forward (`Block._attach_grads`) or MXNet's `initialize` asks
it to, so serving builds no autograd graph and holds no gradient
buffer: `ShardedTrainer` substitutes views of its flat float32 master
(which do record gradients) for every parameter whose grad_req is not
'null'. Storage is allocated on torch's current default device, which
the model constructors set to the model's device (`with
torch.device(...)`); a parameter allocated outside such a block (a
bare gluon layer) is unplaced (`mx_placed` False), and
`Block.initialize` without `ctx` puts it on the default device, as the
JAX package's `initialize` does.

MXNet's accessors, and the rule that makes them and torch's agree:
`p.data` and `p.grad` stay torch's, tensors (and `p.grad` None until a
gradient exists), so `collect_params()`' values, `p.data.copy_(...)`,
`nn.Module._apply`, `load_state_dict` and the optimizers' `p.grad is
None` work unchanged. Each is returned callable: `p.data` is torch's
detached alias of the storage as a `_DataView`, `p.grad` is torch's
gradient tensor itself with its class switched to `_GradView` (the same
object, so `p.grad is p.grad`). Both tensor subclasses have
`__torch_function__` disabled, so ops on them give plain tensors, and
pickle as plain tensors. Calling them gives MXNet's NDArrays:
`p.data(ctx=None)` an NDArray that holds the parameter itself (ops on it
record into the parameter's gradient; an assignment writes into it in
place), `p.grad(ctx=None)` one that reads and writes whatever tensor
the parameter's gradient is now (a 'write' backward replaces it). A
gradient buffer, zeroed, is made where MXNet would have one: by
`Parameter.initialize` and `ParameterDict.initialize`, at a block's
first recorded forward, and by `p.data().grad` and `list_grad()`; never
by `Block.initialize`, so a model that is only served has none. Before
its first recorded forward a block's parameter has `p.grad` None, so
`p.grad()` raises TypeError there, where the JAX package gives zeros.
`set_data` takes an NDArray, a tensor or an array-like; `list_data`,
`list_grad`, `list_ctx`, `zero_grad`, `cast` and the `shape` setter of
a deferred parameter are the JAX package's. The rejected alternative:
`collect_params()` returning MXNet parameter objects that wrap the torch
ones, with block attributes resolving to them, which would break
`self.weight` as a tensor in every `forward` of the port.

A `Constant` is a 'null' parameter that holds a given value of any dtype
(int8 included) and that `Block.initialize` leaves alone.

A shape with a 0 in it is deferred, as the JAX package's
`allow_deferred_init` parameters are (a shape of None is too, its rank
unknown as well): the tensor holds no element until its layer's first
forward (`finish_deferred`), the `shape` setter or
`weights.load_named_arrays` gives it the missing dimensions.
`Block.initialize` records its choice on a deferred parameter
(`mx_init_requested`) without drawing; `finish_deferred` then fills it by
`Initializer.init_array`'s name rule from that choice, on the input's
device and from the stream `initialize` would have drawn from.
"""
from __future__ import annotations

import copy
import weakref

import numpy as np
import torch

from ..ndarray.ndarray import NDArray, _unwrap

__all__ = ["Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "dtype_of", "finish_deferred",
           "set_data", "zero_grad"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class DeferredInitializationError(RuntimeError):
    """A parameter whose shape is not known yet was asked for its data."""


def _placed():
    """Whether storage allocated now goes where a caller asked: inside a
    `with torch.device(...)` block, or under a non-CPU default device."""
    stack = getattr(torch.overrides, "_get_current_function_mode_stack",
                    lambda: [])()
    return (torch.get_default_device().type != "cpu"
            or any(type(m).__name__ == "DeviceContext" for m in stack))


def dtype_of(dtype):
    """torch dtype for a JAX-package dtype name (or a torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


_DATA = torch._C.TensorBase.data      # torch's own accessors, which
_GRAD = torch._C.TensorBase.grad      # the properties below go through
_SHAPE = torch._C.TensorBase.shape


class _DataView(torch.Tensor):
    """What `p.data` gives: torch's detached alias of the parameter's
    storage, callable as MXNet's `p.data(ctx=None)` (the NDArray of the
    parameter). Ops on it give plain tensors; it pickles as one."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    def __call__(self, ctx=None):
        return self._mx_param._nd()

    def __reduce_ex__(self, proto):
        return self.as_subclass(torch.Tensor).__reduce_ex__(proto)

    def __deepcopy__(self, memo):
        return copy.deepcopy(self.as_subclass(torch.Tensor), memo)


class _GradView(_DataView):
    """What `p.grad` gives when a gradient exists: torch's gradient
    tensor itself (the same object, its class switched), callable as
    MXNet's `p.grad(ctx=None)` (an NDArray that follows the parameter's
    gradient)."""

    def __call__(self, ctx=None):
        p = self.__dict__["_mx_param"]()
        return NDArray(self) if p is None else _GradND(p)


class _ParamND(NDArray):
    """`p.data()`: the NDArray of a parameter. It holds the parameter
    itself, so ops on it record gradients into the parameter's; an
    assignment (`x[:] = ...`, `copyto`, `out=`) writes into the
    parameter in place; `grad` is the gradient's NDArray (a zeroed buffer
    is made on first use, MXNet's buffer)."""
    __slots__ = ("_param",)

    def __init__(self, p):
        self._param = p
        self._grad = None
        self.grad_req = p.grad_req

    @property
    def _t(self):
        return self._param

    @_t.setter
    def _t(self, value):
        p = self._param
        if value is p:
            return
        with torch.no_grad():
            if tuple(value.shape) == tuple(p.shape):
                p.copy_(value.to(device=p.device, dtype=p.dtype))
            else:
                p.data = value.detach().to(device=p.device, dtype=p.dtype)

    @property
    def grad(self):
        return self._param._grad_nd() if self._param.grad_req != "null" \
            else None

    def attach_grad(self, grad_req="write"):
        p = self._param
        p.grad_req = self.grad_req = grad_req
        if grad_req != "null":
            p._attach(zeroed=True)
        return self


class _GradND(NDArray):
    """`p.grad()`: an NDArray that reads and writes the parameter's
    current gradient (torch replaces the tensor on a 'write' backward;
    this array follows it, as the JAX package's gradient NDArray does)."""
    __slots__ = ("_param",)

    def __init__(self, p):
        self._param = p
        self._grad = None
        self.grad_req = "null"

    @property
    def _t(self):
        g = _GRAD.__get__(self._param)
        if g is None:
            raise RuntimeError(f"Parameter '{self._param.mx_name}' has no "
                               "gradient")
        return g

    @_t.setter
    def _t(self, value):
        p = self._param
        _GRAD.__set__(p, value.detach().to(device=p.device, dtype=p.dtype))


class Parameter(torch.nn.Parameter):
    """A parameter: `Parameter(name, shape, dtype, init, grad_req,
    differentiable, allow_deferred_init)`, the JAX package's signature
    (see the module docstring for the rule of its accessors)."""

    def __new__(cls, name=None, shape=None, dtype="float32", init=None,
                grad_req="write", differentiable=True,
                allow_deferred_init=False):
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"Parameter {name}: grad_req {grad_req!r} is "
                             "not 'write', 'add' or 'null'")
        known = shape is not None
        t = torch.empty(tuple(shape) if known else (0,),
                        dtype=dtype_of(dtype))
        p = torch.Tensor._make_subclass(cls, t, False)
        p.mx_placed = _placed()
        p.mx_name = name
        p.mx_init = init
        p.mx_initialized = False
        p.mx_rank_unknown = not known
        p.mx_deferred = not known or 0 in t.shape
        p.mx_init_requested = None
        p.allow_deferred_init = allow_deferred_init or known
        p.grad_req = grad_req if differentiable else "null"
        p.lr_mult = 1.0
        p.wd_mult = 1.0
        return p

    def __init__(self, *args, **kwargs):
        """Everything happens in `__new__`."""

    # -- torch's accessors, callable as MXNet's ---------------------------
    @property
    def data(self):
        d = _DATA.__get__(self)
        d.__class__ = _DataView
        d._mx_param = self
        return d

    @data.setter
    def data(self, value):
        _DATA.__set__(self, value)

    @property
    def grad(self):
        g = _GRAD.__get__(self)
        if g is not None:
            ref = g.__dict__.get("_mx_param")
            if ref is None or ref() is not self:
                if type(g) is torch.Tensor:
                    g.__class__ = _GradView
                g._mx_param = weakref.ref(self)
        return g

    @grad.setter
    def grad(self, value):
        _GRAD.__set__(self, _unwrap(value))

    @property
    def shape(self):
        return _SHAPE.__get__(self)

    @shape.setter
    def shape(self, new):
        """Complete a deferred shape (known dimensions must agree); a
        known shape may only be set to itself."""
        new = tuple(int(n) for n in new)
        if not self.mx_deferred:
            if new != tuple(self.shape):
                raise ValueError(f"Parameter {self.mx_name}: shape already "
                                 f"set to {tuple(self.shape)}, got {new}")
            return
        _check_shape(self, new)
        if 0 in new:
            self.data = torch.empty(new, dtype=self.dtype, device=self.device)
            self.mx_rank_unknown = False
        elif self.mx_init_requested is not None:
            finish_deferred(self, new, self.device)
        else:
            _take_shape(self, new, self.device)

    @property
    def name(self):
        return self.mx_name

    # -- MXNet's accessors -------------------------------------------------
    def _nd(self):
        if self.mx_deferred:
            raise DeferredInitializationError(
                f"Parameter '{self.mx_name}' has no shape yet"
                + ("; run a forward pass first"
                   if self.mx_init_requested is not None
                   else "; call .initialize()"))
        return _ParamND(self)

    def _attach(self, zeroed=False):
        """Let the parameter record gradients, with a gradient buffer (a
        zeroed new one where it has none; with `zeroed`, its own is
        zeroed too)."""
        from .. import autograd
        if self.is_floating_point():
            autograd.attach_grad_req(self)
        if _GRAD.__get__(self) is None:
            _GRAD.__set__(self, torch.zeros_like(self.detach()))
        elif zeroed:
            zero_grad(self)

    def _grad_nd(self):
        if self.grad_req == "null":
            raise RuntimeError(f"Parameter '{self.mx_name}' has "
                               "grad_req='null'")
        if _GRAD.__get__(self) is None:
            self._attach()
        return _GradND(self)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """MXNet's `Parameter.initialize`: fill the parameter by `init`,
        else its own initializer, else `default_init`, else uniform (the
        name rule of `Initializer.init_array`), on `ctx` (else where
        `Block.initialize` would put it), unless it is initialised and
        `force_reinit` is False. A trainable parameter gets its zeroed
        gradient buffer, as in the JAX package. A deferred one records
        the choice and draws when its shape is set (it raises without
        `allow_deferred_init`)."""
        from .. import context
        from .. import initializer as _init
        if getattr(self, "mx_constant", False) or (
                self.mx_initialized and not force_reinit):
            return
        if ctx is not None:
            self.data = self.data.to(context.resolve(ctx))
            self.mx_placed = True
        elif not self.mx_placed and (context.entered() is not None
                                     or torch.cuda.is_available()):
            self.data = self.data.to(context.resolve(None))
            self.mx_placed = True
        initializer = _init.create(init or self.mx_init or default_init
                                   or "uniform")
        if self.mx_deferred:
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter '{self.mx_name}' has unknown shape and "
                    "allow_deferred_init=False")
            self.mx_init_requested = (initializer, None)
            return
        _init._fill(initializer, self.mx_name, self.data)
        self.mx_initialized = True
        if self.grad_req != "null":
            self._attach(zeroed=True)

    def set_data(self, data):
        """Copy `data` (an NDArray, a tensor or an array-like) into the
        parameter in place (`set_data` below)."""
        if isinstance(data, NDArray):
            data = data._t
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        set_data(self, data.detach())

    def list_data(self):
        return [self._nd()]

    def list_grad(self):
        return [self._grad_nd()]

    def list_ctx(self):
        from .. import context
        return [] if self.mx_deferred else [context.Context.of(self.device)]

    def zero_grad(self):
        zero_grad(self)

    def cast(self, dtype):
        """Cast the parameter, and its gradient, to `dtype` in place."""
        dt = dtype_of(dtype)
        g = _GRAD.__get__(self)
        _GRAD.__set__(self, None)
        self.data = _DATA.__get__(self).to(dt)
        if g is not None:
            _GRAD.__set__(self, g.to(dt))

    # -- copies -------------------------------------------------------------
    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        t = _DATA.__get__(self).clone(memory_format=torch.preserve_format)
        out = torch.Tensor._make_subclass(type(self), t, self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(
            {k: v for k, v in self.__dict__.items()
             if not k.startswith("_")}, memo))
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild, (type(self), _DATA.__get__(self),
                           self.requires_grad,
                           {k: v for k, v in self.__dict__.items()
                            if not k.startswith("_")}))


def _rebuild(cls, data, requires_grad, state):
    p = torch.Tensor._make_subclass(cls, data, requires_grad)
    p.__dict__.update(state)
    return p


def _check_shape(p, shape):
    """Raise unless the deferred parameter `p` can take `shape`: the same
    rank (when known) and its known dimensions."""
    if p.mx_rank_unknown:
        return
    if len(shape) != p.dim() or any(
            s not in (0, n) for s, n in zip(p.shape, shape)):
        raise ValueError(f"Parameter {p.mx_name}: shape {tuple(p.shape)} "
                         f"cannot become {tuple(shape)}")


def _take_shape(p, shape, device):
    """Give the deferred parameter `p` storage of its full `shape` on
    `device` (unfilled)."""
    p.data = torch.empty(shape, dtype=p.dtype, device=device)
    p.mx_deferred = False
    p.mx_rank_unknown = False
    p.mx_init_requested = None


def zero_grad(p):
    """Zero the parameter's gradient in place (it keeps None when no
    backward has written one)."""
    if p.grad is not None:
        with torch.no_grad():
            p.grad.zero_()


class ParameterDict(dict):
    """{dotted path: parameter}, what `Block.collect_params` returns
    (counterpart of the JAX package's ParameterDict).

    `save` writes `nd.save`'s npz dict of every parameter that has its
    shape, keyed by path (less `strip_prefix`): the JAX package's file
    byte for byte. `load` copies a file of either package into the
    parameters IN PLACE under `torch.no_grad()` (each keeps its tensor,
    device and dtype; the value is cast to the dtype, as the JAX
    package's `set_data` casts), a deferred parameter taking the array's
    shape. Unlike the JAX package's `set_data`, a shape that disagrees
    raises. `ctx` is accepted for MXNet's sake: a parameter stays on its
    device."""

    def save(self, filename, strip_prefix=""):
        from ..ndarray import ndarray as _nd
        data = {}
        for name, p in self.items():
            if getattr(p, "mx_deferred", False):
                continue
            key = name[len(strip_prefix):] if name.startswith(strip_prefix) \
                else name
            data[key] = p.detach()
        _nd.save(filename, data)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import ndarray as _nd
        kind, loaded = _nd.load_arrays(filename)
        if kind != "dict":
            raise ValueError(f"{filename} holds a {kind} of arrays, not "
                             "named parameters")
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self.items():
            if name in loaded:
                set_data(p, loaded[name])
            elif not allow_missing:
                raise KeyError(f"parameter '{name}' missing from {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self)
            if extra:
                raise KeyError(f"extra parameters in file: {sorted(extra)}")

    def zero_grad(self):
        for p in self.values():
            if p.grad_req != "null":
                zero_grad(p)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """`Parameter.initialize` of each parameter (once for a parameter
        listed under two paths)."""
        seen = set()
        for p in self.values():
            if id(p) not in seen:
                seen.add(id(p))
                p.initialize(init=init, ctx=ctx, force_reinit=force_reinit)


def set_data(p, value):
    """Copy the tensor `value` into the parameter `p` in place, cast to
    its dtype and moved to its device; a deferred parameter takes the
    value's shape first (its known dimensions must agree). The parameter
    counts as initialised."""
    shape = tuple(value.shape)
    if getattr(p, "mx_deferred", False):
        _check_shape(p, shape)
        _take_shape(p, shape, p.device)
    if shape != tuple(p.shape):
        raise ValueError(f"Parameter {p.mx_name}: the value has shape "
                         f"{shape}, the parameter {tuple(p.shape)}")
    with torch.no_grad():
        p.copy_(value.to(device=p.device, dtype=p.dtype))
    p.mx_initialized = True


def finish_deferred(p, shape, device):
    """Give the deferred parameter `p` its full `shape` (its known
    dimensions must agree) on `device`; fill it when `initialize` asked
    for it, else raise as the JAX package's `data()` does."""
    shape = tuple(int(n) for n in shape)
    _check_shape(p, shape)
    if p.mx_init_requested is None:
        raise DeferredInitializationError(
            f"Parameter '{p.mx_name}' not initialized; call .initialize()")
    init, generator = p.mx_init_requested
    _take_shape(p, shape, device)
    from .. import initializer as _init
    _init._fill(init, p.mx_name, p.data, generator)
    p.mx_initialized = True


class Constant(Parameter):
    """A non-trainable parameter holding `value` (a tensor, kept on its
    device, or an array-like, put on the default device) in its own
    dtype."""

    def __new__(cls, name, value):
        if isinstance(value, NDArray):
            value = value._t
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.array(value))
        p = torch.Tensor._make_subclass(cls, value.detach().clone(), False)
        p.mx_placed = True
        p.mx_name = name
        p.mx_init = None
        p.mx_initialized = True
        p.mx_rank_unknown = False
        p.mx_deferred = False
        p.mx_init_requested = None
        p.allow_deferred_init = False
        p.mx_constant = True
        p.grad_req = "null"
        p.lr_mult = 1.0
        p.wd_mult = 1.0
        return p
