"""Parameters (counterpart of `mxnet_tpu/gluon/parameter.py`).

A parameter is a `torch.nn.Parameter` that remembers its own
initializer, so `Block.initialize()` can apply the JAX package's rule:
the initializer passed to `initialize`, else the parameter's own, else
uniform. It also remembers whether it was initialised (`mx_initialized`,
set by `initialize` and by `weights.load_named_arrays`): a second
`initialize()` leaves it alone unless `force_reinit=True`. It also carries the JAX package's `grad_req` ('write' trains
it, 'null' leaves it out of training). The tensor itself records no
gradient, so serving builds no autograd graph: training goes through
`parallel.ShardedTrainer`, which substitutes views of its flat float32
master (which do record gradients) for every parameter whose grad_req
is not 'null'. Storage is allocated on torch's current default device,
which the model constructors set to the model's device.

A `Constant` is a 'null' parameter that holds a given value of any dtype
(int8 included) and that `Block.initialize` leaves alone.

A shape with a 0 in it is deferred, as the JAX package's
`allow_deferred_init` parameters are: the tensor holds no element until
its layer's first forward (`finish_deferred`) or
`weights.load_named_arrays` gives it the missing dimensions.
`Block.initialize` records its choice on a deferred parameter
(`mx_init_requested`) without drawing; `finish_deferred` then fills it by
`Initializer.init_array`'s name rule from that choice, on the input's
device and from the stream `initialize` would have drawn from.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Parameter", "ParameterDict", "Constant", "dtype_of",
           "finish_deferred", "set_data", "zero_grad"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(dtype):
    """torch dtype for a JAX-package dtype name (or a torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def Parameter(name, shape, dtype="float32", init=None,  # noqa: N802
              grad_req="write"):
    if grad_req not in ("write", "add", "null"):
        raise ValueError(f"Parameter {name}: grad_req {grad_req!r} is not "
                         "'write', 'add' or 'null'")
    p = torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype_of(dtype)),
                           requires_grad=False)
    p.mx_name = name
    p.mx_init = init
    p.mx_initialized = False
    p.mx_deferred = 0 in p.shape
    p.mx_init_requested = None
    p.grad_req = grad_req
    p.lr_mult = 1.0
    p.wd_mult = 1.0
    return p


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


def set_data(p, value):
    """Copy the tensor `value` into the parameter `p` in place, cast to
    its dtype and moved to its device; a deferred parameter takes the
    value's shape first (its known dimensions must agree). The parameter
    counts as initialised."""
    shape = tuple(value.shape)
    if getattr(p, "mx_deferred", False):
        if len(shape) != p.dim() or any(
                s not in (0, n) for s, n in zip(p.shape, shape)):
            raise ValueError(f"Parameter {p.mx_name}: shape "
                             f"{tuple(p.shape)} cannot become {shape}")
        p.data = torch.empty(shape, dtype=p.dtype, device=p.device)
        p.mx_deferred = False
        p.mx_init_requested = None
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
    if len(shape) != p.dim() or any(
            s not in (0, n) for s, n in zip(p.shape, shape)):
        raise ValueError(f"Parameter {p.mx_name}: shape {tuple(p.shape)} "
                         f"cannot become {shape}")
    if p.mx_init_requested is None:
        raise RuntimeError(f"Parameter '{p.mx_name}' not initialized; call "
                           ".initialize()")
    p.data = torch.empty(shape, dtype=p.dtype, device=device)
    p.mx_deferred = False
    init, generator = p.mx_init_requested
    p.mx_init_requested = None
    from .. import initializer as _init
    _init._fill(init, p.mx_name, p.data, generator)
    p.mx_initialized = True


def Constant(name, value):  # noqa: N802
    """A non-trainable parameter holding `value` (a tensor, kept on its
    device, or an array-like, put on the default device) in its own
    dtype."""
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(np.array(value))
    p = torch.nn.Parameter(value.detach().clone(), requires_grad=False)
    p.mx_name = name
    p.mx_init = None
    p.mx_constant = True
    p.grad_req = "null"
    p.lr_mult = 1.0
    p.wd_mult = 1.0
    return p
