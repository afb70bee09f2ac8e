"""`nd.contrib` (counterpart of `mxnet_tpu/ndarray/contrib.py`): the
control flow over NDArrays (`foreach`, `while_loop`, `cond`), `isinf`,
`isnan` and `isfinite`, and every ported `_contrib_X` op of the registry
as `nd.contrib.X`.

The port is eager, inside `hybridize()` as well (`gluon/block.py` only
counts signatures there), so each function is the JAX package's eager
path, which is MXNet's imperative path: a Python loop in which every
inner op records on autograd's tape, so a body that closes over a
parameter differentiates into it. `foreach` and `while_loop` run the
loops of `ops/control_flow.py` on the NDArrays' tensors, with the body
wrapped to take and give NDArrays; only the packing lives here. The
call conventions are the JAX package's: `foreach`'s body gets (data
slice, states) packed as the inputs were; `while_loop`'s `cond` and `func` and `cond`'s branches get
the variables unpacked. `while_loop` reads its predicate on the host once
an iteration, pads the per-step outputs with zeros to `max_iterations`
rows, and keeps a single output a bare NDArray. A loop that never runs
finds its outputs' shapes by running `func` on meta tensors
(`ops.control_flow.probe`, the counterpart of `jax.eval_shape`): no data
is read, no kernel launches, and the random streams are put back.
"""
from __future__ import annotations

import torch

from ..ops import control_flow as _cf
from .ndarray import NDArray, _array_args, _registry, _unwrap, registry_op

__all__ = ["foreach", "while_loop", "cond", "isinf", "isnan", "isfinite"]


def _flat(x):
    """NDArray | list/tuple of NDArrays -> (list, was_list)."""
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _pack(nds, was_list):
    return list(nds) if was_list else nds[0]


def _nds(tensors):
    return [NDArray(t) for t in tensors]


def _tensors(x, spec=None):
    """NDArray | list of NDArrays -> their tensors; records in `spec`
    whether `x` was a list."""
    flat, was_list = _flat(x)
    if spec is not None:
        spec["out_is_list"] = was_list
    return [_unwrap(v) for v in flat]


def foreach(body, data, init_states):
    """`body(data_slice, states) -> (outs, new_states)` run over axis 0
    of `data`; returns (the outs stacked, the final states)."""
    data_list, data_is_list = _flat(data)
    state_list, state_is_list = _flat(init_states)
    spec = {"out_is_list": True}

    def body_raw(xs, st):
        o, ns = body(_pack(_nds(xs), data_is_list),
                     _pack(_nds(st), state_is_list))
        return _tensors(o, spec), _tensors(ns)

    outs, fin = _cf.foreach(body_raw, _tensors(data_list),
                            _tensors(state_list))
    return _pack(_nds(outs), spec["out_is_list"]), \
        _pack(_nds(fin), state_is_list)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Bounded while loop: `cond(*loop_vars)`, `func(*loop_vars) ->
    (step_outputs, new_loop_vars)`. Returns (the step outputs stacked and
    zero-padded to `max_iterations` rows, the final loop variables)."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    lv_list, lv_is_list = _flat(loop_vars)
    spec = {"out_is_list": True}

    def func_raw(lv):
        o, nlv = func(*_nds(lv))
        return _tensors(o, spec), _tensors(nlv)

    outs, fin = _cf.while_loop(lambda lv: _unwrap(cond(*_nds(lv))),
                               func_raw, _tensors(lv_list), max_iterations)
    return _pack(_nds(outs), spec["out_is_list"]), \
        _pack(_nds(fin), lv_is_list)


def cond(pred, then_func, else_func, inputs=None):
    """Run `then_func` when `pred` (a scalar NDArray or a zero-argument
    callable) holds, else `else_func`; the branches take `inputs`
    unpacked, or nothing."""
    in_list = _flat(inputs)[0] if inputs is not None else []
    pred_val = pred() if callable(pred) else pred
    fn = then_func if _cf._truth(_unwrap(pred_val)) else else_func
    return fn(*in_list) if in_list else fn()


def _elementwise(fn, x):
    (t,), _ = _array_args([x], {})
    return NDArray(fn(t))


def isinf(x):
    return _elementwise(torch.isinf, x)


def isnan(x):
    return _elementwise(torch.isnan, x)


def isfinite(x):
    return _elementwise(torch.isfinite, x)


def __getattr__(name):
    full = "_contrib_" + name
    if full in _registry():
        return registry_op(full)
    raise AttributeError(f"module 'nd.contrib' has no attribute '{name}'")
