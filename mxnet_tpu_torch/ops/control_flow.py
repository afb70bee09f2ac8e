"""Control-flow ops: foreach, while_loop, cond (counterpart of
`mxnet_tpu/ops/control_flow.py`; reference: `_foreach`, `_while_loop`
and `_cond` in src/operator/control_flow.cc).

The port runs eagerly, so each function is a Python loop (or branch)
over torch tensors in which every op records on autograd's tape: the
JAX package's eager path, which is also MXNet's imperative path, where
the JAX module lowers to `lax.scan`, a masked scan and `lax.cond`. The
conventions are the JAX module's: flat lists of tensors in and out, and
callables that take and return flat lists. `while_loop` reads its
predicate on the host once an iteration, stops at the first False, and
pads the per-step outputs with zeros to `max_iterations` rows.

On meta tensors (the symbolic executor's shape inference,
`symbol._out_shapes`) nothing can be read on the host: `while_loop` runs
`func` once for the step outputs' shapes and returns `max_iterations`
rows of them and loop variables of their input shapes; `cond` runs its
then-branch.

The registry ops `_foreach`, `_while_loop` and `_cond` are the graph
nodes of `sym.contrib`: each evaluates its subgraph attributes with the
symbolic executor's `_eval_graph`, under the JAX module's input layout
(the node's `in_names` attribute names every input with its subgraph
variable: data, loop variables or branch inputs first, then the free
variables the subgraphs capture from the enclosing graph).

A random op inside a loop body draws anew each iteration here; inside a
JAX subgraph it is traced once, so its draw repeats across iterations
(`mxnet_tpu/ops/control_flow.py`'s note on RNG-drawing ops).
"""
from __future__ import annotations

import torch

from . import register


def _abstract(tensors):
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in tensors)


def _truth(pred):
    """The host value of a scalar (or one-element) predicate."""
    if isinstance(pred, torch.Tensor):
        return bool(pred.detach().reshape(()).item())
    return bool(pred)


def foreach(body, data, init_states):
    """Run `body(xs, states) -> (outs, new_states)` over axis 0 of each
    tensor of `data`. Returns (the per-step outs stacked: list, the final
    states: list)."""
    data = list(data)
    states = list(init_states)
    cols = None
    for t in range(data[0].shape[0] if data else 0):
        outs, states = body([d[t] for d in data], states)
        states = list(states)
        if cols is None:
            cols = [[] for _ in outs]
        for c, o in zip(cols, outs):
            c.append(o)
    return [torch.stack(c, 0) for c in (cols or [])], states


def while_loop(cond_fn, func, loop_vars, max_iterations):
    """Bounded while loop. `cond_fn(loop_vars) -> scalar`, `func(loop_vars)
    -> (step_outputs, new_loop_vars)`. Returns (the step outputs stacked
    and zero-padded to `max_iterations` rows: list, the final loop
    variables: list)."""
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations (static bound)")
    n = int(max_iterations)
    lv = list(loop_vars)
    if _abstract(lv):
        outs, _ = func(lv)
        return [torch.empty((n, *o.shape), dtype=o.dtype, device="meta")
                for o in outs], lv
    cols = None
    for _ in range(n):
        if not _truth(cond_fn(lv)):
            break
        outs, lv = func(lv)
        lv = list(lv)
        if cols is None:
            cols = [[] for _ in outs]
        for c, o in zip(cols, outs):
            c.append(o)
    device = lv[0].device if lv else None
    if cols is None:
        shapes = [(o.shape, o.dtype) for o in probe(
            lambda xs: func(xs)[0], list(loop_vars))]
        cols = [[] for _ in shapes]
    else:
        shapes = [(c[0].shape, c[0].dtype) for c in cols]
    return [torch.stack(c + [torch.zeros(s, dtype=dt, device=device)]
                        * (n - len(c)), 0)
            for c, (s, dt) in zip(cols, shapes)], lv


def cond(pred, then_func, else_func, inputs):
    """Run `then_func(inputs)` when the scalar `pred` holds, else
    `else_func(inputs)`; both return flat lists."""
    inputs = list(inputs)
    if _abstract([pred] + inputs) or _truth(pred):
        return list(then_func(inputs))
    return list(else_func(inputs))


def probe(fn, tensors):
    """`fn`'s outputs for `tensors` as meta tensors: their shapes and
    dtypes, without touching data (the counterpart of `jax.eval_shape`).
    The random streams are put back afterwards, so a draw inside `fn`
    leaves no trace."""
    from .. import random as _random
    state = _random.get_state()
    try:
        with torch.no_grad():
            return fn([torch.empty(t.shape, dtype=t.dtype, device="meta")
                       for t in tensors])
    finally:
        _random.set_state(state)


# ---------------------------------------------------------------------------
# the graph nodes of sym.contrib
# ---------------------------------------------------------------------------

def _eval_sub(sub, values):
    from .. import autograd
    from ..symbol.executor import _eval_graph
    heads, _aux = _eval_graph(sub, values, autograd.is_training())
    return heads


@register("_foreach")
def _foreach_op(*arrays, _subgraph=None, in_names=(), num_data=0,
                num_states=0, num_out_data=0, **_ignored):
    in_names = list(in_names)
    data = list(arrays[:num_data])
    states = list(arrays[num_data:num_data + num_states])
    free = dict(zip(in_names[num_data + num_states:],
                    arrays[num_data + num_states:]))

    def body(xs, ss):
        values = dict(zip(in_names[:num_data], xs))
        values.update(zip(in_names[num_data:num_data + num_states], ss))
        values.update(free)
        heads = _eval_sub(_subgraph, values)
        return heads[:num_out_data], heads[num_out_data:]

    outs, finals = foreach(body, data, states)
    res = tuple(outs) + tuple(finals)
    return res if len(res) != 1 else res[0]


@register("_while_loop")
def _while_loop_op(*arrays, _subgraph_cond=None, _subgraph_func=None,
                   in_names=(), num_loop_vars=0, num_out_data=0,
                   max_iterations=None, **_ignored):
    in_names = list(in_names)
    lv = list(arrays[:num_loop_vars])
    free = dict(zip(in_names[num_loop_vars:], arrays[num_loop_vars:]))

    def values_of(vs):
        values = dict(zip(in_names[:num_loop_vars], vs))
        values.update(free)
        return values

    def cond_fn(vs):
        return _eval_sub(_subgraph_cond, values_of(vs))[0]

    def func(vs):
        heads = _eval_sub(_subgraph_func, values_of(vs))
        return heads[:num_out_data], heads[num_out_data:]

    outs, finals = while_loop(cond_fn, func, lv, max_iterations)
    res = tuple(outs) + tuple(finals)
    return res if len(res) != 1 else res[0]


@register("_cond")
def _cond_op(*arrays, _subgraph_then=None, _subgraph_else=None,
             in_names=(), num_inputs=0, **_ignored):
    in_names = list(in_names)
    pred = arrays[0]
    ins = list(arrays[1:1 + num_inputs])
    free = dict(zip(in_names[num_inputs:], arrays[1 + num_inputs:]))

    def branch(sub):
        def run(xs):
            values = dict(zip(in_names[:num_inputs], xs))
            values.update(free)
            return _eval_sub(sub, values)
        return run

    res = tuple(cond(pred, branch(_subgraph_then), branch(_subgraph_else),
                     ins))
    return res if len(res) != 1 else res[0]
