"""`sym.contrib` (counterpart of `mxnet_tpu/symbol/contrib.py`): every
`_contrib_X` registry op as `sym.contrib.X` (reference:
`python/mxnet/symbol/contrib.py`, generated from the op registry), and
the symbolic control flow `foreach`, `while_loop` and `cond`.

The control flow is the JAX module's front end, line for line: the
callables get fresh Symbol variables and build a subgraph, which travels
on a `_foreach`, `_while_loop` or `_cond` node (`ops/control_flow.py`)
as a `_subgraph*` attribute, serialized into the node's JSON
`subgraphs` field. The variables a subgraph captures from the enclosing
graph become extra node inputs after the bound ones (`in_names`). The
call conventions are `nd.contrib`'s, so the same callbacks run on both:
`foreach`'s body gets (data slice, states) packed as the inputs were;
`while_loop`'s `cond` and `func` and `cond`'s branches get the variables
unpacked. The executor runs the nodes eagerly (`symbol/executor.py`), so
a subgraph's ops record on autograd's tape iteration by iteration."""
from __future__ import annotations

from ..ops import OPS as _OPS


def __getattr__(name):
    full = "_contrib_" + name
    if full in _OPS:
        from . import _make_sym_op
        fn = _make_sym_op(full)
        fn.__name__ = name
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'sym.contrib' has no attribute '{name}'")


import itertools as _it

_CF_UID = _it.count()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _is_list(x):
    return isinstance(x, (list, tuple))


def _pack(syms, was_list):
    return list(syms) if was_list else syms[0]


def _fresh_vars(prefix, tag, n):
    from . import Variable
    # the $serial keeps nested control flow (same default name) from
    # aliasing an outer subgraph's bound variables by name
    uid = next(_CF_UID)
    return [Variable(f"{prefix}${uid}_{tag}{i}") for i in range(n)]


def _single_heads(syms, what, op):
    from . import MXNetError
    for s in syms:
        if len(s._heads) != 1:
            raise MXNetError(
                f"{op}: each {what} must be a single-output Symbol "
                "(pass a list, not a Group)")
    return syms


def _free_vars(subs, bound_names):
    """Variable nodes any of `subs` reads that aren't subgraph-local
    inputs — i.e. the enclosing graph's parameters, in first-seen order."""
    from . import Symbol
    seen, out = set(), []
    for sub in subs:
        for node in sub._topo_nodes():
            if node.is_var and node.name not in bound_names \
                    and id(node) not in seen:
                seen.add(id(node))
                out.append((node.name, Symbol([(node, 0)])))
    return out


def _cf_node(op, name, input_syms, attrs, n_outputs):
    from . import MXNetError, Symbol, _Node, _scoped_name
    name = _scoped_name(name, op.lstrip("_"))
    heads = []
    for s in input_syms:
        if len(s._heads) != 1:
            raise MXNetError(f"{op}: grouped symbol not a valid input")
        heads.append(s._heads[0])
    node = _Node(op, name, heads, attrs)
    return [Symbol([(node, i)]) for i in range(n_outputs)]


def foreach(body, data, init_states, name=None):
    """Scan `body` over axis 0 of `data` symbolically.

    body(data_slice, states) -> (outs, new_states), slices/states packed
    to the input structure. Returns (outs, final_states) packed the same
    way. Reference: sym.contrib.foreach.
    """
    data_l, data_is_list = _as_list(data), _is_list(data)
    states_l, state_is_list = _as_list(init_states), _is_list(init_states)
    pfx = name or "foreach"
    dvars = _fresh_vars(pfx, "slice", len(data_l))
    svars = _fresh_vars(pfx, "state", len(states_l))
    outs, new_states = body(_pack(dvars, data_is_list),
                            _pack(svars, state_is_list))
    out_is_list = _is_list(outs)
    outs_l, ns_l = _as_list(outs), _as_list(new_states)
    if len(ns_l) != len(states_l):
        raise ValueError(
            f"foreach: body returned {len(ns_l)} states, expected "
            f"{len(states_l)}")
    _single_heads(outs_l, "output", "foreach")
    _single_heads(ns_l, "state", "foreach")
    from . import Group
    sub = Group(outs_l + ns_l)
    bound = [v.name for v in dvars + svars]
    free = _free_vars([sub], set(bound))
    attrs = {
        "_subgraph": sub,
        "in_names": bound + [n for n, _ in free],
        "num_data": len(data_l), "num_states": len(states_l),
        "num_out_data": len(outs_l),
    }
    res = _cf_node("_foreach", name, data_l + states_l +
                   [s for _, s in free], attrs, len(outs_l) + len(ns_l))
    return (_pack(res[:len(outs_l)], out_is_list),
            _pack(res[len(outs_l):], state_is_list))


def while_loop(cond, func, loop_vars, max_iterations=None, name=None):
    """Bounded symbolic while loop (reference: sym.contrib.while_loop).

    cond(*loop_vars) -> scalar Symbol; func(*loop_vars) -> (step_outputs,
    new_loop_vars) — both called with the loop vars UNPACKED, matching
    nd.contrib. Step-output rows at and beyond the first failing
    iteration are zeros; outputs are padded to `max_iterations`.
    """
    if max_iterations is None:
        raise ValueError("while_loop requires max_iterations")
    lv_l, lv_is_list = _as_list(loop_vars), _is_list(loop_vars)
    pfx = name or "while_loop"
    lvars = _fresh_vars(pfx, "loopvar", len(lv_l))
    pred = cond(*lvars)
    outs, new_lv = func(*lvars)
    out_is_list = _is_list(outs)
    outs_l, nlv_l = _as_list(outs), _as_list(new_lv)
    if len(nlv_l) != len(lv_l):
        raise ValueError(
            f"while_loop: func returned {len(nlv_l)} loop_vars, expected "
            f"{len(lv_l)}")
    _single_heads([pred], "predicate", "while_loop")
    _single_heads(outs_l, "output", "while_loop")
    _single_heads(nlv_l, "loop_var", "while_loop")
    from . import Group
    sub_f = Group(outs_l + nlv_l)
    bound = [v.name for v in lvars]
    free = _free_vars([pred, sub_f], set(bound))
    attrs = {
        "_subgraph_cond": pred, "_subgraph_func": sub_f,
        "in_names": bound + [n for n, _ in free],
        "num_loop_vars": len(lv_l), "num_out_data": len(outs_l),
        "max_iterations": int(max_iterations),
    }
    res = _cf_node("_while_loop", name, lv_l + [s for _, s in free],
                   attrs, len(outs_l) + len(nlv_l))
    return (_pack(res[:len(outs_l)], out_is_list),
            _pack(res[len(outs_l):], lv_is_list))


def cond(pred, then_func, else_func, inputs=None, name=None):
    """Symbolic conditional (reference: sym.contrib.cond). Branch callables
    are called with `inputs` UNPACKED (or as zero-arg closures), matching
    nd.contrib; both must return the same number of outputs with matching
    shapes/dtypes."""
    ins_l = _as_list(inputs) if inputs is not None else []
    pfx = name or "cond"
    ivars = _fresh_vars(pfx, "input", len(ins_l))

    def run(f):
        out = f(*ivars) if ins_l else f()
        return _as_list(out), _is_list(out)

    then_l, then_is_list = run(then_func)
    else_l, else_is_list = run(else_func)
    if len(then_l) != len(else_l) or then_is_list != else_is_list:
        raise ValueError("cond: branch output structures differ "
                         f"({len(then_l)} vs {len(else_l)})")
    _single_heads(then_l, "then output", "cond")
    _single_heads(else_l, "else output", "cond")
    from . import Group
    sub_t, sub_e = Group(then_l), Group(else_l)
    bound = [v.name for v in ivars]
    free = _free_vars([sub_t, sub_e], set(bound))
    attrs = {
        "_subgraph_then": sub_t, "_subgraph_else": sub_e,
        "in_names": bound + [n for n, _ in free],
        "num_inputs": len(ins_l),
    }
    res = _cf_node("_cond", name, [pred] + ins_l + [s for _, s in free],
                   attrs, len(then_l))
    return _pack(res, then_is_list)
