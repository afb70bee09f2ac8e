"""`mx.sym`: the symbolic graph API (counterpart of
`mxnet_tpu/symbol/__init__.py`; reference: `python/mxnet/symbol/`).

A Symbol is a lightweight Python DAG over the port's op registry
(`mxnet_tpu_torch.ops`), the one the imperative API (`nd.<op>`) uses.
Binding it (`simple_bind`, `bind`) gives an `Executor` (`.executor`) that
evaluates the graph eagerly on the bound device, with torch autograd for
the backward.

Surface kept from the JAX package, name for name:
  * `var`/`Variable`, the op namespace (`sym.FullyConnected(...)`),
    operator overloads, auto-created weight/bias/aux variables named
    through `mx.name` scopes, `mx.AttrScope` attributes;
  * `list_arguments` / `list_outputs` / `list_auxiliary_states`,
    `get_internals`, `Group`, indexing;
  * `infer_shape` (per-op weight-shape rules, `SCHEMAS`, then each op run
    on `device="meta"` tensors, the counterpart of `jax.eval_shape`),
    `infer_type`;
  * `tojson` / `load_json`, `save` / `load`: the JAX package's JSON,
    byte for byte, so each package loads the other's files.

An op that reaches a kernel wrapper (the flash attention ops, the int8
ops, `_contrib_box_nms`) cannot run on meta tensors: the wrappers take
CPU and CUDA tensors only. Such an op has an output-shape rule in
`SHAPE_RULES`, which shape inference uses instead of running it.
"""
from __future__ import annotations

import ast
import json
import re

import numpy as _np

from .. import ops as _ops
from ..base import MXNetError

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "zeros", "ones"]


# --------------------------------------------------------------------------
# op schemas: input names, aux-state split, weight-shape deduction (the
# JAX package's rows)
# --------------------------------------------------------------------------

class OpSchema:
    __slots__ = ("inputs", "aux", "visible", "aux_map", "infer")

    def __init__(self, inputs, aux=(), visible=1, aux_map=(), infer=None):
        self.inputs = list(inputs)     # arg input names, in positional order
        self.aux = list(aux)           # aux input names (after args)
        self.visible = visible         # leading outputs visible to the graph
        self.aux_map = list(aux_map)   # (out_idx, aux_pos): writeback pairs
        self.infer = infer             # fn(shapes:dict, attrs) -> missing


def _fc_infer(shapes, attrs):
    d = shapes.get("data")
    if d is None:
        return {}
    nh = attrs["num_hidden"]
    in_dim = int(_np.prod(d[1:])) if attrs.get("flatten", True) else d[-1]
    out = {"weight": (nh, in_dim)}
    if not attrs.get("no_bias", False):
        out["bias"] = (nh,)
    return out


def _conv_infer(shapes, attrs):
    d = shapes.get("data")
    if d is None:
        return {}
    kernel = tuple(attrs["kernel"]) if not _np.isscalar(attrs["kernel"]) \
        else (attrs["kernel"],) * (len(d) - 2)
    nf = attrs["num_filter"]
    ng = attrs.get("num_group", 1)
    out = {"weight": (nf, d[1] // ng) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _deconv_infer(shapes, attrs):
    d = shapes.get("data")
    if d is None:
        return {}
    kernel = tuple(attrs["kernel"]) if not _np.isscalar(attrs["kernel"]) \
        else (attrs["kernel"],) * (len(d) - 2)
    nf = attrs["num_filter"]
    out = {"weight": (d[1], nf) + kernel}
    if not attrs.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _chan_infer(*names, axis_key="axis", default_axis=1):
    def infer(shapes, attrs):
        d = shapes.get("data")
        if d is None:
            return {}
        c = d[attrs.get(axis_key, default_axis)]
        return {n: (c,) for n in names}
    return infer


def _embed_infer(shapes, attrs):
    return {"weight": (attrs["input_dim"], attrs["output_dim"])}


SCHEMAS = {
    "FullyConnected": OpSchema(["data", "weight", "bias"], infer=_fc_infer),
    "Convolution": OpSchema(["data", "weight", "bias"], infer=_conv_infer),
    "Deconvolution": OpSchema(["data", "weight", "bias"], infer=_deconv_infer),
    "BatchNorm": OpSchema(["data", "gamma", "beta"],
                          aux=["moving_mean", "moving_var"],
                          visible=1, aux_map=[(1, 0), (2, 1)],
                          infer=_chan_infer("gamma", "beta", "moving_mean",
                                            "moving_var")),
    "LayerNorm": OpSchema(["data", "gamma", "beta"],
                          infer=_chan_infer("gamma", "beta",
                                            default_axis=-1)),
    "InstanceNorm": OpSchema(["data", "gamma", "beta"],
                             infer=_chan_infer("gamma", "beta")),
    "GroupNorm": OpSchema(["data", "gamma", "beta"],
                          infer=_chan_infer("gamma", "beta")),
    "Embedding": OpSchema(["data", "weight"], infer=_embed_infer),
    "SoftmaxOutput": OpSchema(
        ["data", "label"],
        infer=lambda shapes, attrs: (
            {"label": tuple(shapes["data"][:-1])} if "data" in shapes else {})),
    "softmax_cross_entropy": OpSchema(
        ["data", "label"],
        infer=lambda shapes, attrs: (
            {"label": tuple(shapes["data"][:-1])} if "data" in shapes else {})),
}


def _qdense_shape(shapes, attrs):
    d, o = shapes[0], shapes[1][0]
    if attrs.get("flatten", False) and len(d) > 2:
        return [(d[0], o)]
    return [tuple(d[:-1]) + (o,)]


# output-shape rules of the ops whose functions reach a kernel wrapper
# (which takes CPU and CUDA tensors only) or make a tensor from their
# attributes: fn(input shapes, attrs) -> output shapes
SHAPE_RULES = {
    "fused_self_attention": lambda s, a: [
        tuple(s[0][:-1]) + (s[0][-1] // 3,)],
    "flash_attention": lambda s, a: [tuple(s[0])],
    "_contrib_quantized_dense": _qdense_shape,
    "_contrib_box_nms": lambda s, a: [tuple(s[0])],
    "_zeros": lambda s, a: [tuple(a.get("shape", ()))],
    "_ones": lambda s, a: [tuple(a.get("shape", ()))],
}

# params whose name marks them as state, mirroring the reference convention
_AUX_PAT = re.compile(r"(moving_mean|moving_var|running_mean|running_var)$")


def _schema_for(op):
    return SCHEMAS.get(op)


# --------------------------------------------------------------------------
# name manager (reference: python/mxnet/name.py NameManager)
# --------------------------------------------------------------------------

_NAME_COUNT = {}


def _scoped_name(name, op):
    """Resolve a node name through the active mx.name scope. Explicit
    names also route through the manager (reference semantics: Prefix
    prefixes user-supplied names too)."""
    base = op.lower().lstrip("_")
    from .. import name as _name_mod
    mgr = _name_mod.current()
    if mgr is not None:   # active mx.name.NameManager / Prefix scope
        return mgr.get(name, base)
    if name is not None:
        return name
    i = _NAME_COUNT.get(base, 0)
    _NAME_COUNT[base] = i + 1
    return f"{base}{i}"


# --------------------------------------------------------------------------
# graph nodes
# --------------------------------------------------------------------------

class _Node:
    __slots__ = ("op", "name", "inputs", "attrs", "_shape", "_dtype",
                 "scope_attrs")

    def __init__(self, op, name, inputs=(), attrs=None,
                 shape=None, dtype=None):
        self.op = op                      # None => variable
        self.name = name
        self.inputs = list(inputs)        # list of (_Node, out_idx)
        self.attrs = dict(attrs or {})    # static op params
        self._shape = shape               # variables only (user hint)
        self._dtype = dtype
        # user attrs from `with mx.AttrScope(...)`
        from ..attribute import current_attrs
        self.scope_attrs = current_attrs()

    @property
    def is_var(self):
        return self.op is None


class Symbol:
    """A set of output heads over the node DAG."""

    def __init__(self, heads):
        self._heads = list(heads)  # list of (_Node, out_idx)

    # -------------------------------------------------- graph introspection
    @property
    def name(self):
        node, idx = self._heads[0]
        if len(self._heads) > 1:
            return "group"
        return node.name

    def attr(self, key):
        """User attribute of this symbol's node (reference: Symbol.attr)."""
        node, _ = self._heads[0]
        return node.scope_attrs.get(key)

    def list_attr(self):
        node, _ = self._heads[0]
        return dict(node.scope_attrs)

    def attr_dict(self):
        """name -> attrs for every node (reference: Symbol.attr_dict)."""
        out = {}
        for n in self._topo_nodes():
            if n.scope_attrs:
                out[n.name] = dict(n.scope_attrs)
        return out

    def _topo_nodes(self):
        """Post-order DFS (the reference argument ordering)."""
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._heads)]
        while stack:
            node, processed = stack.pop()
            if processed:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for src, _ in reversed(node.inputs):
                stack.append((src, False))
        return order

    def _var_nodes(self):
        return [n for n in self._topo_nodes() if n.is_var]

    def list_arguments(self):
        return [n.name for n in self._var_nodes()
                if not _AUX_PAT.search(n.name)]

    def list_auxiliary_states(self):
        return [n.name for n in self._var_nodes() if _AUX_PAT.search(n.name)]

    def list_inputs(self):
        return [n.name for n in self._var_nodes()]

    def list_outputs(self):
        outs = []
        for node, idx in self._heads:
            sch = _schema_for(node.op)
            if node.is_var:
                outs.append(node.name)
            elif sch and sch.visible > 1 or idx > 0:
                outs.append(f"{node.name}_output{idx}")
            else:
                outs.append(f"{node.name}_output")
        return outs

    def get_internals(self):
        """All node outputs as a grouped symbol (reference:
        `Symbol.get_internals`)."""
        return Symbol([(n, 0) for n in self._topo_nodes()])

    def __getitem__(self, idx):
        if isinstance(idx, str):
            names = self.list_outputs()
            if idx not in names:
                # allow bare node-name lookup on internals
                for i, o in enumerate(names):
                    if o == idx or o.removesuffix("_output") == idx:
                        return Symbol([self._heads[i]])
                raise KeyError(idx)
            return Symbol([self._heads[names.index(idx)]])
        if len(self._heads) > 1:
            return Symbol([self._heads[idx]])
        node, _ = self._heads[0]
        return Symbol([(node, idx)])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (Symbol([h]) for h in self._heads)

    def __repr__(self):
        return f"<Symbol {self.name}>"

    # -------------------------------------------------- operators
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _invoke(op, [a, b], {})
        if _np.isscalar(other):
            return _invoke(scalar_op, [self], {"scalar": other})
        raise TypeError(f"unsupported operand for {op}: {type(other)}")

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_rdiv_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    # __eq__ overridden for the reference's elementwise semantics; nodes
    # stay identity-hashable (Symbol objects key dicts in the front-ends)
    __hash__ = object.__hash__

    def __getattr__(self, name):
        if name.startswith("_") or name not in _ops.OPS:
            raise AttributeError(name)

        def method(*args, **kwargs):
            return _invoke(name, [self] + list(args), kwargs)
        method.__name__ = name
        return method

    # -------------------------------------------------- shape/type inference
    def infer_shape(self, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes) in the orders of
        list_arguments/list_outputs/list_auxiliary_states.

        Forward propagation with per-op weight-shape deduction rules (the
        role the reference's bidirectional `InferShape` pass plays for the
        standard layers)."""
        shapes = self._infer_shapes_dict(kwargs)
        args = [shapes.get(n) for n in self.list_arguments()]
        auxs = [shapes.get(n) for n in self.list_auxiliary_states()]
        outs = [shapes.get(node.name) if node.is_var
                else shapes.get(("out", id(node), idx))
                for node, idx in self._heads]
        return args, outs, auxs

    def infer_shape_partial(self, **kwargs):
        return self.infer_shape(**kwargs)

    def _infer_shapes_dict(self, known):
        shapes = {}
        for n in self._var_nodes():
            if n.name in known and known[n.name] is not None:
                shapes[n.name] = tuple(known[n.name])
            elif n._shape is not None:
                shapes[n.name] = tuple(n._shape)

        order = self._topo_nodes()
        progress = True
        while progress:
            progress = False
            for node in order:
                if node.is_var:
                    continue
                key0 = ("out", id(node), 0)
                if key0 in shapes:
                    continue
                in_keys = []
                for src, idx in node.inputs:
                    in_keys.append(src.name if src.is_var
                                   else ("out", id(src), idx))
                sch = _schema_for(node.op)
                if sch and sch.infer:
                    named = {}
                    all_names = sch.inputs + sch.aux
                    for (src, _), nm in zip(node.inputs, all_names):
                        if src.is_var and src.name in shapes:
                            named.setdefault(nm, shapes[src.name])
                        elif not src.is_var:
                            k = ("out", id(src),
                                 node.inputs[all_names.index(nm)][1])
                            if k in shapes:
                                named.setdefault(nm, shapes[k])
                    missing = sch.infer(named, node.attrs)
                    for (src, _), nm in zip(node.inputs, all_names):
                        if src.is_var and src.name not in shapes \
                                and nm in missing:
                            shapes[src.name] = tuple(missing[nm])
                            progress = True
                if not all(k in shapes for k in in_keys):
                    continue
                try:
                    outs = _out_shapes(node, [shapes[k] for k in in_keys])
                except Exception as e:  # pragma: no cover
                    raise MXNetError(
                        f"shape inference failed at {node.name}({node.op}): "
                        f"{e}") from e
                for i, o in enumerate(outs):
                    shapes[("out", id(node), i)] = tuple(o)
                progress = True
        return shapes

    def infer_type(self, **kwargs):
        args = [_np.float32 for _ in self.list_arguments()]
        outs = [_np.float32 for _ in self._heads]
        auxs = [_np.float32 for _ in self.list_auxiliary_states()]
        return args, outs, auxs

    # -------------------------------------------------- serialization
    def tojson(self):
        """MXNet-flavored JSON: nodes with op/name/attrs/inputs, arg_nodes,
        heads (reference: `Symbol.tojson` via NNVM graph JSON); the JAX
        package's text for the same graph."""
        order = self._topo_nodes()
        index = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            # Symbol-valued attrs (control-flow subgraphs) serialize as a
            # `subgraphs` list — [attr key, nested graph JSON dict]
            plain, subs = {}, []
            for k, v in n.attrs.items():
                if isinstance(v, Symbol):
                    subs.append([k, json.loads(v.tojson())])
                else:
                    plain[k] = repr(v)
            nodes.append({
                "op": "null" if n.is_var else n.op,
                "name": n.name,
                "attrs": plain,
                "inputs": [[index[id(src)], idx, 0] for src, idx in n.inputs],
                **({"subgraphs": subs} if subs else {}),
                **({"shape": list(n._shape)} if n._shape else {}),
                **({"scope_attrs": dict(n.scope_attrs)}
                   if n.scope_attrs else {}),
            })
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.is_var],
            "heads": [[index[id(node)], idx, 0]
                      for node, idx in self._heads],
        }, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -------------------------------------------------- execution
    def simple_bind(self, ctx=None, grad_req="write", **kwargs):
        from .executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        from .executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, args=kwargs)
        return ex.forward()


def _out_shapes(node, in_shapes):
    """The output shapes of `node` on inputs of `in_shapes`: its rule in
    `SHAPE_RULES`, else its op run on float32 meta tensors outside
    training (the counterpart of `jax.eval_shape`)."""
    rule = SHAPE_RULES.get(node.op)
    if rule is not None:
        return rule(in_shapes, node.attrs)
    import torch
    from .. import autograd
    fn = _ops.get(node.op)
    xs = [torch.empty(s, dtype=torch.float32, device="meta")
          for s in in_shapes]
    prev = autograd.set_training(False)
    try:
        with torch.no_grad():
            out = fn(*xs, **node.attrs)
    finally:
        autograd.set_training(prev)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [tuple(o.shape) for o in outs]


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def Variable(name, shape=None, dtype=None, init=None, **kwargs):  # noqa: N802
    return Symbol([(_Node(None, name, shape=shape, dtype=dtype), 0)])


var = Variable


def Group(symbols):  # noqa: N802
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def _invoke(op_name, args, kwargs):
    """Build a graph node for an op call (reference:
    `_symbol_creator` in python/mxnet/symbol/register.py)."""
    if op_name not in _ops.OPS:
        raise MXNetError(f"unknown op '{op_name}'")
    name = _scoped_name(kwargs.pop("name", None), op_name)
    sch = _schema_for(op_name)

    inputs = []   # (name, Symbol)
    attrs = {}
    if sch:
        provided = {}
        for nm, a in zip(sch.inputs, args):
            provided[nm] = a
        for k in list(kwargs.keys()):
            if k in sch.inputs or k in sch.aux:
                provided[k] = kwargs.pop(k)
        attrs = kwargs
        no_bias = attrs.get("no_bias", False)
        for nm in sch.inputs + sch.aux:
            if nm == "bias" and no_bias:
                continue
            if nm in provided and provided[nm] is not None:
                inputs.append(provided[nm])
            elif nm == "label":
                inputs.append(Variable(f"{name}_label"))
            elif nm == "data":
                raise MXNetError(f"{op_name}: 'data' input required")
            else:
                inputs.append(Variable(f"{name}_{nm}"))
    else:
        # generic op: positional Symbol args; Symbol kwargs appended
        inputs = list(args)
        for k in list(kwargs.keys()):
            if isinstance(kwargs[k], Symbol):
                inputs.append(kwargs.pop(k))
        attrs = kwargs

    heads_in = []
    for a in inputs:
        if not isinstance(a, Symbol):
            raise MXNetError(
                f"{op_name}: symbolic inputs must be Symbols, got {type(a)}")
        if len(a._heads) != 1:
            raise MXNetError(f"{op_name}: grouped symbol not a valid input")
        heads_in.append(a._heads[0])

    node = _Node(op_name, name, heads_in, attrs)
    return Symbol([(node, 0)])


def _make_sym_op(op_name):
    def op(*args, **kwargs):
        return _invoke(op_name, list(args), kwargs)
    op.__name__ = op_name
    return op


def __getattr__(name):
    if name in _ops.OPS:
        fn = _make_sym_op(name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'symbol' has no attribute '{name}'")


def zeros(shape, dtype=None, **kwargs):
    return _invoke("_zeros", [], {"shape": tuple(shape),
                                  "dtype": dtype or "float32"})


def ones(shape, dtype=None, **kwargs):
    return _invoke("_ones", [], {"shape": tuple(shape),
                                 "dtype": dtype or "float32"})


# --------------------------------------------------------------------------
# deserialization
# --------------------------------------------------------------------------

def load_json(json_str):
    return _load_json_dict(json.loads(json_str))


def _load_json_dict(d):
    nodes = []
    for nd_ in d["nodes"]:
        attrs = {k: ast.literal_eval(v) for k, v in
                 nd_.get("attrs", {}).items()}
        for k, sub in nd_.get("subgraphs", []):
            attrs[k] = _load_json_dict(sub)
        node = _Node(None if nd_["op"] == "null" else nd_["op"],
                     nd_["name"], attrs=attrs,
                     shape=tuple(nd_["shape"]) if nd_.get("shape") else None)
        # restore the graph's own attrs; never the ambient AttrScope
        node.scope_attrs = dict(nd_.get("scope_attrs", {}))
        node.inputs = [(nodes[i], oi) for i, oi, _ in nd_["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _ in d["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


from . import executor  # noqa: E402,F401
from . import contrib   # noqa: E402,F401  (sym.contrib.<op> namespace)
from .executor import Executor  # noqa: E402,F401
__all__ += ["Executor"]
