"""Executor: bind a Symbol graph to arrays and run it (counterpart of
`mxnet_tpu/symbol/executor.py`; reference `GraphExecutor`,
`src/executor/graph_executor.cc`, and `python/mxnet/executor.py`).

`forward` evaluates the DAG eagerly, node by node, with the registry's
functions (`_eval_graph`) on the device of the bound arrays, under the
training flag of `is_train` (`autograd.set_training`, which `Dropout`,
`BatchNorm` and the flash ops read). `forward(is_train=True)` keeps the
autograd graph: each argument whose `grad_req` is not "null" enters it
as a fresh leaf. `backward(out_grads)` runs `torch.autograd.grad` from
the heads (seeded with ones when no head gradient is given) to those
leaves and writes each gradient into `grad_dict` by its `grad_req`:
"write" replaces it, "add" sums into it. The graph is kept until the
next forward, so `backward` may run more than once, as in the JAX
package.

The JAX `backward` replays the forward in training mode with the last
forward's random key, so it works after `forward(is_train=False)` too.
Here every forward first snapshots the random streams
(`random.get_state`); a backward that finds no training graph reruns the
forward in training mode from that snapshot, so a `Dropout` or flash
dropout mask is the one a training forward would have drawn, then puts
the streams back where they were. Moving statistics are written back
(`SCHEMAS` aux_map) only by a forward with `is_train`, never by the
replay.

`simple_bind` allocates on the bound `ctx`, else on the card
(`context.resolve`); `bind` runs on `ctx`, else on the device of the
arrays it is given.
"""
from __future__ import annotations

import torch

from .. import autograd as _autograd
from .. import context as _context
from .. import ops as _ops
from .. import random as _random
from ..base import MXNetError
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray


def _eval_graph(sym, values, training):
    """Evaluate the DAG: values maps var name -> tensor. Returns (head
    outputs list, aux updates dict name -> tensor). The caller sets the
    training flag and grad mode."""
    from . import _schema_for

    memo = {}
    aux_updates = {}
    for node in sym._topo_nodes():
        if node.is_var:
            if node.name not in values:
                raise MXNetError(f"unbound variable '{node.name}'")
            memo[id(node)] = (values[node.name],)
            continue
        ins = [memo[id(src)][idx] for src, idx in node.inputs]
        out = _ops.get(node.op)(*ins, **node.attrs)
        outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        sch = _schema_for(node.op)
        if sch and sch.aux_map and training:
            # aux inputs are always the trailing len(sch.aux) inputs
            for out_idx, aux_pos in sch.aux_map:
                src, _ = node.inputs[len(node.inputs) - len(sch.aux)
                                     + aux_pos]
                aux_updates[src.name] = outs[out_idx]
        if sch:
            outs = outs[:sch.visible] if sch.visible < len(outs) else outs
        memo[id(node)] = outs
    heads = [memo[id(node)][idx] for node, idx in sym._heads]
    return heads, aux_updates


def _device_context(device):
    """The Context of a torch device (ops with no inputs, `_zeros` and
    `_ones`, make their tensor on the entered context's device)."""
    if device.type == "cpu":
        return _context.cpu()
    return _context.gpu(device.index or 0)


def _as_nd(v, device):
    return v if isinstance(v, NDArray) else _nd.array(v, ctx=device)


class Executor:
    """Reference surface: forward/backward/outputs/arg_dict/grad_dict/
    aux_dict (`python/mxnet/executor.py`)."""

    def __init__(self, sym, arg_dict, grad_dict, aux_dict, grad_req,
                 device):
        self._symbol = sym
        self._device = device
        self.arg_dict = arg_dict      # name -> NDArray
        self.grad_dict = grad_dict    # name -> NDArray | None
        self.aux_dict = aux_dict      # name -> NDArray
        self._grad_req = grad_req     # name -> 'write'|'add'|'null'
        self.outputs = []
        self._graph = None            # (leaves, heads) of a training run
        self._rng = None              # the streams before the last forward

    # ------------------------------------------------------------------
    @classmethod
    def _simple_bind(cls, sym, ctx, grad_req, shapes):
        device = _context.resolve(ctx)
        shape_dict = sym._infer_shapes_dict(shapes)
        # honor explicit var dtype hints (e.g. int8 quantized weights)
        dtype_of = {n.name: n._dtype for n in sym._var_nodes()
                    if n._dtype is not None}
        arg_dict, grad_dict, aux_dict = {}, {}, {}
        req = {}
        for name in sym.list_arguments():
            if name not in shape_dict:
                raise MXNetError(
                    f"simple_bind: cannot infer shape of '{name}'; "
                    f"provide it explicitly")
            arg_dict[name] = _nd.zeros(shape_dict[name], ctx=device,
                                       dtype=dtype_of.get(name, "float32"))
            r = grad_req if isinstance(grad_req, str) \
                else grad_req.get(name, "write")
            req[name] = r
            grad_dict[name] = _nd.zeros(shape_dict[name], ctx=device) \
                if r != "null" else None
        for name in sym.list_auxiliary_states():
            aux_dict[name] = _nd.zeros(shape_dict[name], ctx=device)
        return cls(sym, arg_dict, grad_dict, aux_dict, req, device)

    @classmethod
    def _bind(cls, sym, ctx, args, args_grad, grad_req, aux_states):
        if ctx is not None:
            device = _context.resolve(ctx)
        else:
            given = list(args.values()) if isinstance(args, dict) \
                else list(args or [])
            first = next((a for a in given if isinstance(a, NDArray)), None)
            device = first._t.device if first is not None \
                else _context.resolve(None)

        def to_dict(vals, names):
            if vals is None:
                return {}
            if isinstance(vals, dict):
                return {k: _as_nd(v, device) for k, v in vals.items()}
            return {n: _as_nd(v, device) for n, v in zip(names, vals)}

        arg_names = sym.list_arguments()
        arg_dict = to_dict(args, arg_names)
        grad_dict = to_dict(args_grad, arg_names)
        aux_dict = to_dict(aux_states, sym.list_auxiliary_states())
        req = {n: (grad_req if isinstance(grad_req, str)
                   else grad_req.get(n, "write")) if n in grad_dict
               else "null" for n in arg_names}
        for n in arg_names:
            if n not in grad_dict:
                grad_dict[n] = None
        return cls(sym, arg_dict, grad_dict, aux_dict, req, device)

    # ------------------------------------------------------------------
    def _run(self, training):
        """Evaluate the graph on the bound arrays: (leaves, heads, aux
        updates), leaves [(name, tensor)] the gradient's inputs when
        training."""
        values, leaves = {}, []
        for n, arr in self.arg_dict.items():
            t = arr._t
            if training and self._grad_req.get(n, "null") != "null" \
                    and t.is_floating_point():
                t = t.detach().requires_grad_(True)
                leaves.append((n, t))
            values[n] = t
        for n, arr in self.aux_dict.items():
            values[n] = arr._t
        prev = _autograd.set_training(training)
        try:
            with torch.set_grad_enabled(bool(leaves)), \
                    _device_context(self._device):
                heads, aux_up = _eval_graph(self._symbol, values, training)
        finally:
            _autograd.set_training(prev)
        return leaves, heads, aux_up

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument '{k}'")
            dst = self.arg_dict[k]
            src = v._t if isinstance(v, NDArray) else \
                _nd.array(v, ctx=self._device)._t
            dst._t = src.to(device=dst._t.device, dtype=dst._t.dtype)
        self._graph = None              # free the last step's activations
        self._rng = _random.get_state()
        leaves, heads, aux_up = self._run(bool(is_train))
        if is_train:
            self._graph = (leaves, heads)
            for n, a in aux_up.items():
                if n in self.aux_dict:
                    self.aux_dict[n]._t = a.detach()
        self.outputs = [NDArray(h.detach()) for h in heads]
        return self.outputs

    def backward(self, out_grads=None):
        if self._graph is None:
            # the last forward kept no training graph: replay it in
            # training mode from the streams it started from
            after = _random.get_state()
            if self._rng is not None:
                _random.set_state(self._rng)
            try:
                leaves, heads, _ = self._run(True)
            finally:
                _random.set_state(after)
            self._graph = (leaves, heads)
        leaves, heads = self._graph
        if out_grads is None:
            seeds = [torch.ones_like(h) for h in heads]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            seeds = [(g._t if isinstance(g, NDArray)
                      else torch.as_tensor(g)).to(device=h.device,
                                                  dtype=h.dtype)
                     for g, h in zip(out_grads, heads)]
        pairs = [(h, s) for h, s in zip(heads, seeds) if h.requires_grad]
        tensors = [t for _, t in leaves]
        if pairs and tensors:
            grads = torch.autograd.grad(
                [h for h, _ in pairs], tensors, [s for _, s in pairs],
                retain_graph=True, allow_unused=True)
        else:
            grads = [None] * len(tensors)
        with torch.no_grad():
            for (n, t), g in zip(leaves, grads):
                g = torch.zeros_like(t) if g is None else g
                dst = self.grad_dict[n]
                if self._grad_req[n] == "add":
                    dst._t = dst._t + g
                else:
                    dst._t = g

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict[n] for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n]
                for n in self._symbol.list_auxiliary_states()]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for src, dst_dict, what in ((arg_params, self.arg_dict, "param"),
                                    (aux_params, self.aux_dict, "aux")):
            for k, v in (src or {}).items():
                if k in dst_dict:
                    dst = dst_dict[k]
                    t = v._t if isinstance(v, NDArray) else torch.as_tensor(v)
                    dst._t = t.detach().to(device=dst._t.device,
                                           dtype=dst._t.dtype).clone()
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {what} '{k}'")
