"""SymbolBlock: run a symbolic graph as a gluon Block (counterpart of
`mxnet_tpu/gluon/symbol_block.py`; reference: `python/mxnet/gluon/
block.py` SymbolBlock, the bridge that loads `net.export()`ed symbol
JSON and params back into the imperative API).

Each argument of the graph that is not an input, and each auxiliary
state, becomes a port `Parameter` (a torch parameter under an
attribute-safe name: "." and ":" become "_"); auxiliary states are
`grad_req` "null". The forward evaluates the graph with the executor's
`_eval_graph` on the parameters' tensors, under the block's training
mode (`gluon.block.training`), so inside `autograd.record()` the
parameters record gradients as any block's do; in training the new
moving statistics are written back into their parameters.

A parameter that `params` does not give has no shape until the first
forward: its shape is then inferred from the inputs' (`infer_shape`) and
it is filled by the initializer `initialize()` chose (uniform by
default), as a deferred parameter is; without `initialize()` the forward
raises.
"""
from __future__ import annotations

import torch

from .. import autograd as _autograd
from .. import initializer as _init
from ..base import MXNetError
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray
from .block import HybridBlock, training
from .parameter import Parameter, set_data

__all__ = ["SymbolBlock"]


def _safe(name):
    return name.replace(".", "_").replace(":", "_")


class SymbolBlock(HybridBlock):
    """Wrap `outputs` (a Symbol, or a list of them) with free `inputs`
    (Symbols made by `sym.var`, or their names) into a callable Block
    whose non-input arguments are Parameters."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__()
        from .. import symbol as sym_mod
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        self._symbol = outputs
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._input_names = [i.name if hasattr(i, "name") else str(i)
                             for i in inputs]
        self._param_names = [n for n in outputs.list_arguments()
                             if n not in self._input_names]
        self._aux_names = list(outputs.list_auxiliary_states())
        self._init_request = None
        params = params or {}
        for name in self._param_names + self._aux_names:
            src = params.get(name)
            if src is not None:
                self._add_param(name, src._t if isinstance(src, NDArray)
                                else torch.as_tensor(src))

    def _add_param(self, name, value=None, shape=None, device=None):
        """Register the parameter `name`, holding `value` or, of `shape`
        on `device`, filled by `initialize()`'s choice."""
        aux = name in self._aux_names
        t = value
        p = Parameter(name, tuple(t.shape) if t is not None else shape,
                      t.dtype if t is not None else "float32",
                      grad_req="null" if aux else "write")
        if t is not None:
            p.data = torch.empty(t.shape, dtype=t.dtype, device=t.device)
            set_data(p, t)
        else:
            if self._init_request is None:
                raise MXNetError(
                    f"SymbolBlock: parameter '{name}' was not given and "
                    "the block was not initialised; call .initialize()")
            init, generator = self._init_request
            p.data = torch.empty(shape, device=device)
            _init._fill(init, name, p.data, generator)
            p.mx_initialized = True
        setattr(self, _safe(name), p)
        return p

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, device=None, generator=None):
        """`Block.initialize` for the parameters that exist; the ones the
        first forward creates are filled by the same choice."""
        self._init_request = (_init.create(init or "uniform"), generator)
        return super().initialize(init, ctx, verbose, force_reinit,
                                  device=device, generator=generator)

    @classmethod
    def imports(cls, symbol_file, input_names, param_file=None, ctx=None):
        """Load an exported model: symbol JSON and optionally a .params
        file (its `arg:`/`aux:` prefixes stripped) onto `ctx` (the card
        unless the caller names another device)."""
        from .. import symbol as sym_mod
        outputs = sym_mod.load(symbol_file)
        input_names = input_names if isinstance(input_names, (list, tuple)) \
            else [input_names]
        inputs = [sym_mod.var(n) for n in input_names]
        params = {}
        if param_file:
            for k, v in _nd.load(param_file, ctx=ctx).items():
                params[k.split(":", 1)[-1]] = v
        return cls(outputs, inputs, params=params)

    def _param(self, name):
        return getattr(self, _safe(name), None)

    def forward(self, *args):
        values = dict(zip(self._input_names, args))
        missing = [n for n in self._param_names + self._aux_names
                   if self._param(n) is None]
        if missing:
            args_s, _, aux_s = self._symbol.infer_shape(
                **{n: tuple(a.shape) for n, a in values.items()})
            shapes = dict(zip(self._symbol.list_arguments(), args_s))
            shapes.update(zip(self._aux_names, aux_s))
            for n in missing:
                self._add_param(n, shape=shapes[n], device=args[0].device)
        for name in self._param_names + self._aux_names:
            values[name] = self._param(name)
        from ..symbol.executor import _eval_graph
        train = training(self)
        prev = _autograd.set_training(train)
        try:
            outs, aux_updates = _eval_graph(self._symbol, values, train)
        finally:
            _autograd.set_training(prev)
        with torch.no_grad():
            for name, val in aux_updates.items():
                p = self._param(name)
                if p is not None:
                    p.copy_(val)
        return outs[0] if len(outs) == 1 else list(outs)
