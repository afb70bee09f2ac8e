"""Fused multi-layer RNN layers (counterpart of
`mxnet_tpu/gluon/rnn/rnn_layer.py`): `RNN`, `LSTM` and `GRU` over
`ops.rnn_ops`.

Each layer and direction keeps its weights as separate Parameters named
`{l|r}{layer}_{i2h|h2h}_{weight|bias}`, the JAX package's names, so
`weights.load_named_arrays` carries JAX weights by name. The first
layer's `i2h_weight` waits for its input size when `input_size` is 0.
The op takes them as they are (no packed vector is built). A call
`layer(inputs)` returns the output; `layer(inputs, states)` returns
(output, new states). A layer built with `use_sequence_length` demands
`layer(inputs, states, sequence_length)`. Inter-layer dropout is active
in training mode (`gluon.block.training`).
"""
from __future__ import annotations

from ...ndarray import ndarray as _nd
from ...ndarray.ndarray import _unwrap
from ...ops import rnn_ops
from ..block import HybridBlock, training
from ..parameter import Parameter

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", use_sequence_length=False):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise ValueError(f"RNN layout {layout!r} is not TNC or NTC")
        self._mode = mode
        self._use_sequence_length = use_sequence_length
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        ng = rnn_ops.GATES[mode]
        for layer in range(num_layers):
            for d in range(self._dir):
                pfx = f"{'lr'[d]}{layer}_"
                isz = input_size if layer == 0 else hidden_size * self._dir
                for name, shape, init in (
                        ("i2h_weight", (ng * hidden_size, isz),
                         i2h_weight_initializer),
                        ("h2h_weight", (ng * hidden_size, hidden_size),
                         h2h_weight_initializer),
                        ("i2h_bias", (ng * hidden_size,),
                         i2h_bias_initializer),
                        ("h2h_bias", (ng * hidden_size,),
                         h2h_bias_initializer)):
                    setattr(self, pfx + name,
                            Parameter(pfx + name, shape, init=init))

    def infer_param_shapes(self, x_shape):
        ng = rnn_ops.GATES[self._mode]
        return {f"{'lr'[d]}0_i2h_weight": (ng * self._hidden_size,
                                            x_shape[-1])
                for d in range(self._dir)}

    def state_info(self, batch_size=0):
        ns = self._num_layers * self._dir
        info = [{"shape": (ns, batch_size, self._hidden_size)}]
        if self._mode == "lstm":
            info.append({"shape": (ns, batch_size, self._hidden_size)})
        return info

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: `func(shape=..., **kwargs)` for each (by
        default `nd.zeros`; pass `ctx=` for the CPU)."""
        func = func or _nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None, sequence_length=None):
        self._resolve_deferred(inputs)
        batch = inputs.shape[0 if self._layout == "NTC" else 1]
        ret_states = states is not None
        if states is None:
            states = [inputs.new_zeros(info["shape"])
                      for info in self.state_info(batch)]
        elif not isinstance(states, (list, tuple)):
            states = [states]
        states = [_unwrap(s) for s in states]
        if self._use_sequence_length and sequence_length is None:
            raise ValueError(
                "this layer was built with use_sequence_length=True; "
                "call it as layer(inputs, states, sequence_length)")
        layers = []
        for layer in range(self._num_layers):
            for d in range(self._dir):
                pfx = f"{'lr'[d]}{layer}_"
                layers.append({k: getattr(self, pfx + name) for k, name in (
                    ("wi", "i2h_weight"), ("wh", "h2h_weight"),
                    ("bi", "i2h_bias"), ("bh", "h2h_bias"))})
        x = inputs.transpose(0, 1) if self._layout == "NTC" else inputs
        out, h, c = rnn_ops.rnn_layers(
            x, layers, states[0], states[1] if self._mode == "lstm" else None,
            self._mode, self._dir == 2,
            _unwrap(sequence_length) if self._use_sequence_length else None,
            self._dropout, training(self))
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if not ret_states:
            return out
        return out, [h, c] if self._mode == "lstm" else [h]


class RNN(_RNNLayer):
    """Elman RNN with relu or tanh."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
