"""RNN cells (counterpart of `mxnet_tpu/gluon/rnn/rnn_cell.py`).

A cell computes one step: `cell(inputs, states)` returns (output, new
states), on tensors or at the NDArray boundary (states may be given as
NDArrays, as `begin_state` makes them). `unroll` runs the cell over the
time axis in a Python loop; long sequences belong to the fused layers
(`rnn_layer.py`). Cell parameters carry the JAX package's names
(`i2h_weight`, ..., and `0.`, `1.`, `l_cell.`, `r_cell.`, `base_cell.`
for the cells inside others). `DropoutCell` and `ZoneoutCell` are active
in training mode and draw from the device stream of
`mxnet_tpu_torch.random`.
"""
from __future__ import annotations

import torch

from ... import random as _random
from ...ndarray import ndarray as _nd
from ...ndarray.ndarray import NDArray, _unwrap
from ...ops import nn_ops
from ..block import HybridBlock, _wrap, training
from ..parameter import Parameter

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ResidualCell", "ZoneoutCell",
           "BidirectionalCell"]


def _tensors(states):
    return [_unwrap(s) for s in states]


class RecurrentCell(HybridBlock):
    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states: `func(shape=..., **kwargs)` for each (by
        default `nd.zeros`; pass `ctx=` for the CPU)."""
        func = func or _nd.zeros
        return [func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _unroll_inputs(self, inputs, begin_state, layout, valid_length):
        """(inputs as a tensor, its time axis, the begin states as
        tensors: `begin_state` or zeros)."""
        if valid_length is not None:
            raise NotImplementedError(
                "unroll(valid_length=...) is not in the port; use a fused "
                "layer with use_sequence_length=True")
        x = _unwrap(inputs)
        batch = x.shape[layout.find("N")]
        states = _tensors(begin_state) if begin_state is not None else [
            x.new_zeros(info["shape"]) for info in self.state_info(batch)]
        return x, layout.find("T"), states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over `length` steps of `inputs` (layout 'NTC' or
        'TNC'), from `begin_state` or zeros. Returns (outputs stacked on
        the time axis, or their list when `merge_outputs` is False,
        final states)."""
        boundary = isinstance(inputs, NDArray)
        x, axis, states = self._unroll_inputs(inputs, begin_state, layout,
                                              valid_length)
        outputs = []
        for t in range(length):
            out, states = self(x.select(axis, t), states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return (_wrap(outputs), _wrap(states)) if boundary \
            else (outputs, states)


class RNNCell(RecurrentCell):
    """h' = activation(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        self._activation = activation
        self.i2h_weight = Parameter("i2h_weight", (hidden_size, input_size))
        self.h2h_weight = Parameter("h2h_weight", (hidden_size, hidden_size))
        self.i2h_bias = Parameter("i2h_bias", (hidden_size,), init="zeros")
        self.h2h_bias = Parameter("h2h_bias", (hidden_size,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_param_shapes(self, x_shape):
        return {"i2h_weight": (self._hidden_size, x_shape[-1])}

    def forward(self, inputs, states):
        self._resolve_deferred(inputs)
        (h,) = _tensors(states)
        z = nn_ops.fully_connected(inputs, self.i2h_weight, self.i2h_bias) \
            + nn_ops.fully_connected(h, self.h2h_weight, self.h2h_bias)
        out = nn_ops.activation(z, self._activation)
        return out, [out]


class LSTMCell(RecurrentCell):
    """The LSTM step with gates i, f, g, o."""

    def __init__(self, hidden_size, input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        H4 = 4 * hidden_size
        self.i2h_weight = Parameter("i2h_weight", (H4, input_size))
        self.h2h_weight = Parameter("h2h_weight", (H4, hidden_size))
        self.i2h_bias = Parameter("i2h_bias", (H4,), init="zeros")
        self.h2h_bias = Parameter("h2h_bias", (H4,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def infer_param_shapes(self, x_shape):
        return {"i2h_weight": (4 * self._hidden_size, x_shape[-1])}

    def forward(self, inputs, states):
        self._resolve_deferred(inputs)
        h, c = _tensors(states)
        gates = nn_ops.fully_connected(inputs, self.i2h_weight,
                                       self.i2h_bias) \
            + nn_ops.fully_connected(h, self.h2h_weight, self.h2h_bias)
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        out = torch.sigmoid(o) * torch.tanh(c)
        return out, [out, c]


class GRUCell(RecurrentCell):
    """The GRU step with gates r, z, n, the reset gate applied after the
    recurrent product (cuDNN's order)."""

    def __init__(self, hidden_size, input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        H3 = 3 * hidden_size
        self.i2h_weight = Parameter("i2h_weight", (H3, input_size))
        self.h2h_weight = Parameter("h2h_weight", (H3, hidden_size))
        self.i2h_bias = Parameter("i2h_bias", (H3,), init="zeros")
        self.h2h_bias = Parameter("h2h_bias", (H3,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_param_shapes(self, x_shape):
        return {"i2h_weight": (3 * self._hidden_size, x_shape[-1])}

    def forward(self, inputs, states):
        self._resolve_deferred(inputs)
        (h,) = _tensors(states)
        i_r, i_z, i_n = nn_ops.fully_connected(
            inputs, self.i2h_weight, self.i2h_bias).chunk(3, -1)
        h_r, h_z, h_n = nn_ops.fully_connected(
            h, self.h2h_weight, self.h2h_bias).chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        out = (1 - z) * n + z * h
        return out, [out]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input; the
    states are the cells' states one after the other."""

    def add(self, cell):
        self.add_module(str(len(self._modules)), cell)

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size)
                    for c in self._modules.values()), [])

    def forward(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, s = cell(inputs, states[p:p + n])
            next_states += s
            p += n
        return inputs, next_states


class DropoutCell(RecurrentCell):
    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        return nn_ops.dropout(inputs, self._rate,
                              training=training(self)), states


class ResidualCell(RecurrentCell):
    """The base cell's output plus its input."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def forward(self, inputs, states):
        out, states = self.base_cell(inputs, states)
        return out + inputs, states


class ZoneoutCell(RecurrentCell):
    """Zoneout: in training, each output element keeps the previous
    step's output with probability `zoneout_outputs`, and each state
    element its previous value with probability `zoneout_states`."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__()
        self.base_cell = base_cell
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def reset(self):
        self._prev_output = None

    def _draw(self, like, p):
        """True where the previous value is kept (probability p)."""
        return torch.rand(like.shape, device=like.device,
                          generator=_random.generator(like.device)) < p

    def forward(self, inputs, states):
        states = _tensors(states)
        out, next_states = self.base_cell(inputs, states)
        if training(self):
            if self._zo > 0:
                prev = self._prev_output
                if prev is None:
                    prev = torch.zeros_like(out)
                out = torch.where(self._draw(out, self._zo), prev, out)
            if self._zs > 0:
                next_states = [torch.where(self._draw(ns, self._zs), s, ns)
                               for s, ns in zip(states, next_states)]
        self._prev_output = out
        return out, next_states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence, the right one reversed in time; only
    `unroll` runs it (outputs concatenated on the feature axis)."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) \
            + self.r_cell.state_info(batch_size)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        boundary = isinstance(inputs, NDArray)
        x, axis, states = self._unroll_inputs(inputs, begin_state, layout,
                                              valid_length)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, x, states[:nl], layout,
                                             True)
        r_out, r_states = self.r_cell.unroll(length, x.flip(axis),
                                             states[nl:], layout, True)
        out = torch.cat([l_out, r_out.flip(axis)], dim=2)
        states = l_states + r_states
        return (_wrap(out), _wrap(states)) if boundary else (out, states)
