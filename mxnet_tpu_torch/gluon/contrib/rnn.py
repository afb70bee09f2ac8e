"""gluon.contrib.rnn (counterpart of `mxnet_tpu/gluon/contrib/rnn.py`;
reference: `python/mxnet/gluon/contrib/rnn/rnn_cell.py`
VariationalDropoutCell and LSTMPCell, `conv_rnn_cell.py`
Conv2DLSTMCell).

VariationalDropoutCell holds one dropout mask per sequence (Gal and
Ghahramani's variational dropout): each mask is drawn on the first
training step after `reset()`, from the device stream of
`mxnet_tpu_torch.random`, and reused at every later step. Conv2DLSTMCell
is an LSTM whose i2h/h2h transforms are convolutions over NCHW maps;
LSTMPCell projects the hidden state down to `projection_size` before it
recurs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import random as _random
from ...ndarray.ndarray import NDArray
from ...ops import nn_ops
from ..block import training
from ..parameter import Parameter
from ..rnn.rnn_cell import RecurrentCell, _tensors

__all__ = ["VariationalDropoutCell", "LSTMPCell", "Conv2DLSTMCell"]


class VariationalDropoutCell(RecurrentCell):
    """Wrap `base_cell` with per-sequence (not per-step) dropout masks on
    its inputs, states and outputs, active in training mode. `reset()`
    (which `unroll` calls) draws new masks at the next step. The masks
    are kept as NDArrays (`_input_mask`, `_state_mask`,
    `_output_mask`)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__()
        self.base_cell = base_cell
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self.reset()

    def reset(self):
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    @staticmethod
    def _mask(rate, like):
        keep = torch.rand(like.shape, generator=_random.generator(
            like.device), device=like.device) >= rate
        return NDArray(keep.float() / (1.0 - rate))

    def forward(self, inputs, states):
        train = training(self)
        if train and self._drop_inputs > 0:
            if self._input_mask is None:
                self._input_mask = self._mask(self._drop_inputs, inputs)
            inputs = inputs * self._input_mask._t
        states = _tensors(states)
        if train and self._drop_states > 0:
            if self._state_mask is None:
                self._state_mask = self._mask(self._drop_states, states[0])
            states = [states[0] * self._state_mask._t] + states[1:]
        out, next_states = self.base_cell(inputs, states)
        if train and self._drop_outputs > 0:
            if self._output_mask is None:
                self._output_mask = self._mask(self._drop_outputs, out)
            out = out * self._output_mask._t
        return out, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state, layout,
                              merge_outputs, valid_length)


class LSTMPCell(RecurrentCell):
    """LSTM with a projected recurrent state (reference LSTMPCell, the
    LSTMP of Sak et al.): the cell keeps `hidden_size` internals but
    recurs and outputs a `projection_size` vector."""

    def __init__(self, hidden_size, projection_size, input_size=0):
        super().__init__()
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        h4 = 4 * hidden_size
        self.i2h_weight = Parameter("i2h_weight", (h4, input_size))
        self.h2h_weight = Parameter("h2h_weight", (h4, projection_size))
        self.h2r_weight = Parameter("h2r_weight",
                                    (projection_size, hidden_size))
        self.i2h_bias = Parameter("i2h_bias", (h4,), init="zeros")
        self.h2h_bias = Parameter("h2h_bias", (h4,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def infer_param_shapes(self, x_shape):
        return {"i2h_weight": (4 * self._hidden_size, x_shape[-1])}

    def forward(self, inputs, states):
        self._resolve_deferred(inputs)
        r, c = _tensors(states)
        gates = nn_ops.fully_connected(inputs, self.i2h_weight,
                                       self.i2h_bias) \
            + nn_ops.fully_connected(r, self.h2h_weight, self.h2h_bias)
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(c)
        r = nn_ops.fully_connected(hidden, self.h2r_weight, None)
        return r, [r, c]


def _pair(k):
    return (k, k) if isinstance(k, int) else tuple(k)


class Conv2DLSTMCell(RecurrentCell):
    """Convolutional LSTM over NCHW maps (reference Conv2DLSTMCell, Shi et
    al. 2015). `input_shape` is (channels, H, W); the gates come from
    i2h/h2h convolutions with 'same' padding, so the states keep the
    spatial shape."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel=3,
                 h2h_kernel=3):
        super().__init__()
        in_c, in_h, in_w = input_shape
        self._shape = (in_c, in_h, in_w)
        self._hidden_channels = hidden_channels
        self._i2h_kernel = _pair(i2h_kernel)
        self._h2h_kernel = _pair(h2h_kernel)
        if any(k % 2 == 0 for k in self._i2h_kernel + self._h2h_kernel):
            raise ValueError("Conv2DLSTMCell kernels must be odd for "
                             "'same' padding")
        hc4 = 4 * hidden_channels
        self.i2h_weight = Parameter("i2h_weight",
                                    (hc4, in_c) + self._i2h_kernel)
        self.h2h_weight = Parameter(
            "h2h_weight", (hc4, hidden_channels) + self._h2h_kernel)
        self.i2h_bias = Parameter("i2h_bias", (hc4,), init="zeros")
        self.h2h_bias = Parameter("h2h_bias", (hc4,), init="zeros")

    def state_info(self, batch_size=0):
        _, h, w = self._shape
        return [{"shape": (batch_size, self._hidden_channels, h, w)},
                {"shape": (batch_size, self._hidden_channels, h, w)}]

    def forward(self, inputs, states):
        h, c = _tensors(states)
        gates = F.conv2d(inputs, self.i2h_weight, self.i2h_bias,
                         padding=tuple(k // 2 for k in self._i2h_kernel)) \
            + F.conv2d(h, self.h2h_weight, self.h2h_bias,
                       padding=tuple(k // 2 for k in self._h2h_kernel))
        i, f, g, o = gates.chunk(4, 1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        out = torch.sigmoid(o) * torch.tanh(c)
        return out, [out, c]
