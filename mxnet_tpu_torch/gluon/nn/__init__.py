"""Gluon layers of the port (counterpart of
`mxnet_tpu/gluon/nn/__init__.py`): Dense, Embedding, LayerNorm, Dropout
and HybridSequential, with the JAX package's parameter names, shapes and
dtypes (Dense weight is (units, in_units); LayerNorm gamma/beta are
float32 masters whatever the model dtype)."""
from __future__ import annotations

from ...ops import nn_ops
from ..block import Block, HybridBlock, HybridSequential
from ..parameter import Parameter

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "HybridSequential",
           "Block", "HybridBlock"]


class Dense(HybridBlock):
    """Fully connected layer: activation(x @ weight.T + bias); with
    `flatten` the input is reshaped to (batch, -1) first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense needs in_units: the port has no "
                             "deferred shape inference")
        self._flatten = flatten
        self._act = activation
        self.weight = Parameter("weight", (units, in_units), dtype,
                                weight_initializer)
        self.bias = Parameter("bias", (units,), dtype, bias_initializer) \
            if use_bias else None

    def forward(self, x):
        out = nn_ops.fully_connected(x, self.weight, self.bias,
                                     flatten=self._flatten)
        return nn_ops.activation(out, self._act) if self._act else out


class Dropout(HybridBlock):
    """Inverted dropout at `rate`, active only in training mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        return nn_ops.dropout(x, self._rate, training=self.training)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None):
        super().__init__()
        self.weight = Parameter("weight", (input_dim, output_dim), dtype,
                                weight_initializer)

    def forward(self, x):
        return nn_ops.embedding(x, self.weight)


class LayerNorm(HybridBlock):
    """Normalization over the last axis."""

    def __init__(self, epsilon=1e-5, beta_initializer="zeros",
                 gamma_initializer="ones", in_channels=0):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", (in_channels,), "float32",
                               gamma_initializer)
        self.beta = Parameter("beta", (in_channels,), "float32",
                              beta_initializer)

    def forward(self, x):
        return nn_ops.layer_norm(x, self.gamma, self.beta,
                                 eps=self._epsilon)
