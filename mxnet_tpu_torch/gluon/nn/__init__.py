"""Gluon layers of the port (counterpart of
`mxnet_tpu/gluon/nn/__init__.py`): Dense, Embedding, LayerNorm,
BatchNorm, Dropout, Activation, LeakyReLU, Flatten, the convolutions,
the pooling layers and HybridSequential, with the JAX package's
parameter names, shapes and dtypes (Dense weight is (units, in_units),
a convolution's (channels, in_channels / groups, *kernel); LayerNorm and
BatchNorm parameters are float32 whatever the model dtype until
`Block.cast`).

`in_units` / `in_channels` left at 0 defer the parameter's shape to the
layer's first forward (`Block._resolve_deferred`)."""
from __future__ import annotations

import math

import torch

from ...ops import nn_ops
from ..block import Block, HybridBlock, HybridSequential, training
from ..parameter import Parameter

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "BatchNorm",
           "Activation", "LeakyReLU", "Flatten", "Conv1D", "Conv2D",
           "Conv3D", "MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "HybridSequential", "Block", "HybridBlock"]


class Dense(HybridBlock):
    """Fully connected layer: activation(x @ weight.T + bias); with
    `flatten` the input is reshaped to (batch, -1) first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._act = activation
        self.weight = Parameter("weight", (units, in_units), dtype,
                                weight_initializer)
        self.bias = Parameter("bias", (units,), dtype, bias_initializer) \
            if use_bias else None

    def infer_param_shapes(self, x_shape):
        in_units = math.prod(x_shape[1:]) if self._flatten else x_shape[-1]
        return {"weight": (self._units, in_units)}

    def forward(self, x):
        self._resolve_deferred(x)
        out = nn_ops.fully_connected(x, self.weight, self.bias,
                                     flatten=self._flatten)
        return nn_ops.activation(out, self._act) if self._act else out


class Dropout(HybridBlock):
    """Inverted dropout at `rate`, active only in training mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = rate

    def forward(self, x):
        return nn_ops.dropout(x, self._rate, training=training(self))


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

    def infer_param_shapes(self, x_shape):
        return {"gamma": (x_shape[-1],), "beta": (x_shape[-1],)}

    def forward(self, x):
        self._resolve_deferred(x)
        return nn_ops.layer_norm(x, self.gamma, self.beta,
                                 eps=self._epsilon)


class BatchNorm(HybridBlock):
    """Batch normalisation over `axis` with the running statistics
    `running_mean` / `running_var` as 'null' parameters: a training
    forward normalises by the batch's statistics and moves the running
    ones in place (MXNet's momentum: new = momentum * old + (1 -
    momentum) * batch, biased variance); an evaluation forward, or
    `use_global_stats`, normalises by the running ones. `scale=False`
    fixes gamma at 1 and `center=False` keeps beta out of training."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self.gamma = Parameter("gamma", shape, "float32", gamma_initializer,
                               grad_req="write" if scale else "null")
        self.beta = Parameter("beta", shape, "float32", beta_initializer,
                              grad_req="write" if center else "null")
        self.running_mean = Parameter("running_mean", shape, "float32",
                                      running_mean_initializer,
                                      grad_req="null")
        self.running_var = Parameter("running_var", shape, "float32",
                                     running_variance_initializer,
                                     grad_req="null")

    def infer_param_shapes(self, x_shape):
        c = (x_shape[self._axis],)
        return {"gamma": c, "beta": c, "running_mean": c, "running_var": c}

    def forward(self, x):
        self._resolve_deferred(x)
        out, mean, var = nn_ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training(self))
        if mean is not self.running_mean:
            with torch.no_grad():
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        return out


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return nn_ops.activation(x, self._act)


class LeakyReLU(HybridBlock):
    """x where x >= 0, else alpha * x (`nn_ops.leaky_relu`)."""

    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return nn_ops.leaky_relu(x, "leaky", self._alpha)


class Flatten(HybridBlock):
    def forward(self, x):
        return nn_ops.flatten(x)


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    """N-D convolution: weight (channels, in_channels / groups, *kernel),
    optional bias (channels,), optional activation after."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, ndim, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros"):
        super().__init__()
        self._channels = channels
        self._groups = groups
        self._kernel = _tuple(kernel_size, ndim)
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._act = activation
        self.weight = Parameter(
            "weight", (channels, in_channels // groups) + self._kernel,
            "float32", weight_initializer)
        self.bias = Parameter("bias", (channels,), "float32",
                              bias_initializer) if use_bias else None

    def infer_param_shapes(self, x_shape):
        return {"weight": (self._channels, x_shape[1] // self._groups)
                + self._kernel}

    def forward(self, x):
        self._resolve_deferred(x)
        out = nn_ops.convolution(
            x, self.weight, self.bias, kernel=self._kernel,
            stride=self._strides, dilate=self._dilation, pad=self._padding,
            num_filter=self._channels, num_group=self._groups,
            no_bias=self.bias is None)
        return nn_ops.activation(out, self._act) if self._act else out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, 1, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, 2, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, 3, **kwargs)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ndim, ceil_mode,
                 pool_type, global_pool=False, count_include_pad=True):
        super().__init__()
        self._kwargs = dict(
            kernel=_tuple(pool_size, ndim) if pool_size else None,
            stride=None if global_pool else _tuple(
                strides if strides is not None else pool_size, ndim),
            pad=_tuple(padding, ndim), pool_type=pool_type,
            global_pool=global_pool,
            pooling_convention="full" if ceil_mode else "valid",
            count_include_pad=count_include_pad)

    def forward(self, x):
        return nn_ops.pooling(x, **self._kwargs)


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, 1, ceil_mode, "max")


class MaxPool2D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, 2, ceil_mode, "max")


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, 1, ceil_mode, "avg",
                         count_include_pad=count_include_pad)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, 2, ceil_mode, "avg",
                         count_include_pad=count_include_pad)


class GlobalMaxPool1D(_Pool):
    def __init__(self):
        super().__init__(None, None, 0, 1, False, "max", global_pool=True)


class GlobalMaxPool2D(_Pool):
    def __init__(self):
        super().__init__(None, None, 0, 2, False, "max", global_pool=True)


class GlobalAvgPool1D(_Pool):
    def __init__(self):
        super().__init__(None, None, 0, 1, False, "avg", global_pool=True)


class GlobalAvgPool2D(_Pool):
    def __init__(self):
        super().__init__(None, None, 0, 2, False, "avg", global_pool=True)
