"""Gluon layers of the port (counterpart of
`mxnet_tpu/gluon/nn/__init__.py`): Dense, Embedding, LayerNorm,
GroupNorm, InstanceNorm, BatchNorm, Dropout, the activations
(Activation, LeakyReLU, PReLU, ELU, SELU, GELU, Swish), Flatten, Lambda
and HybridLambda, the convolutions (Conv2DTranspose included), the 1-3D
pooling layers, Sequential and HybridSequential, with the JAX package's
parameter names, shapes and dtypes (Dense weight is (units, in_units),
a convolution's (channels, in_channels / groups, *kernel), a transposed
convolution's (in_channels, channels / groups, *kernel); the
normalisation layers' parameters are float32 whatever the model dtype
until `Block.cast`).

The layers of the training paths (Dense, the convolutions, pooling,
LayerNorm over the last axis, BatchNorm, Dropout, Embedding) run their
`forward` on the port's functions directly; the others are the JAX
package's `hybrid_forward` over the registry's ops. Dense, Activation,
Dropout and Flatten also have the JAX `hybrid_forward`, the symbolic
form that `HybridBlock.export` traces.

`in_units` / `in_channels` left at 0 defer the parameter's shape to the
layer's first forward (`Block._resolve_deferred`)."""
from __future__ import annotations

import math

import torch

from ...ops import nn_ops
from ..block import (Block, HybridBlock, HybridSequential, Sequential,
                     training)
from ..parameter import Parameter

__all__ = ["Dense", "Dropout", "Embedding", "LayerNorm", "GroupNorm",
           "InstanceNorm", "BatchNorm", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "GELU", "Swish", "Flatten", "Lambda",
           "HybridLambda", "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "Sequential",
           "HybridSequential", "Block", "HybridBlock"]


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

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        return F.Activation(out, act_type=self._act) if self._act else out


class Dropout(HybridBlock):
    """Inverted dropout at `rate`, active only in training mode; `axes`
    share one draw along each axis named."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return nn_ops.dropout(x, self._rate, training=training(self),
                              axes=self._axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class Embedding(HybridBlock):
    """A lookup table (input_dim, output_dim). `sparse_grad` is accepted,
    as in the JAX package, and the gradient stays dense."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self.weight = Parameter("weight", (input_dim, output_dim), dtype,
                                weight_initializer)

    def forward(self, x):
        return nn_ops.embedding(x, self.weight)


class _Norm(HybridBlock):
    """A normalisation layer with gamma and beta of the channel count;
    `center` / `scale` are accepted as in the JAX package, whose layers
    apply beta and gamma either way."""

    def __init__(self, epsilon, beta_initializer, gamma_initializer,
                 in_channels):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", (in_channels,), "float32",
                               gamma_initializer)
        self.beta = Parameter("beta", (in_channels,), "float32",
                              beta_initializer)

    def infer_param_shapes(self, x_shape):
        c = x_shape[self._channel_axis]
        return {"gamma": (c,), "beta": (c,)}


class LayerNorm(_Norm):
    """Normalization over `axis` (the last by default)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, beta_initializer, gamma_initializer,
                         in_channels)
        self._channel_axis = self._axis = axis

    def forward(self, x):
        self._resolve_deferred(x)
        if self._axis in (-1, x.dim() - 1):
            return nn_ops.layer_norm(x, self.gamma, self.beta,
                                     eps=self._epsilon)
        return super().forward(x)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class GroupNorm(_Norm):
    """Normalization over groups of the channels (axis 1)."""

    _channel_axis = 1

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, beta_initializer, gamma_initializer,
                         in_channels)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class InstanceNorm(_Norm):
    """Normalization of each instance's channel over its spatial axes."""

    _channel_axis = 1

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, beta_initializer, gamma_initializer,
                         in_channels)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


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

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act)


class LeakyReLU(HybridBlock):
    """x where x >= 0, else alpha * x (`nn_ops.leaky_relu`)."""

    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return nn_ops.leaky_relu(x, "leaky", self._alpha)


class PReLU(HybridBlock):
    """x where x >= 0, else alpha * x with a learned alpha per channel."""

    def __init__(self, alpha_initializer="zeros", in_channels=1):
        super().__init__()
        self.alpha = Parameter("alpha", (in_channels,), "float32",
                               alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class Flatten(HybridBlock):
    def forward(self, x):
        return nn_ops.flatten(x)

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Lambda(Block):
    """A Block around `function`, called on the block's inputs."""

    def __init__(self, function):
        super().__init__()
        self._fn = function

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(HybridBlock):
    """A HybridBlock around `function(F, *args)`, or around the op of
    that name when `function` is a string."""

    def __init__(self, function):
        super().__init__()
        self._fn = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._fn, str):
            return getattr(F, self._fn)(*args)
        return self._fn(F, *args)


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


class Conv2DTranspose(HybridBlock):
    """2-D transposed convolution (the registry's `Deconvolution`):
    weight (in_channels, channels / groups, *kernel), optional bias,
    `output_padding` added to the output's size."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCHW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros"):
        super().__init__()
        self._channels = channels
        self._groups = groups
        self._kw = dict(kernel=_tuple(kernel_size, 2),
                        stride=_tuple(strides, 2),
                        dilate=_tuple(dilation, 2), pad=_tuple(padding, 2),
                        adj=_tuple(output_padding, 2), num_filter=channels,
                        num_group=groups, no_bias=not use_bias)
        self._act = activation
        self.weight = Parameter(
            "weight", (in_channels, channels // groups) + self._kw["kernel"],
            "float32", weight_initializer)
        self.bias = Parameter("bias", (channels,), "float32",
                              bias_initializer) if use_bias else None

    def infer_param_shapes(self, x_shape):
        return {"weight": (x_shape[1], self._channels // self._groups)
                + self._kw["kernel"]}

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Deconvolution(x, weight, bias, **self._kw)
        return F.Activation(out, act_type=self._act) if self._act else out


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


class MaxPool3D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False):
        super().__init__(pool_size, strides, padding, 3, ceil_mode, "max")


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


class AvgPool3D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, 3, ceil_mode, "avg",
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
