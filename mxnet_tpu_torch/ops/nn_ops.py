"""The neural-network ops of the port (counterpart of
`mxnet_tpu/ops/nn_ops.py`).

Plain PyTorch on tensors, with the JAX package's numerics where they
are a choice: `fully_connected` promotes as `jnp.matmul` does (a float32
input with a bfloat16 weight gives float32; one dtype stays one GEMM
with the bias fused); LayerNorm statistics in float32 with the
normalized value cast back to the input dtype BEFORE gamma/beta; gelu is
the tanh approximation (`jax.nn.gelu`'s default); dropout is inverted
(kept values divided by 1-p rounded to the data's dtype, as jnp applies
a Python scalar) and draws from the device stream of
`mxnet_tpu_torch.random`. Attention goes through the hand-written flash
kernels (`cuda_ops.flash_attention`), whose attention dropout is keyed
by a seed from the host stream: `fused_self_attention` from a fused QKV
projection, `flash_attention` (the counterpart of `F.flash_attention`)
from q, k and v.

Convolution, pooling and BatchNorm are XLA's in the JAX package (no
Pallas kernel), so here they are PyTorch's (cuDNN on the card) with the
JAX package's conventions: NCHW / OIHW tensors, MXNet's kernel, stride,
dilate, pad and num_group, pooling windows padded by -inf (max) or 0
(avg, with `count_include_pad`), "full" (ceil) pooling extending the
upper pad, and BatchNorm's running update
new = momentum * old + (1 - momentum) * batch with the biased batch
variance. On the card a 4-D convolution's input is laid out
channels-last in memory (`conv_memory_format`): the tensors stay NCHW,
and the layout follows the activations from layer to layer.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as tF

from .. import autograd as _autograd
from .. import random as _random
from ..cuda_ops import flash_attention as _fa

__all__ = ["fully_connected", "gelu", "activation", "leaky_relu",
           "dropout", "weak_scalar",
           "embedding", "layer_norm", "split_heads", "fused_self_attention",
           "flash_attention", "convolution", "pooling", "batch_norm",
           "flatten"]

# the memory format of a 4-D convolution's input on the card
conv_memory_format = torch.channels_last


def fully_connected(data, weight, bias=None, flatten=True):
    """x @ weight.T + bias in the promoted dtype of x and weight, then of
    that and the bias (`jnp.matmul` and `+`'s promotion)."""
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    if bias is None or bias.dtype == x.dtype:
        return tF.linear(x, weight, bias)
    return tF.linear(x, weight) + bias


def gelu(data):
    return tF.gelu(data, approximate="tanh")


def softrelu(data):
    """log(1 + e^x) as `jax.nn.softplus` computes it (`logaddexp(x, 0)`),
    not torch's softplus, which turns linear above a threshold."""
    return torch.logaddexp(data, data.new_zeros(()))


_ACTIVATIONS = {"relu": torch.relu, "relu6": tF.relu6,
                "sigmoid": torch.sigmoid, "tanh": torch.tanh,
                "softrelu": softrelu, "softsign": tF.softsign, "gelu": gelu,
                "silu": tF.silu}


def activation(data, act_type):
    """`Activation(data, act_type)`: every act type of the JAX op."""
    if act_type not in _ACTIVATIONS:
        raise NotImplementedError(
            f"activation {act_type!r} is not in the port (have "
            f"{sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[act_type](data)


def leaky_relu(data, act_type="leaky", slope=0.25):
    """`LeakyReLU(data, act_type="leaky", slope)`: x where x >= 0, else
    slope * x with the slope rounded to the data's dtype first, as
    `jax.nn.leaky_relu` applies it (its gradient at 0 is 1, as the
    `where` gives; torch's leaky_relu gives the slope there). The other
    act types of the JAX op are not in the port."""
    if act_type != "leaky":
        raise NotImplementedError(
            f"LeakyReLU act_type {act_type!r} is not in the port (ROADMAP.md "
            "queue 1, \"The rest of gluon.nn and gluon.loss\")")
    return torch.where(data >= 0, data, data * weak_scalar(slope, data.dtype))


@functools.lru_cache(maxsize=64)
def weak_scalar(value, dtype):
    """The Python scalar `value` as jnp applies it to an array of
    `dtype`: rounded to that dtype first (a weak type)."""
    return torch.tensor(value, dtype=dtype).item()


def dropout(data, p=0.5, training=False):
    """Inverted dropout: identity outside training or when p <= 0; else
    each element is kept with probability 1-p and divided by 1-p rounded
    to the data's dtype (the JAX package's `data / keep`). The mask draws
    from the device stream of `mxnet_tpu_torch.random`."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=_random.generator(data.device),
                      device=data.device) < keep
    return torch.where(mask, data / weak_scalar(keep, data.dtype),
                       0.0).to(data.dtype)


def embedding(data, weight):
    return tF.embedding(data.long(), weight)


def layer_norm(data, gamma, beta, eps=1e-5):
    """Normalize over the last axis. torch computes the statistics in
    float32 for every input dtype and rounds the normalized value to the
    input dtype; gamma/beta (float32 masters) are applied after, in the
    input dtype, as the JAX package does."""
    out = tF.layer_norm(data, data.shape[-1:], eps=eps)
    return torch.addcmul(beta.to(data.dtype), out, gamma.to(data.dtype))


def split_heads(qkv, num_heads):
    """(B, L, 3E) fused projection -> contiguous q, k, v (B, H, L, D),
    in one copy."""
    B, L, E3 = qkv.shape
    return qkv.reshape(B, L, 3, num_heads, E3 // 3 // num_heads) \
        .permute(2, 0, 3, 1, 4).contiguous().unbind(0)


def fused_self_attention(qkv, mask=None, num_heads=1, causal=False,
                         dropout=0.0, training=False):
    """Self-attention from a fused QKV projection (B, L, 3E) -> (B, L, E)
    through the flash kernels. `dropout` is attention-probability dropout,
    active only in training: each call draws a fresh 64-bit seed from the
    host stream (no sync with the card). Sequence parallelism is not in
    the port."""
    B, L, E3 = qkv.shape
    H = num_heads
    D = E3 // 3 // H
    q, k, v = split_heads(qkv, H)
    seed = _random.next_seed() if (training and dropout > 0.0) else None
    out = _fa.flash_attention(q, k, v, mask=mask, causal=causal,
                              dropout=dropout, seed=seed)
    return out.transpose(1, 2).reshape(B, L, H * D)


def flash_attention(q, k, v, mask=None, causal=False, sm_scale=None,
                    dropout=0.0, training=None):
    """Attention on (B, H, L, D) q, k, v through the flash kernels; mask
    (B, Lk) True where attendable. `dropout` is attention-probability
    dropout, active in training (`training` None: the autograd scope's
    flag, as the JAX op reads it). The kernels take contiguous operands:
    a transposed head view pays one copy here."""
    if training is None:
        training = _autograd.is_training()
    seed = _random.next_seed() if (training and dropout > 0.0) else None
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), mask=mask, causal=causal,
                               sm_scale=sm_scale, dropout=dropout, seed=seed)


def flatten(data):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def _tuple(v, n, default):
    if v is None:
        v = default
    return (v,) * n if isinstance(v, int) else tuple(v)


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False):
    """N-D convolution (N = 1, 2, 3) of NC... data with an (O, I/group,
    ...) weight. The data is cast to the weight's dtype first, as the
    JAX package does; a bias of another dtype is added after, with
    torch's promotion (the JAX package adds it after too)."""
    n = data.dim() - 2
    if data.dtype != weight.dtype:
        data = data.to(weight.dtype)
    if n == 2 and data.is_cuda:
        data = data.contiguous(memory_format=conv_memory_format)
    conv = (tF.conv1d, tF.conv2d, tF.conv3d)[n - 1]
    b = None if no_bias else bias
    fused = b is not None and b.dtype == data.dtype
    out = conv(data, weight, b if fused else None,
               stride=_tuple(stride, n, 1), padding=_tuple(pad, n, 0),
               dilation=_tuple(dilate, n, 1), groups=num_group)
    if b is not None and not fused:
        out = out + b.reshape((1, -1) + (1,) * n)
    return out


def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True):
    """Max or average pooling over the trailing N axes of NC... data (N =
    1, 2, 3). `global_pool` pools each whole feature map. "valid" floors
    the output size; "full" (ceil) extends each upper pad until the last
    partial window counts, as the JAX package does. Max pads with -inf;
    avg pads with 0 and divides by the window (`count_include_pad`) or
    by the elements the window covers."""
    n = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=dims, keepdim=True)
        raise ValueError(f"pooling: pool_type {pool_type!r}")
    kernel = _tuple(kernel, n, 1)
    stride = _tuple(stride, n, kernel)
    pad = _tuple(pad, n, 0)
    upper = list(pad)
    if pooling_convention == "full":
        for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
            size = data.shape[2 + i]
            out = -(-(size + 2 * p - k) // s) + 1
            upper[i] = max((out - 1) * s + k - size - p, p)
    if pool_type == "max":
        fn = (tF.max_pool1d, tF.max_pool2d, tF.max_pool3d)[n - 1]
        if tuple(upper) == pad and all(2 * p <= k
                                       for p, k in zip(pad, kernel)):
            # torch pads a max window with -inf itself
            return fn(data, kernel, stride, pad)
        return fn(_pad(data, pad, upper, float("-inf")), kernel, stride)
    if pool_type != "avg":
        raise ValueError(f"pooling: pool_type {pool_type!r}")
    fn = (tF.avg_pool1d, tF.avg_pool2d, tF.avg_pool3d)[n - 1]
    summed = fn(_pad(data, pad, upper, 0.0), kernel, stride)
    if count_include_pad:
        return summed
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    covered = fn(_pad(ones, pad, upper, 0.0), kernel, stride)
    return summed / covered


def _pad(data, lower, upper, value):
    """Constant-pad the trailing axes by (lower, upper) each."""
    spec = []
    for lo, hi in zip(reversed(lower), reversed(upper)):
        spec += [lo, hi]
    if not any(spec):
        return data
    return tF.pad(data, spec, value=value)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1, training=False):
    """BatchNorm over every axis but `axis`. Returns (out, new_mean,
    new_var), the running statistics in their own dtype.

    In training (and without `use_global_stats`) the batch's mean and
    biased variance normalise the data, and the running statistics move
    to momentum * old + (1 - momentum) * batch (MXNet's momentum, which
    weights the old value); otherwise the running statistics normalise
    and come back unchanged. `fix_gamma` replaces gamma by ones. gamma
    and beta are cast to the data's dtype. The normalisation is torch's
    (cuDNN's or its own kernel on the card), with float32 statistics
    whatever the data's dtype; the batch variance comes from its
    inverse standard deviation."""
    x = data if axis in (1, 1 - data.dim()) else data.movedim(axis, 1)
    w = None if fix_gamma else gamma.to(x.dtype)
    b = beta.to(x.dtype)
    if training and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, w, b, None, None, True, 0.0, eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(eps)
            new_mean = moving_mean.float().mul(momentum).add_(
                mean, alpha=1 - momentum).to(moving_mean.dtype)
            new_var = moving_var.float().mul(momentum).add_(
                var, alpha=1 - momentum).to(moving_var.dtype)
    else:
        out = torch.native_batch_norm(
            x, w, b, moving_mean.to(x.dtype), moving_var.to(x.dtype),
            False, 0.0, eps)[0]
        new_mean, new_var = moving_mean, moving_var
    if x is not data:
        out = out.movedim(1, axis)
    return out, new_mean, new_var
