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

import numpy as np
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


def leaky_relu(data, act_type="leaky", slope=0.25, gamma=None,
               lower_bound=0.125, upper_bound=0.334):
    """`LeakyReLU(data, act_type, slope, gamma, lower_bound, upper_bound)`
    with every act type of the JAX op: "leaky" (x where x >= 0, else
    slope * x, the slope rounded to the data's dtype first, as
    `jax.nn.leaky_relu` applies it; its gradient at 0 is 1, as the
    `where` gives, where torch's leaky_relu gives the slope), "prelu"
    (the per-channel slopes `gamma` on axis 1), "elu" (slope the alpha),
    "selu", "gelu" (the tanh approximation) and "rrelu" (the evaluation
    slope, the mean of the bounds, as the JAX op applies it)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data,
                           data * weak_scalar(slope, data.dtype))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)).to(data.dtype)
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data,
                           weak_scalar(slope, data.dtype) * torch.expm1(data))
    if act_type == "selu":
        return torch.selu(data)
    if act_type == "gelu":
        return gelu(data)
    if act_type == "rrelu":
        return leaky_relu(data, "leaky", (lower_bound + upper_bound) / 2.0)
    raise ValueError(f"LeakyReLU: act_type {act_type!r}")


@functools.lru_cache(maxsize=64)
def weak_scalar(value, dtype):
    """The Python scalar `value` as jnp applies it to an array of
    `dtype`: rounded to that dtype first (a weak type)."""
    return torch.tensor(value, dtype=dtype).item()


def dropout(data, p=0.5, training=False, axes=()):
    """Inverted dropout: identity outside training or when p <= 0; else
    each element is kept with probability 1-p and divided by 1-p rounded
    to the data's dtype (the JAX package's `data / keep`). `axes` share
    one draw along each named axis (MXNet's variational dropout). The
    mask draws from the device stream of `mxnet_tpu_torch.random`."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    mask = torch.rand(shape, generator=_random.generator(data.device),
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


# ---------------------------------------------------------------------------
# the registry: the JAX module's 29 registrations under their MXNet names
# and parameters, thin adapters over the functions above
# ---------------------------------------------------------------------------

from . import register, alias  # noqa: E402


def _train_flag(flag):
    """An op's `_training`: None reads the autograd scope's flag."""
    return _autograd.is_training() if flag is None else bool(flag)


@register("FullyConnected")
def FullyConnected(data, weight, bias=None, num_hidden=None,  # noqa: N802
                   no_bias=False, flatten=True):
    return fully_connected(data, weight, None if no_bias else bias, flatten)


@register("Convolution")
def Convolution(data, weight, bias=None, kernel=None, stride=None,  # noqa
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    return convolution(data, weight, bias, kernel, stride, dilate, pad,
                       num_filter, num_group, no_bias)


@register("Deconvolution")
def Deconvolution(data, weight, bias=None, kernel=None, stride=None,  # noqa
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, target_shape=None,
                  layout=None):
    """Transposed convolution with MXNet's (in, out / group, ...) weight,
    which is torch's layout; `adj` is the output padding. `target_shape`
    is ignored, as in the JAX op."""
    n = data.dim() - 2
    fn = (tF.conv_transpose1d, tF.conv_transpose2d,
          tF.conv_transpose3d)[n - 1]
    if data.dtype != weight.dtype:
        data = data.to(weight.dtype)
    out = fn(data, weight, None, stride=_tuple(stride, n, 1),
             padding=_tuple(pad, n, 0), output_padding=_tuple(adj, n, 0),
             groups=num_group, dilation=_tuple(dilate, n, 1))
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out


@register("Pooling")
def Pooling(data, kernel=None, pool_type="max", global_pool=False,  # noqa
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None, p_value=2):
    """`pooling` and, as in the JAX op, "sum" (the window's sum) and "lp"
    ((sum |x|^p)^(1/p) over each window, in float32)."""
    if pool_type in ("max", "avg"):
        return pooling(data, kernel, pool_type, global_pool, stride, pad,
                       pooling_convention, count_include_pad)
    n = data.dim() - 2
    x = data
    if pool_type == "lp":
        x = torch.abs(data.float()) ** float(p_value)
    elif pool_type != "sum":
        raise ValueError(f"pooling: pool_type {pool_type!r}")
    if global_pool:
        summed = x.sum(dim=tuple(range(2, data.dim())), keepdim=True)
    else:
        k = _tuple(kernel, n, 1)
        summed = pooling(x, k, "avg", False, stride, pad,
                         pooling_convention, True) * float(np.prod(k))
    if pool_type == "sum":
        return summed
    return (summed ** (1.0 / float(p_value))).to(data.dtype)


@register("Activation")
def Activation(data, act_type="relu"):  # noqa: N802
    return activation(data, act_type)


@register("LeakyReLU")
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,  # noqa: N802
              lower_bound=0.125, upper_bound=0.334):
    return leaky_relu(data, act_type, slope, gamma, lower_bound, upper_bound)


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    x = data / temperature if temperature else data
    if length is not None:
        ar = torch.arange(x.shape[axis], device=x.device)
        mask = ar < length.to(torch.int32).unsqueeze(-1)
        mask = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))
        x = torch.where(mask, x, float("-inf"))
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register("softmin")
def softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


class _SoftmaxOutput(torch.autograd.Function):
    """softmax(data) forward; the loss layer's gradient backward
    (reference `src/operator/softmax_output.cc`): (softmax - onehot) of
    the label, masked where the label is `ignore_label` (`use_ignore`),
    divided by the valid count ("valid") or the label's size ("valid"
    without `use_ignore`) or the batch ("batch"), times `grad_scale`. The
    incoming head gradient is ignored, as in the reference."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.args = (grad_scale, ignore_label, use_ignore, normalization)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.args
        lab = label.to(torch.int64)
        # one_hot as jax.nn.one_hot: a row of zeros for a label out of range
        onehot = (lab.unsqueeze(-1) == torch.arange(
            out.shape[-1], device=out.device)).to(out.dtype)
        grad = out - onehot
        if use_ignore:
            mask = (lab != ignore_label).to(out.dtype)
            grad = grad * mask.unsqueeze(-1)
            if normalization == "valid":
                grad = grad / torch.clamp(mask.sum(), min=1.0)
        elif normalization == "valid":
            grad = grad / float(np.prod(label.shape))
        if normalization == "batch":
            grad = grad / out.shape[0]
        return grad * grad_scale, None, None, None, None, None


@register("SoftmaxOutput")
def SoftmaxOutput(data, label=None, grad_scale=1.0, ignore_label=-1,  # noqa
                  multi_output=False, use_ignore=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0,
                  preserve_shape=False):
    if out_grad or multi_output or smooth_alpha:
        raise NotImplementedError(
            "SoftmaxOutput: out_grad/multi_output/smooth_alpha are not "
            "supported; silently ignoring them would corrupt gradients")
    if label is None:
        return torch.softmax(data, dim=-1)
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                int(ignore_label), bool(use_ignore),
                                str(normalization))


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1, label.to(torch.int64).unsqueeze(-1)).sum()


@register("Embedding")
def Embedding(data, weight, input_dim=None, output_dim=None,  # noqa: N802
              dtype=None, sparse_grad=False):
    return embedding(data, weight)


alias("embedding", "Embedding")


@register("im2col")
def im2col(data, kernel, stride=None, dilate=None, pad=None):
    """Patch extraction: NCHW (or NCW) input -> (N, C * prod(kernel), L)
    columns, rows channel-major then row-major kernel position (the
    GEMM-convolution layout)."""
    kernel = tuple(kernel)
    if len(kernel) > 2:
        raise NotImplementedError("im2col: 3-D patches are not in the port "
                                  "(ROADMAP.md queue 1, \"The eager MXNet "
                                  "surface\")")
    one = len(kernel) == 1
    x = data.unsqueeze(2) if one else data

    def arg(v, fill):
        v = tuple(v) if v else (fill,) * len(kernel)
        return ((fill,) + v) if one else v

    return tF.unfold(x, arg(kernel, 1), dilation=arg(dilate, 1),
                     padding=arg(pad, 0), stride=arg(stride, 1))


@register("col2im")
def col2im(data, output_size, kernel, stride=None, dilate=None, pad=None):
    """Columns summed back into an image (the vjp of im2col:
    overlapping patch positions add)."""
    kernel = tuple(kernel)
    n = len(kernel)
    return tF.fold(data, tuple(output_size), kernel,
                   dilation=tuple(dilate) if dilate else (1,) * n,
                   padding=tuple(pad) if pad else (0,) * n,
                   stride=tuple(stride) if stride else (1,) * n)


@register("Dropout")
def Dropout(data, p=0.5, mode="training", axes=(), _training=None):  # noqa
    """`dropout` in training, or always with mode "always"."""
    return dropout(data, p, _train_flag(_training) or mode == "always", axes)


@register("BatchNorm")
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,  # noqa
              momentum=0.9, fix_gamma=False, use_global_stats=False,
              output_mean_var=False, axis=1, _training=None):
    """(out, new_moving_mean, new_moving_var), as the JAX op returns them;
    the executor writes the new statistics back in training."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                      momentum, fix_gamma, use_global_stats, axis,
                      _train_flag(_training))


@register("LayerNorm")
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5,  # noqa: N802
              output_mean_var=False):
    """Normalised over `axis` with float32 statistics; the normalised
    value is cast to the data's dtype before gamma and beta, which
    broadcast against the trailing axis, as in the JAX op."""
    if not output_mean_var and axis in (-1, data.dim() - 1):
        return layer_norm(data, gamma, beta, eps)
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, keepdim=True, unbiased=False)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).to(data.dtype) \
        * gamma.to(data.dtype) + beta.to(data.dtype)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


@register("GroupNorm")
def GroupNorm(data, gamma, beta, num_groups=1, eps=1e-5):  # noqa: N802
    N, C = data.shape[0], data.shape[1]
    rest = tuple(data.shape[2:])
    x = data.reshape((N, num_groups, C // num_groups) + rest).float()
    axes = tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape) \
        .to(data.dtype)
    bshape = (1, C) + (1,) * len(rest)
    return x * gamma.reshape(bshape).to(data.dtype) \
        + beta.reshape(bshape).to(data.dtype)


@register("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3):  # noqa: N802
    axes = tuple(range(2, data.dim()))
    mean = data.mean(dim=axes, keepdim=True)
    var = data.var(dim=axes, keepdim=True, unbiased=False)
    x = (data - mean) * torch.rsqrt(var + eps)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(bshape).to(data.dtype) \
        + beta.reshape(bshape).to(data.dtype)


@register("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):  # noqa: N802
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    return data / torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                       keepdim=True) + eps)


@register("BilinearResize2D")
def BilinearResize2D(data, height=None, width=None,  # noqa: N802
                     scale_height=None, scale_width=None):
    """Linear resampling with half-pixel centres, antialiased when it
    shrinks, as `jax.image.resize(..., "linear")`."""
    N, C, H, W = data.shape
    out_h = height or int(H * scale_height)
    out_w = width or int(W * scale_width)
    return tF.interpolate(data, size=(out_h, out_w), mode="bilinear",
                          align_corners=False, antialias=True)


@register("UpSampling")
def UpSampling(data, scale=2, sample_type="nearest", num_args=1):  # noqa
    N, C, H, W = data.shape
    if sample_type == "nearest":
        return tF.interpolate(data, size=(H * scale, W * scale),
                              mode="nearest")
    return BilinearResize2D(data, H * scale, W * scale)


@register("_contrib_interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """(L, B, 3E) interleaved per head -> (B * heads, L, L) scores."""
    L, B, E3 = queries_keys_values.shape
    proj = E3 // 3 // heads
    x = queries_keys_values.reshape(L, B, heads, 3, proj)
    q = x[:, :, :, 0].permute(1, 2, 0, 3).reshape(B * heads, L, proj)
    k = x[:, :, :, 1].permute(1, 2, 0, 3).reshape(B * heads, L, proj)
    scale = torch.tensor(float(proj), dtype=torch.float32).sqrt().item()
    return torch.matmul(q, k.transpose(-1, -2)) / weak_scalar(scale, q.dtype)


@register("_contrib_interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads):
    L, B, E3 = queries_keys_values.shape
    proj = E3 // 3 // heads
    x = queries_keys_values.reshape(L, B, heads, 3, proj)
    v = x[:, :, :, 2].permute(1, 2, 0, 3).reshape(B * heads, L, proj)
    out = torch.matmul(attention, v)
    return out.reshape(B, heads, L, proj).permute(2, 0, 1, 3) \
        .reshape(L, B, heads * proj)


@register("flash_attention")
def flash_attention_op(q, k, v, mask=None, causal=False, sm_scale=None,
                       dropout=0.0, _training=None):
    """Attention on (B, H, L, D) through the flash kernels; mask (B, Lk)
    True where attendable; `dropout` applies in training."""
    return flash_attention(q, k, v, mask, causal, sm_scale, dropout,
                           _train_flag(_training))


@register("fused_self_attention")
def fused_self_attention_op(qkv, mask=None, num_heads=1, causal=False,
                            dropout=0.0, seq_parallel=False,
                            _training=None):
    """Self-attention from a fused QKV projection (B, L, 3E) -> (B, L, E)
    through the flash kernels. The port has one device and no "sp" mesh
    axis, so `seq_parallel` changes nothing, as in the JAX op on a mesh
    whose sp is 1."""
    return fused_self_attention(qkv, mask, num_heads, causal, dropout,
                                _train_flag(_training))


def _quantize_act(data, act_scale):
    """(float32 data, calibrated scale or <= 0) -> (int8 data, float32
    scale), the JAX op's one activation quantizer."""
    if act_scale and float(act_scale) > 0:
        s_x = torch.tensor(float(act_scale), dtype=torch.float32,
                           device=data.device)
    else:
        s_x = torch.clamp(data.abs().amax(), min=1e-8) / 127.0
    return torch.clamp(torch.round(data / s_x), -127, 127) \
        .to(torch.int8), s_x


@register("_contrib_quantized_dense")
def quantized_dense(data, weight_q, weight_scale, bias=None, act_scale=-1.0,
                    num_hidden=0, flatten=False, relu=False):
    """int8 dense: the activation quantized on the fly (the calibrated
    `act_scale`, else the batch's max), the (O, K) int8 weight through
    the int8 GEMM kernel (`cuda_ops.int8_matmul`, whose K-major operand
    is the weight itself), the per-channel rescale, bias and relu fused;
    float32 out."""
    from ..cuda_ops.int8_matmul import int8_matmul
    data = data.float()
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    x_q, s_x = _quantize_act(data, act_scale)
    w = weight_q.to(torch.int8)
    return int8_matmul(x_q.contiguous(), w.t().contiguous(), s_x,
                       weight_scale, bias=bias, relu=relu,
                       w_q_k=w.contiguous())


@register("_contrib_quantized_conv2d")
def quantized_conv2d(data, weight_q, weight_scale, bias=None,
                     act_scale=-1.0, stride=None, pad=None, dilate=None,
                     num_group=1, relu=False):
    """The JAX op is an int8 convolution with int32 accumulation; the
    port has no int8 convolution yet."""
    from ..ndarray.ndarray import NotPortedError
    raise NotPortedError(
        "_contrib_quantized_conv2d (an int8 convolution) is not in the "
        "port yet (ROADMAP.md queue 1, \"What the GPT-2 lifecycle left "
        "out\": QuantizedConv2D)")
