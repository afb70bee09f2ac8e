"""Miscellaneous classic operators (counterpart of
`mxnet_tpu/ops/misc_ops.py`): the loss-layer ops (`BlockGrad`,
`MakeLoss`, the regression outputs, `SVMOutput`; reference
`src/operator/make_loss.cc`, `regression_output.cc`, `svm_output.cc`),
`smooth_l1`, `SoftmaxActivation`, `LRN`, the spatial-transform family
(`BilinearSampler`, `GridGenerator`, `SpatialTransformer`,
`Correlation`), the tensor utilities (`depth_to_space`, `batch_take`,
`ravel_multi_index`, `khatri_rao`, `_contrib_fft`, `Crop`, ...), the
creation ops `_arange`, `_eye`, `_linspace`, and CTC loss. `Custom`
waits for `mx.operator`.

The JAX ops are XLA, not Pallas, so these are ordinary torch. A loss
layer's backward is the JAX op's custom gradient (a
`torch.autograd.Function`): the incoming head gradient is ignored and
the loss's own gradient injected, not autograd of the forward.

CTC loss: the JAX op runs the log-space alpha recursion as a
`lax.scan`; here it is ATen's `ctc_loss` (its own CUDA kernels on the
card) over a float32 log-softmax, as the JAX op normalises. ATen reads
the lengths on the host, one copy a call.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from . import alias, register

__all__ = ["ctc_loss"]


def _dtype(dtype):
    from ..ndarray.ndarray import _torch_dtype
    return _torch_dtype(dtype)


def _device(ctx):
    from .. import context
    return context.resolve(ctx)


# -- gradient-control and loss-layer ops ------------------------------------

@register("BlockGrad")
def block_grad(data):
    """Identity forward, zero gradient."""
    return data.detach()


alias("stop_gradient", "BlockGrad")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the gradient is `grad_scale`, divided by the
    batch ("batch") or by the count of entries > valid_thresh ("valid"),
    with the head gradient ignored (reference `make_loss-inl.h`)."""

    @staticmethod
    def forward(ctx, data, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(data)
        ctx.args = (grad_scale, normalization, valid_thresh)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        grad_scale, normalization, valid_thresh = ctx.args
        grad = torch.full_like(data, grad_scale)
        if normalization == "batch":
            grad = grad / data.shape[0]
        elif normalization == "valid":
            grad = grad / (data > valid_thresh).sum().to(data.dtype) \
                .clamp_min(1.0)
        return grad, None, None, None


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return _MakeLoss.apply(data, float(grad_scale), str(normalization),
                           float(valid_thresh))


alias("make_loss", "MakeLoss")

_LINKS = {"linear": (lambda x: x, lambda o, lab: o - lab),
          "logistic": (torch.sigmoid, lambda o, lab: o - lab),
          "mae": (lambda x: x, lambda o, lab: torch.sign(o - lab))}


class _RegressionOutput(torch.autograd.Function):
    """link(data) forward; (dloss(out, label)) * grad_scale / (outputs
    per example) backward, the head gradient ignored (reference
    `regression_output-inl.h`)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = _LINKS[kind][0](data)
        ctx.save_for_backward(out, label)
        ctx.args = (kind, grad_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        kind, grad_scale = ctx.args
        n = max(int(np.prod(out.shape[1:])), 1)
        grad = _LINKS[kind][1](out, label.to(out.dtype)) * (grad_scale / n)
        return grad, None, None, None


def _regression_output(kind):
    def op(data, label=None, grad_scale=1.0):
        if label is None:
            return _LINKS[kind][0](data)
        return _RegressionOutput.apply(data, label, kind, float(grad_scale))
    return op


register("LinearRegressionOutput")(_regression_output("linear"))
register("LogisticRegressionOutput")(_regression_output("logistic"))
register("MAERegressionOutput")(_regression_output("mae"))


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the multi-class hinge gradient backward
    (reference `svm_output-inl.h`), the head gradient ignored."""

    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.args
        lab = label.to(torch.int64)
        f_l = torch.gather(data, -1, lab.unsqueeze(-1))
        viol = data - f_l + margin
        onehot = tF.one_hot(lab, data.shape[-1]).to(data.dtype)
        active = (viol > 0).to(data.dtype) * (1.0 - onehot)
        if use_linear:
            grad = active - onehot * active.sum(-1, keepdim=True)
        else:
            sv = 2.0 * viol * active
            grad = sv - onehot * sv.sum(-1, keepdim=True)
        return grad * reg_coef, None, None, None, None


@register("SVMOutput")
def svm_output(data, label=None, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    if label is None:
        return data
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """0.5 (s x)^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    absd = data.abs()
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    """mode "channel": softmax over axis 1; "instance": over all
    non-batch axes flattened."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels (NCHW): x / (k +
    alpha/n * sum over the channel window of x^2)^beta, the window sum a
    difference of a padded cumulative sum, as the JAX op computes it."""
    half = nsize // 2
    pad = tF.pad(data * data, (0, 0, 0, 0, half + 1, half))
    csum = torch.cumsum(pad, dim=1)
    window = csum[:, nsize:] - csum[:, :-nsize]
    return data / (knorm + (alpha / nsize) * window) ** beta


# -- spatial-transform family ------------------------------------------------

def _bilinear_sample(data, gx, gy):
    """Sample NCHW `data` at normalized coordinates gx, gy in [-1, 1]
    ((B, Ho, Wo) each), bilinear, zero outside."""
    B, C, H, W = data.shape
    x = (gx + 1.0) * (W - 1) / 2.0
    y = (gy + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = data.reshape(B, C, H * W)

    def gather(yi, xi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        idx = (yc * W + xc).reshape(B, 1, -1).expand(B, C, -1)
        vals = torch.gather(flat, 2, idx).reshape(B, C, *xi.shape[1:])
        return vals * inb[:, None].to(data.dtype)

    return (gather(y0, x0) * ((1 - wx) * (1 - wy))[:, None]
            + gather(y0, x0 + 1) * (wx * (1 - wy))[:, None]
            + gather(y0 + 1, x0) * ((1 - wx) * wy)[:, None]
            + gather(y0 + 1, x0 + 1) * (wx * wy)[:, None])


@register("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=False):
    """data (B, C, H, W) sampled at grid (B, 2, Ho, Wo): grid[:, 0] x,
    grid[:, 1] y, in [-1, 1]; zero padding outside."""
    return _bilinear_sample(data, grid[:, 0], grid[:, 1])


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: data (B, 6), row-major 2x3 matrices -> grid (B, 2, H, W)
    over the target shape; warp: data (B, 2, H, W) pixel flow -> the
    normalized sampling grid of identity + flow."""
    dev = data.device
    if transform_type == "affine":
        H, W = int(target_shape[0]), int(target_shape[1])
        theta = data.reshape(-1, 2, 3).float()
        gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, H, device=dev),
                                torch.linspace(-1.0, 1.0, W, device=dev),
                                indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones(H * W, device=dev)])
        return torch.einsum("bij,jk->bik", theta, coords).reshape(-1, 2, H, W)
    B, _, H, W = data.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    x = (gx[None] + data[:, 0]) * 2.0 / max(W - 1, 1) - 1.0
    y = (gy[None] + data[:, 1]) * 2.0 / max(H - 1, 1) - 1.0
    return torch.stack([x, y], dim=1)


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """An affine grid from `loc` (B, 6), then bilinear sampling of data."""
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


@register("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation (reference `src/operator/correlation.cc`): for
    each displacement on a stride2 grid within max_displacement, the
    channel mean of data1 * shifted(data2) (-|a - b| when not
    is_multiply), averaged over a kernel_size patch; the padded grid is
    cropped by max_displacement + the kernel radius on every side, then
    strided by stride1."""
    p = pad_size
    a = tF.pad(data1, (p, p, p, p))
    b = tF.pad(data2, (p, p, p, p))
    d = max_displacement // stride2
    k = kernel_size // 2
    Hp, Wp = a.shape[2], a.shape[3]
    border = max_displacement + k
    rows = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            oy, ox = dy * stride2, dx * stride2
            shifted = torch.roll(b, (-oy, -ox), dims=(2, 3))
            valid_y = torch.zeros(Hp, dtype=torch.bool, device=a.device)
            valid_y[max(0, -oy):Hp - max(0, oy)] = True
            valid_x = torch.zeros(Wp, dtype=torch.bool, device=a.device)
            valid_x[max(0, -ox):Wp - max(0, ox)] = True
            mask = (valid_y[:, None] & valid_x[None, :]).to(a.dtype)
            prod = a * shifted if is_multiply else -(a - shifted).abs()
            corr = prod.mean(dim=1) * mask
            if kernel_size > 1:
                n = kernel_size
                cs = torch.cumsum(torch.cumsum(tF.pad(corr, (k, k, k, k)),
                                               dim=1), dim=2)
                cs = tF.pad(cs, (1, 0, 1, 0))
                corr = (cs[:, n:, n:] - cs[:, :-n, n:] - cs[:, n:, :-n]
                        + cs[:, :-n, :-n]) / (n * n)
            crop = corr[:, border:Hp - border, border:Wp - border]
            rows.append(crop[:, ::stride1, ::stride1])
    return torch.stack(rows, dim=1)


# -- tensor utilities ----------------------------------------------------------

@register("depth_to_space")
def depth_to_space(data, block_size):
    """NCHW depth to space (DCR order)."""
    B, C, H, W = data.shape
    bs = block_size
    x = data.reshape(B, bs, bs, C // (bs * bs), H, W)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(B, C // (bs * bs), H * bs,
                                               W * bs)


@register("space_to_depth")
def space_to_depth(data, block_size):
    B, C, H, W = data.shape
    bs = block_size
    x = data.reshape(B, C, H // bs, bs, W // bs, bs)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(B, C * bs * bs, H // bs,
                                               W // bs)


@register("batch_take")
def batch_take(a, indices):
    """out[i] = a[i, indices[i]]."""
    return torch.gather(a, 1, indices.long()[:, None])[:, 0]


@register("ravel_multi_index")
def ravel_multi_index(data, shape=None):
    """(ndim, N) coordinates -> (N,) flat indices, in data's dtype."""
    strides = np.cumprod([1] + list(shape[::-1][:-1]))[::-1].copy()
    return (data.to(torch.int32) * torch.as_tensor(
        strides, dtype=torch.int32, device=data.device)[:, None]).sum(0) \
        .to(data.dtype)


@register("unravel_index")
def unravel_index(data, shape=None):
    """(N,) flat indices -> (ndim, N) coordinates, in data's dtype."""
    idx = data.to(torch.int32)
    out = []
    for dim in reversed(shape):
        out.append(idx % dim)
        idx = torch.div(idx, dim, rounding_mode="floor")
    return torch.stack(out[::-1]).to(data.dtype)


@register("khatri_rao")
def khatri_rao(*mats):
    """Column-wise Kronecker product."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


@register("_arange")
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            infer_range=False, ctx=None):
    if stop is None:
        start, stop = 0.0, start
    vals = torch.arange(start, stop, step, dtype=_dtype(dtype),
                        device=_device(ctx))
    return vals.repeat_interleave(repeat) if repeat != 1 else vals


@register("_linspace")
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              ctx=None):
    num, dev = int(num), _device(ctx)
    if endpoint:
        vals = torch.linspace(start, stop, num, dtype=torch.float64,
                              device=dev)
    else:
        vals = torch.linspace(start, stop, num + 1, dtype=torch.float64,
                              device=dev)[:num]
    return vals.to(_dtype(dtype))


@register("_eye")
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None):
    N, M, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(N, device=_device(ctx))[:, None]
    cols = torch.arange(M, device=rows.device)[None, :]
    return (cols - rows == k).to(_dtype(dtype))


@register("_contrib_fft")
def fft(data, compute_size=128):
    """Real (..., d) -> interleaved re/im (..., 2d)."""
    f = torch.fft.fft(data.float(), dim=-1)
    return torch.stack([f.real, f.imag], dim=-1).reshape(
        *data.shape[:-1], -1)


@register("_contrib_ifft")
def ifft(data, compute_size=128):
    """Interleaved (..., 2d) -> real (..., d), scaled by 1/d as numpy's
    ifft."""
    z = torch.complex(data[..., 0::2].float(), data[..., 1::2].float())
    return torch.fft.ifft(z, dim=-1).real.to(data.dtype)


@register("Crop")
def crop(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
         num_args=None):
    """Legacy NCHW crop: with two inputs, to the second's spatial size;
    with one, to `h_w`. Offset is (y, x); center_crop overrides it."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = h_w
        if th <= 0 or tw <= 0:
            raise ValueError(
                "Crop: with a single input, h_w must give a positive "
                f"window, got {h_w}")
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = offset
    if not (0 <= y0 and y0 + th <= H and 0 <= x0 and x0 + tw <= W):
        raise ValueError(
            f"Crop: window ({th},{tw}) at offset ({y0},{x0}) does not fit "
            f"input spatial dims ({H},{W})")
    return data[:, :, y0:y0 + th, x0:x0 + tw]


# -- CTC loss --------------------------------------------------------------------

# the JAX op's stand-in for -inf is -1e30, so a label that no alignment
# can emit within the frames costs 1e30 there, not inf
INFEASIBLE = 1e30


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist Temporal Classification loss: (N,) negative
    log-likelihoods of `label` (N, L) under `data` (T, N, C), unnormalised
    activations (softmax applied here).

    blank_label 'first': blank 0, real labels 1..C-1, padding 0; 'last':
    blank C-1, padding -1. Label lengths are `label_lengths` with
    `use_label_lengths`, else the labels that are not padding; data
    lengths are `data_lengths` with `use_data_lengths`, else T.

    A label that needs more frames than its data has (its length plus
    its repeats) costs 1e30, the JAX op's value. Its gradient is 0 here
    (ATen's `zero_infinity`); the JAX op differentiates through its
    -1e30 stand-in, which gives a finite gradient that means nothing."""
    T, N, C = data.shape
    logp = torch.log_softmax(data.float(), -1)
    label = label.to(device=data.device, dtype=torch.int64)
    blank = 0 if blank_label == "first" else C - 1
    pad = 0 if blank_label == "first" else -1
    if use_label_lengths and label_lengths is not None:
        llen = label_lengths.to(device=data.device, dtype=torch.int64)
    else:
        llen = (label != pad).sum(1)
    if use_data_lengths and data_lengths is not None:
        dlen = data_lengths.to(device=data.device, dtype=torch.int64)
    else:
        dlen = torch.full((N,), T, dtype=torch.int64, device=data.device)
    loss = tF.ctc_loss(logp, label, dlen, llen, blank=blank,
                       reduction="none", zero_infinity=True)
    inner = torch.arange(1, label.shape[1], device=data.device) < llen[:, None]
    repeats = ((label[:, 1:] == label[:, :-1]) & inner).sum(1)
    return torch.where(llen + repeats > dlen, INFEASIBLE, loss)
