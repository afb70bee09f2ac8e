"""Optimizer update ops by MXNet name (counterpart of
`mxnet_tpu/ops/optimizer_ops.py`; reference: `src/operator/optimizer_op.cc`).

Each op is a function that returns the new weight (and the new state
tensors) and leaves its inputs alone, as the JAX package's are; `nd.<op>`
with `out=` gives MXNet's in-place form. The JAX package computes them
with XLA, not Pallas, so here they are plain torch on either device, with
one exception: `adam_update` and `adamw_update` on CUDA tensors run the
Adam kernel (`cuda_ops.fused_update.adam_update`, one counted launch) on
copies of the weight and moments, the route the port's `Adam` takes.
The optimizer classes (`optimizer`) call these by name; LAMB's class
runs its step on the LAMB kernels instead (`optimizer.LAMB`), since
`lamb_update_phase1` returns the update vector, which the LAMB pass-1
kernel does not write.
"""
from __future__ import annotations

import torch

from ..cuda_ops import fused_update
from . import register


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g + wd * weight.float()


def _clip(clip_gradient):
    return clip_gradient if clip_gradient > 0 else None


@register("sgd_update")
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    return (weight.float() - lr * g).to(weight.dtype)


@register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_mom = momentum * mom - lr * g
    return (weight.float() + new_mom).to(weight.dtype), new_mom


@register("nag_mom_update")
def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_mom = momentum * mom + g
    return ((weight.float() - lr * (g + momentum * new_mom)).to(weight.dtype),
            new_mom)


def _adam_kernel(weight, grad, mean, var, lr, decoupled, eta, **kw):
    """The Adam kernel on copies of weight, mean and var (one launch)."""
    w, m, v = (x.clone(memory_format=torch.contiguous_format)
               for x in (weight, mean, var))
    g = grad.to(weight.dtype).clone(memory_format=torch.contiguous_format)
    return fused_update.adam_update(w, g, m, v, lr, decoupled_wd=decoupled,
                                    eta=eta, **kw)


@register("adam_update")
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    if weight.is_cuda:
        return _adam_kernel(weight, grad, mean, var, lr, False, 1.0,
                            beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * g.square()
    step = lr * new_mean / (new_var.sqrt() + epsilon)
    return (weight.float() - step).to(weight.dtype), new_mean, new_var


@register("adamw_update")
def adamw_update(weight, grad, mean, var, lr, eta=1.0, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    if weight.is_cuda:
        return _adam_kernel(weight, grad, mean, var, lr, True, eta,
                            beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * g.square()
    w32 = weight.float()
    step = eta * (lr * new_mean / (new_var.sqrt() + epsilon) + wd * w32)
    return (w32 - step).to(weight.dtype), new_mean, new_var


@register("rmsprop_update")
def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_n = gamma1 * n + (1 - gamma1) * g.square()
    w = weight.float() - lr * g / (new_n.sqrt() + epsilon)
    if clip_weights > 0:
        w = w.clamp(-clip_weights, clip_weights)
    return w.to(weight.dtype), new_n


@register("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_n = gamma1 * n + (1 - gamma1) * g.square()
    new_gavg = gamma1 * g_avg + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - new_gavg.square() + epsilon)
    return ((weight.float() + new_delta).to(weight.dtype), new_n, new_gavg,
            new_delta)


@register("ftrl_update")
def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    w32 = weight.float()
    new_n = n + g.square()
    sigma = (new_n.sqrt() - n.sqrt()) / lr
    new_z = z + g - sigma * w32
    w = torch.where(
        new_z.abs() <= lamda1, torch.zeros_like(w32),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + new_n.sqrt()) / lr + wd))
    return w.to(weight.dtype), new_z, new_n


@register("signsgd_update")
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    return (weight.float() - lr * torch.sign(g)).to(weight.dtype)


@register("signum_update")
def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_mom = momentum * mom - (1 - momentum) * g
    w = (1 - lr * wd_lh) * weight.float() + lr * torch.sign(new_mom)
    return w.to(weight.dtype), new_mom


@register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * g.square()
    m_hat, v_hat = new_mean, new_var
    if bias_correction:
        m_hat = new_mean / (1 - beta1 ** t)
        v_hat = new_var / (1 - beta2 ** t)
    update = m_hat / (v_hat.sqrt() + epsilon) + wd * weight.float()
    return update, new_mean, new_var


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    r1 = torch.as_tensor(r1, dtype=torch.float32, device=weight.device)
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=weight.device)
    r1 = torch.where(r1 > 0, r1, torch.ones_like(r1))
    r2 = torch.where(r2 > 0, r2, torch.ones_like(r2))
    trust = r1 / r2
    if lower_bound > 0:
        trust = trust.clamp(min=lower_bound)
    if upper_bound > 0:
        trust = trust.clamp(max=upper_bound)
    return (weight.float() - lr * trust * g_update).to(weight.dtype)


@register("lamb_update")
def lamb_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, lower_bound=-1.0,
                upper_bound=-1.0):
    """The whole LAMB step: phase 1, the two norms, phase 2."""
    update, new_mean, new_var = lamb_update_phase1(
        weight, grad, mean, var, beta1, beta2, epsilon, t, bias_correction,
        wd, rescale_grad, clip_gradient)
    r1 = weight.float().square().sum().sqrt()
    r2 = update.square().sum().sqrt()
    w = lamb_update_phase2(weight, update, r1, r2, lr, lower_bound,
                           upper_bound)
    return w, new_mean, new_var


@register("adagrad_update")
def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, _clip(clip_gradient))
    new_hist = history + g.square()
    w = weight.float() - lr * g * torch.rsqrt(new_hist + epsilon)
    return w.to(weight.dtype), new_hist


@register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.float() * rescale_grad
    if clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


# -- the multi-tensor forms (reference `multi_sgd_update`, `multi_sum_sq`,
# `multi_mp_sgd_*`): one call updates a group of parameters ---------------

def _per_tensor(vals, i, default):
    if vals is None:
        return default
    if isinstance(vals, (int, float)):
        return float(vals)
    return float(vals[i])


@register("multi_sum_sq")
def multi_sum_sq(*arrays, num_arrays=None):
    """Per-array sum of squares."""
    return tuple(a.float().square().sum() for a in arrays)


@register("multi_sgd_update")
def multi_sgd_update(*weights_grads, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=None):
    """weights_grads = (w0, g0, w1, g1, ...); returns the new weights."""
    n = num_weights if num_weights is not None else len(weights_grads) // 2
    return tuple(
        sgd_update(weights_grads[2 * i], weights_grads[2 * i + 1],
                   _per_tensor(lrs, i, 0.01), wd=_per_tensor(wds, i, 0.0),
                   rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(n))


@register("multi_sgd_mom_update")
def multi_sgd_mom_update(*wgm, momentum=0.0, lrs=None, wds=None,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=None):
    """wgm = (w0, g0, m0, w1, g1, m1, ...); returns (w0, m0, w1, m1, ...)."""
    n = num_weights if num_weights is not None else len(wgm) // 3
    out = []
    for i in range(n):
        out += sgd_mom_update(*wgm[3 * i:3 * i + 3], _per_tensor(lrs, i, 0.01),
                              momentum=momentum, wd=_per_tensor(wds, i, 0.0),
                              rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)
    return tuple(out)


@register("multi_mp_sgd_update")
def multi_mp_sgd_update(*wgw32, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=None):
    """wgw32 = (w0, g0, w32_0, ...); returns (w0, w32_0, w1, w32_1, ...)."""
    n = num_weights if num_weights is not None else len(wgw32) // 3
    out = []
    for i in range(n):
        out += mp_sgd_update(*wgw32[3 * i:3 * i + 3], _per_tensor(lrs, i, 0.01),
                             wd=_per_tensor(wds, i, 0.0),
                             rescale_grad=rescale_grad,
                             clip_gradient=clip_gradient)
    return tuple(out)


@register("multi_mp_sgd_mom_update")
def multi_mp_sgd_mom_update(*wgmw32, momentum=0.0, lrs=None, wds=None,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=None):
    """wgmw32 = (w0, g0, m0, w32_0, ...); returns (w0, m0, w32_0, ...)."""
    n = num_weights if num_weights is not None else len(wgmw32) // 4
    out = []
    for i in range(n):
        out += mp_sgd_mom_update(*wgmw32[4 * i:4 * i + 4],
                                 _per_tensor(lrs, i, 0.01), momentum=momentum,
                                 wd=_per_tensor(wds, i, 0.0),
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
    return tuple(out)


@register("all_finite")
def all_finite(data, init_output=True):
    """1.0 iff every element is finite (the AMP loss-scale probe)."""
    return torch.isfinite(data).all().float()


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    """1.0 iff every element of every array is finite."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.float()
