"""Fused optimizer updates (counterpart of
`mxnet_tpu/pallas_ops/fused_update.py`): the per-parameter Adam/AdamW
update and the two fused-LAMB passes over the flat float32 master.

`adam_update(w, g, m, v, lr, ...)` updates one parameter w (float32 or
bfloat16, g in w's dtype) and its float32 moments m, v in place, where
the JAX package aliased them to the kernel's outputs. For CUDA tensors it
launches the kernel of `csrc/fused_update.cu`; for CPU tensors it runs
the plain version, `adam_update_reference`, which is
`mxnet_tpu/ops/optimizer_ops.py`'s `adam_update` / `adamw_update`
verbatim (MXNet's Adam, not `torch.optim`'s: weight decay folds into the
gradient after rescale and clip, AdamW's step is eta·(lr_t·m/(√v+ε) +
wd·w) with wd not scaled by lr, ε outside the root, bias correction
folded into lr_t by the caller) and copies its result back.

For LAMB, W, G, m, v are (R, 512) float32 row views of `FusedLamb`'s flat vectors;
wd_rows and trust_rows are (R,) float32. For CUDA tensors `lamb_pass1`
and `lamb_pass2` launch the kernels of `csrc/fused_update.cu`; for CPU
tensors they run the plain versions, `lamb_pass1_reference` and
`lamb_pass2_reference`. Both routes update in place where the JAX package
donated its buffers: pass 1 writes m and v, pass 2 writes W. Any other
device raises.

`launches_adam`, `launches_pass1` and `launches_pass2` count kernel
launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["adam_update", "adam_update_reference", "lamb_pass1",
           "lamb_pass2", "lamb_pass1_reference", "lamb_pass2_reference",
           "LANES"]

LANES = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches_adam = 0
launches_pass1 = 0
launches_pass2 = 0


def adam_update_reference(w, g, m, v, lr, beta1=0.9, beta2=0.999,
                          epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, decoupled_wd=False, eta=1.0):
    """Plain Adam (decoupled_wd False) or AdamW step; returns (new_w,
    new_m, new_v) in the input dtypes and leaves its inputs alone."""
    g = g.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    w32 = w.float()
    if not decoupled_wd:
        g = g + wd * w32
    new_m = beta1 * m + (1 - beta1) * g
    new_v = beta2 * v + (1 - beta2) * g.square()
    step = lr * new_m / (new_v.sqrt() + epsilon)
    if decoupled_wd:
        step = eta * (step + wd * w32)
    return (w32 - step).to(w.dtype), new_m, new_v


def _update(m, v, W, wd_rows, c1, c2, epsilon, bias_correction):
    m_hat, v_hat = (m / c1, v / c2) if bias_correction else (m, v)
    return m_hat / (torch.sqrt(v_hat) + epsilon) + wd_rows[:, None] * W


def lamb_pass1_reference(W, G, m, v, wd_rows, c1, c2, *, beta1, beta2,
                         epsilon, rescale_grad, clip_gradient,
                         bias_correction):
    """Plain pass 1: g = clip(G * rescale), the moment EMAs written into
    m and v in place, u = m_hat / (sqrt(v_hat) + eps) + wd * W. Returns
    the per-row sums of squares (rowsq_w, rowsq_u), each (R,)."""
    g = G * rescale_grad
    if clip_gradient and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    m.mul_(beta1).add_((1 - beta1) * g)
    v.mul_(beta2).add_((1 - beta2) * (g * g))
    u = _update(m, v, W, wd_rows, c1, c2, epsilon, bias_correction)
    return (W * W).sum(1), (u * u).sum(1)


def lamb_pass2_reference(W, m, v, wd_rows, trust_rows, c1, c2, lr, *,
                         epsilon, bias_correction):
    """Plain pass 2: recompute u from the stored moments and apply
    W -= lr * trust_row * u in place. Returns W."""
    u = _update(m, v, W, wd_rows, c1, c2, epsilon, bias_correction)
    return W.sub_((lr * trust_rows)[:, None] * u)


_fns = {}


def _entry(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library(), name)
        fn.restype = ctypes.c_int
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "mx_lamb_pass1": [p] * 7 + [i] + [f] * 9 + [i, p],
            "mx_lamb_pass2": [p] * 5 + [i] + [f] * 3 + [i, f, p],
            "mx_adam_update": [p] * 4 + [ctypes.c_longlong, i] + [f] * 10
            + [i, p],
        }[name]
        _fns[name] = fn
    return fn


def _check(what, rows, vecs):
    """rows: (name, tensor) of (R, 512) float32; vecs: of (R,) float32."""
    R = rows[0][1].shape[0]
    if R >= 1 << 31:
        raise ValueError(f"{what}: {R} rows exceed the kernels' int row "
                         "count")
    dev = rows[0][1].device
    for name, x, shape in [r + ((R, LANES),) for r in rows] \
            + [r + ((R,),) for r in vecs]:
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{what}: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {shape} float32")
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, W on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    return R


def _device(W, what):
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {W.device}")
    return W.device.type


def adam_update(w, g, m, v, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                decoupled_wd=False, eta=1.0):
    """One Adam/AdamW step of one parameter, in place: w (float32 or
    bfloat16), g (w's dtype and shape), m, v (float32, w's shape), all
    contiguous, 16-byte aligned and on one device; lr is the
    bias-corrected host float lr_t.
    Returns (w, m, v)."""
    kw = dict(beta1=beta1, beta2=beta2, epsilon=epsilon, wd=wd,
              rescale_grad=rescale_grad, clip_gradient=clip_gradient,
              decoupled_wd=decoupled_wd, eta=eta)
    if _device(w, "adam_update") == "cpu":
        for dst, src in zip((w, m, v),
                            adam_update_reference(w, g, m, v, lr, **kw)):
            dst.copy_(src)
        return w, m, v
    if w.dtype not in _DTYPE_CODE or g.dtype != w.dtype:
        raise ValueError(f"adam_update: w {w.dtype}, g {g.dtype}; expected "
                         "float32 or bfloat16 and g in w's dtype")
    for name, x in (("g", g), ("m", m), ("v", v)):
        if x.shape != w.shape or x.device != w.device:
            raise ValueError(f"adam_update: {name} is {tuple(x.shape)} on "
                             f"{x.device}, w {tuple(w.shape)} on {w.device}")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"adam_update: moments {m.dtype}/{v.dtype}, "
                         "expected float32")
    if not all(x.is_contiguous() for x in (w, g, m, v)):
        raise ValueError("adam_update: w, g, m and v must be contiguous")
    n = w.numel()
    if n == 0:
        return w, m, v
    # the kernel loads 4 elements of each array at once
    if any(x.data_ptr() % 16 for x in (w, g, m, v)):
        raise ValueError("adam_update: w, g, m and v must start on a "
                         "16-byte boundary (a fresh allocation does)")
    clip = float(clip_gradient) if clip_gradient and clip_gradient > 0 \
        else 0.0
    err = _entry("mx_adam_update")(
        w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
        _DTYPE_CODE[w.dtype], lr, beta1, 1.0 - beta1, beta2,
        1.0 - beta2, epsilon, wd, rescale_grad, clip, eta,
        int(bool(decoupled_wd)),
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "adam_update")
    global launches_adam
    launches_adam += 1
    return w, m, v


def lamb_pass1(W, G, m, v, wd_rows, c1, c2, *, beta1, beta2, epsilon,
               rescale_grad, clip_gradient, bias_correction):
    """Pass 1 over the flat (R, 512) layout; m and v are updated in
    place. Returns (rowsq_w, rowsq_u), each (R,) float32."""
    kw = dict(beta1=beta1, beta2=beta2, epsilon=epsilon,
              rescale_grad=rescale_grad, clip_gradient=clip_gradient,
              bias_correction=bias_correction)
    if _device(W, "lamb_pass1") == "cpu":
        return lamb_pass1_reference(W, G, m, v, wd_rows, c1, c2, **kw)
    R = _check("lamb_pass1", [("W", W), ("G", G), ("m", m), ("v", v)],
               [("wd_rows", wd_rows)])
    rw = torch.empty(R, dtype=torch.float32, device=W.device)
    ru = torch.empty_like(rw)
    err = _entry("mx_lamb_pass1")(
        W.data_ptr(), G.data_ptr(), m.data_ptr(), v.data_ptr(),
        wd_rows.data_ptr(), rw.data_ptr(), ru.data_ptr(), R,
        beta1, 1.0 - beta1, beta2, 1.0 - beta2, epsilon, rescale_grad,
        float(clip_gradient) if clip_gradient and clip_gradient > 0 else 0.0,
        c1, c2, int(bool(bias_correction)),
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(err, "lamb_pass1")
    global launches_pass1
    launches_pass1 += 1
    return rw, ru


def lamb_pass2(W, m, v, wd_rows, trust_rows, c1, c2, lr, *, epsilon,
               bias_correction):
    """Pass 2: W -= lr * trust_row * u in place. Returns W."""
    if _device(W, "lamb_pass2") == "cpu":
        return lamb_pass2_reference(W, m, v, wd_rows, trust_rows, c1, c2, lr,
                                    epsilon=epsilon,
                                    bias_correction=bias_correction)
    R = _check("lamb_pass2", [("W", W), ("m", m), ("v", v)],
               [("wd_rows", wd_rows), ("trust_rows", trust_rows)])
    err = _entry("mx_lamb_pass2")(
        W.data_ptr(), m.data_ptr(), v.data_ptr(), wd_rows.data_ptr(),
        trust_rows.data_ptr(), R, epsilon, c1, c2,
        int(bool(bias_correction)), lr,
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(err, "lamb_pass2")
    global launches_pass2
    launches_pass2 += 1
    return W
