"""Fused optimizer updates (counterpart of
`mxnet_tpu/pallas_ops/fused_update.py`): the multi-tensor Adam/AdamW
update and the two fused-LAMB passes over the flat float32 master.

`adam_update_multi(ws, gs, ms, vs, lrs, wds, ...)` (after upstream
MXNet's `multi_adamw_update`) updates a list of parameters w (float32 or
bfloat16, g in w's dtype) and their float32 moments m, v in place, where
the JAX package aliased them to its kernel's outputs; each tensor has its
own bias-corrected lr_t and weight decay. For a CUDA list it makes one
launch of the kernel of `csrc/fused_update.cu` for each weight dtype in
the list; for a CPU list it runs the plain version per tensor,
`adam_update_reference`, which is `mxnet_tpu/ops/optimizer_ops.py`'s
`adam_update` / `adamw_update` verbatim (MXNet's Adam, not
`torch.optim`'s: weight decay folds into the gradient after rescale and
clip, AdamW's step is eta·(lr_t·m/(√v+ε) + wd·w) with wd not scaled by
lr, ε outside the root, bias correction folded into lr_t by the caller)
and copies its result back. `adam_update(w, g, m, v, lr, ...)` is the
one-parameter form: a list of one.

For LAMB, W and G are (R, 512) float32 row views of `FusedLamb`'s flat
vectors, m and v (R, 512) in the moments' storage dtype: float32, or
bfloat16 under `lamb_moments_dtype="bfloat16"` (both the same; mixed
raises); wd_rows and trust_rows are (R,) float32. With bf16 moments the
EMAs run in float32 and each new moment is rounded to bf16 (nearest
even, as `jnp.astype` rounds) and widened back before the update and its
row sums, so the trust ratio sees what is stored. For CUDA tensors
`lamb_pass1` and `lamb_pass2` launch the kernels of
`csrc/fused_update.cu` (one template instance per moment dtype); for CPU
tensors they run the plain versions, `lamb_pass1_reference` and
`lamb_pass2_reference`. Both routes update in place where the JAX package
donated its buffers: pass 1 writes m and v, pass 2 writes W. Any other
device raises.

`launches_adam`, `launches_pass1` and `launches_pass2` count kernel
launches of either moment dtype (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["adam_update", "adam_update_multi", "adam_update_reference",
           "lamb_pass1", "lamb_pass2", "lamb_pass1_reference",
           "lamb_pass2_reference", "LANES"]

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


def _moments_dtype(what, m, v):
    """The storage dtype of the moments m and v: float32 or bfloat16, the
    same for both."""
    if m.dtype != v.dtype or m.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: moments {m.dtype}/{v.dtype}; expected "
                         "both float32 or both bfloat16")
    return m.dtype


def lamb_pass1_reference(W, G, m, v, wd_rows, c1, c2, *, beta1, beta2,
                         epsilon, rescale_grad, clip_gradient,
                         bias_correction):
    """Plain pass 1: g = clip(G * rescale), the moment EMAs written into
    m and v in place (bf16 moments: computed in float32 and rounded to
    bf16), u = m_hat / (sqrt(v_hat) + eps) + wd * W from the stored
    moments. Returns the per-row sums of squares (rowsq_w, rowsq_u), each
    (R,)."""
    mdt = _moments_dtype("lamb_pass1", m, v)
    g = G * rescale_grad
    if clip_gradient and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    if mdt == torch.float32:
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * (g * g))
    else:
        m.copy_(m.float().mul_(beta1).add_((1 - beta1) * g))
        v.copy_(v.float().mul_(beta2).add_((1 - beta2) * (g * g)))
    u = _update(m.float(), v.float(), W, wd_rows, c1, c2, epsilon,
                bias_correction)
    return (W * W).sum(1), (u * u).sum(1)


def lamb_pass2_reference(W, m, v, wd_rows, trust_rows, c1, c2, lr, *,
                         epsilon, bias_correction):
    """Plain pass 2: recompute u from the stored moments (widened to
    float32) and apply W -= lr * trust_row * u in place. Returns W."""
    _moments_dtype("lamb_pass2", m, v)
    u = _update(m.float(), v.float(), W, wd_rows, c1, c2, epsilon,
                bias_correction)
    return W.sub_((lr * trust_rows)[:, None] * u)


_fns = {}


def _entry(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library(), name)
        fn.restype = ctypes.c_int
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "mx_lamb_pass1": [p] * 7 + [i] + [f] * 9 + [i, i, p],
            "mx_lamb_pass2": [p] * 5 + [i] + [f] * 3 + [i, f, i, p],
            "mx_adam_update_multi": [p, p, i] + [f] * 8 + [i, p, p, p],
        }[name]
        _fns[name] = fn
    return fn


def _check(what, rows, vecs, moments):
    """rows: (name, tensor) of (R, 512) float32; vecs: of (R,) float32;
    moments: (name, tensor) of (R, 512) float32, or bfloat16, one dtype
    for both. Every tensor contiguous, on W's device, its base on the
    16-byte grid (the kernels' vector loads). Returns (R, the moments'
    dtype code)."""
    R = rows[0][1].shape[0]
    if R >= 1 << 31:
        raise ValueError(f"{what}: {R} rows exceed the kernels' int row "
                         "count")
    dev = rows[0][1].device
    mdt = _moments_dtype(what, moments[0][1], moments[1][1])
    for name, x, shape, dt in [r + ((R, LANES), torch.float32) for r in rows] \
            + [r + ((R, LANES), mdt) for r in moments] \
            + [r + ((R,), torch.float32) for r in vecs]:
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"{what}: {name} is {tuple(x.shape)} {x.dtype}, "
                             f"expected {shape} {dt}")
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, W on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} does not start on a 16-byte "
                             "boundary")
    return R, _DTYPE_CODE[mdt]


def _device(W, what):
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {W.device}")
    return W.device.type


# one row of the kernel's table (`AdamEntry` in csrc/fused_update.cu)
_ADAM_ENTRY = np.dtype([("w", "<u8"), ("g", "<u8"), ("m", "<u8"),
                        ("v", "<u8"), ("n", "<i8"), ("lr", "<f4"),
                        ("wd", "<f4")])


def _adam_refusal(w, g, m, v):
    """Why an entry of a CUDA list is refused (the checks' slow path)."""
    if w.dtype not in _DTYPE_CODE or g.dtype != w.dtype:
        return (f"w {w.dtype}, g {g.dtype}; expected float32 or bfloat16 "
                "and g in w's dtype")
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        return f"moments {m.dtype}/{v.dtype}, expected float32"
    for name, x in (("g", g), ("m", m), ("v", v)):
        if x.shape != w.shape:
            return f"{name} is {tuple(x.shape)}, w {tuple(w.shape)}"
    if not all(x.is_contiguous() for x in (w, g, m, v)):
        return "w, g, m and v must be contiguous"
    return (f"w, g, m, v on {w.device}, {g.device}, {m.device}, {v.device}: "
            "one list runs on one device")


def adam_update_multi(ws, gs, ms, vs, lrs, wds, *, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
                      decoupled_wd=False, eta=1.0):
    """One Adam/AdamW step of every parameter of a list, in place: ws[i]
    (float32 or bfloat16), gs[i] (its dtype and shape), ms[i], vs[i]
    (float32, its shape), all contiguous and on one device; lrs[i] is
    its bias-corrected host float lr_t and wds[i] its weight decay. A
    CUDA list launches the kernel once for each weight dtype in it (the
    C entry refuses, naming it, an entry whose arrays are not on a
    16-byte boundary, as a fresh allocation is); a CPU list runs the
    plain version tensor by tensor."""
    n = len(ws)
    if not len(gs) == len(ms) == len(vs) == len(lrs) == len(wds) == n:
        raise ValueError(
            f"adam_update_multi: {n} weights, {len(gs)} gradients, "
            f"{len(ms)}/{len(vs)} moments, {len(lrs)} lrs, {len(wds)} wds")
    if n == 0:
        return
    kw = dict(beta1=beta1, beta2=beta2, epsilon=epsilon,
              rescale_grad=rescale_grad, clip_gradient=clip_gradient,
              decoupled_wd=decoupled_wd, eta=eta)
    if _device(ws[0], "adam_update_multi") == "cpu":
        for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
            if any(x.device.type != "cpu" for x in (w, g, m, v)):
                raise ValueError(
                    f"adam_update_multi: entry {i} has w, g, m, v on "
                    f"{w.device}, {g.device}, {m.device}, {v.device}; the "
                    "list's first weight is on the CPU")
            for dst, src in zip((w, m, v), adam_update_reference(
                    w, g, m, v, lrs[i], wd=wds[i], **kw)):
                dst.copy_(src)
        return
    # every check in one pass; the message is built only for a refusal
    f32, rows, dtypes = torch.float32, [], []
    dev = ws[0].get_device()
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        shape, code = w.shape, _DTYPE_CODE.get(w.dtype)
        if (code is None or g.dtype != w.dtype or m.dtype != f32
                or v.dtype != f32 or g.shape != shape or m.shape != shape
                or v.shape != shape or w.get_device() != dev
                or g.get_device() != dev or m.get_device() != dev
                or v.get_device() != dev or not w.is_contiguous()
                or not g.is_contiguous() or not m.is_contiguous()
                or not v.is_contiguous()):
            raise ValueError(f"adam_update_multi: entry {i}: "
                             + _adam_refusal(w, g, m, v))
        rows.append((w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     w.numel(), lrs[i], wds[i]))
        dtypes.append(code)
    table = np.array(rows, dtype=_ADAM_ENTRY)
    dtypes = np.array(dtypes, np.int32)
    clip = float(clip_gradient) if clip_gradient and clip_gradient > 0 \
        else 0.0
    launched, bad = ctypes.c_int(0), ctypes.c_int(-1)
    err = _entry("mx_adam_update_multi")(
        table.ctypes.data, dtypes.ctypes.data, n, beta1, 1.0 - beta1, beta2,
        1.0 - beta2, epsilon, rescale_grad, clip, eta,
        int(bool(decoupled_wd)),
        torch.cuda.current_stream(ws[0].device).cuda_stream,
        ctypes.byref(launched), ctypes.byref(bad))
    if _build.cost_tally is not None:
        # w, m and v are read and written, g read
        _build.tally(0, *ws, *ws, *gs, *ms, *ms, *vs, *vs)
    global launches_adam
    launches_adam += launched.value
    if bad.value >= 0:
        raise ValueError(
            f"adam_update_multi: entry {bad.value}: w, g, m and v must start "
            "on a 16-byte boundary (a fresh allocation does)")
    _build.check(err, "adam_update_multi")


def adam_update(w, g, m, v, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                decoupled_wd=False, eta=1.0):
    """One Adam/AdamW step of one parameter, in place: `adam_update_multi`
    over a list of one. Returns (w, m, v)."""
    adam_update_multi([w], [g], [m], [v], [lr], [wd], beta1=beta1,
                      beta2=beta2, epsilon=epsilon, rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient, decoupled_wd=decoupled_wd,
                      eta=eta)
    return w, m, v


def lamb_pass1(W, G, m, v, wd_rows, c1, c2, *, beta1, beta2, epsilon,
               rescale_grad, clip_gradient, bias_correction):
    """Pass 1 over the flat (R, 512) layout; m and v (float32 or
    bfloat16) are updated in place. Returns (rowsq_w, rowsq_u), each (R,)
    float32."""
    kw = dict(beta1=beta1, beta2=beta2, epsilon=epsilon,
              rescale_grad=rescale_grad, clip_gradient=clip_gradient,
              bias_correction=bias_correction)
    if _device(W, "lamb_pass1") == "cpu":
        return lamb_pass1_reference(W, G, m, v, wd_rows, c1, c2, **kw)
    R, mdt = _check("lamb_pass1", [("W", W), ("G", G)],
                    [("wd_rows", wd_rows)], [("m", m), ("v", v)])
    rw = torch.empty(R, dtype=torch.float32, device=W.device)
    ru = torch.empty_like(rw)
    err = _entry("mx_lamb_pass1")(
        W.data_ptr(), G.data_ptr(), m.data_ptr(), v.data_ptr(),
        wd_rows.data_ptr(), rw.data_ptr(), ru.data_ptr(), R,
        beta1, 1.0 - beta1, beta2, 1.0 - beta2, epsilon, rescale_grad,
        float(clip_gradient) if clip_gradient and clip_gradient > 0 else 0.0,
        c1, c2, int(bool(bias_correction)), mdt,
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(err, "lamb_pass1")
    if _build.cost_tally is not None:
        # m and v are read and written
        _build.tally(0, W, G, m, v, m, v, wd_rows, rw, ru)
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
    R, mdt = _check("lamb_pass2", [("W", W)],
                    [("wd_rows", wd_rows), ("trust_rows", trust_rows)],
                    [("m", m), ("v", v)])
    err = _entry("mx_lamb_pass2")(
        W.data_ptr(), m.data_ptr(), v.data_ptr(), wd_rows.data_ptr(),
        trust_rows.data_ptr(), R, epsilon, c1, c2,
        int(bool(bias_correction)), lr, mdt,
        torch.cuda.current_stream(W.device).cuda_stream)
    _build.check(err, "lamb_pass2")
    if _build.cost_tally is not None:
        _build.tally(0, W, W, m, v, wd_rows, trust_rows)
    global launches_pass2
    launches_pass2 += 1
    return W
