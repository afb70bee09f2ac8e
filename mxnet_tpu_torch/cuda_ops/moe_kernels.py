"""Mixture-of-experts dispatch and combine (counterpart of
`mxnet_tpu/pallas_ops/moe_kernels.py`).

    dispatch:  buf[e, c] = sum_n [expert_n == e][pos_n == c] * x[n]
    combine :  y[n]      = gate_n * buf[expert_n, pos_n]

Routing is compact: `expert` and `pos` are (N,) int32; a token whose
expert lies outside [0, E) or whose pos lies outside [0, C) (the
capacity overflow of `moe_route`, or the -1 padding of the JAX package)
is dropped: it dispatches nowhere and combines to zeros.

`dispatch_to_experts(x, expert, pos, num_experts, capacity)` gives the
(E, C, D) float32 expert buffers of the (N, D) tokens,
`combine_from_experts(buf, expert, pos, gate)` the (N, D) float32 gated
rows back. For CUDA tensors they launch the kernels of
`csrc/moe_kernels.cu` (float32 data and int32 routing, contiguous); for
CPU tensors they run the plain versions, `dispatch_reference` and
`combine_reference`, the JAX package's one-hot einsums. Any other device
raises.

Both are differentiable as the JAX package's custom VJPs are, and their
backward passes call the same entry points: the gradient of dispatch in
x is a combine of the cotangent with unit gates; the gradient of combine
in buf is a dispatch of dy * gate, in gate the row sums of dy times a
combine of buf with unit gates. The routing ints get no gradient.

`launches_dispatch` and `launches_combine` count kernel launches (never
plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["dispatch_to_experts", "combine_from_experts",
           "dispatch_reference", "combine_reference"]

launches_dispatch = 0
launches_combine = 0


def _one_hot_dispatch(expert, pos, num_experts, capacity):
    """(N, E, C) float32 selection tensor from compact routing, exactly
    the JAX package's `_one_hot_dispatch` (an out-of-range expert or pos
    selects nothing)."""
    dev = expert.device
    e_oh = expert.long()[:, None] == torch.arange(num_experts, device=dev)
    valid = (pos >= 0) & (pos < capacity)
    p_oh = pos.long().clamp(0, capacity - 1)[:, None] \
        == torch.arange(capacity, device=dev)
    return (e_oh[:, :, None] & p_oh[:, None, :]
            & valid[:, None, None]).float()


def dispatch_reference(x, expert, pos, num_experts, capacity):
    d = _one_hot_dispatch(expert, pos, num_experts, capacity)
    return torch.einsum("nec,nd->ecd", d, x.float())


def combine_reference(buf, expert, pos, gate):
    E, C, _ = buf.shape
    d = _one_hot_dispatch(expert, pos, E, C) * gate.float()[:, None, None]
    return torch.einsum("nec,ecd->nd", d, buf)


_fns = {}


def _entry(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library(), name)
        fn.restype = ctypes.c_int
        p, i = ctypes.c_void_p, ctypes.c_int
        # dispatch: x, expert, pos, buf, scratch; combine: buf, expert, pos,
        # gate, y; then N, D, E, C, vec4, stream
        fn.argtypes = [p] * 5 + [ctypes.c_longlong] + [i] * 4 + [p]
        _fns[name] = fn
    return fn


def _device(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _check(what, data, data_shape, expert, pos, gate=None):
    """Raise unless the kernel can take these tensors: float32 data of
    `data_shape`, (N,) int32 routing (and float32 gate), all contiguous
    on data's device."""
    N = expert.shape[0]
    if data.dtype != torch.float32 or tuple(data.shape) != data_shape:
        raise ValueError(f"{what}: data is {tuple(data.shape)} {data.dtype}, "
                         f"expected {data_shape} float32")
    routing = [("expert", expert, torch.int32), ("pos", pos, torch.int32)]
    if gate is not None:
        routing.append(("gate", gate, torch.float32))
    for name, t, dtype in routing:
        if t.dtype != dtype or tuple(t.shape) != (N,):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype}, "
                             f"expected ({N},) {dtype}")
    for name, t in [("data", data)] + [(n, t) for n, t, _ in routing]:
        if t.device != data.device:
            raise ValueError(f"{what}: {name} on {t.device}, data on "
                             f"{data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _vec4(D, *tensors):
    return int(D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _dispatch(x, expert, pos, num_experts, capacity):
    if _device(x, "dispatch_to_experts") == "cpu":
        return dispatch_reference(x, expert, pos, num_experts, capacity)
    N, D = x.shape
    _check("dispatch_to_experts", x, (N, D), expert, pos)
    buf = torch.empty((num_experts, capacity, D), dtype=torch.float32,
                      device=x.device)
    if buf.numel() == 0:
        return buf
    scratch = torch.empty(2 * num_experts * capacity, dtype=torch.int32,
                          device=x.device)
    err = _entry("mx_moe_dispatch")(
        x.data_ptr(), expert.data_ptr(), pos.data_ptr(), buf.data_ptr(),
        scratch.data_ptr(), N, D, num_experts, capacity, _vec4(D, x, buf),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dispatch_to_experts")
    if _build.cost_tally is not None:
        _build.tally(0, x, expert, pos, buf)
    global launches_dispatch
    launches_dispatch += 1
    return buf


def _combine(buf, expert, pos, gate):
    if _device(buf, "combine_from_experts") == "cpu":
        return combine_reference(buf, expert, pos, gate)
    E, C, D = buf.shape
    N = expert.shape[0]
    _check("combine_from_experts", buf, (E, C, D), expert, pos, gate)
    y = torch.empty((N, D), dtype=torch.float32, device=buf.device)
    if y.numel() == 0:
        return y
    if E * C == 0:
        return y.zero_()
    err = _entry("mx_moe_combine")(
        buf.data_ptr(), expert.data_ptr(), pos.data_ptr(), gate.data_ptr(),
        y.data_ptr(), N, D, E, C, _vec4(D, buf, y),
        torch.cuda.current_stream(buf.device).cuda_stream)
    _build.check(err, "combine_from_experts")
    if _build.cost_tally is not None:
        _build.tally(0, buf, expert, pos, gate, y)
    global launches_combine
    launches_combine += 1
    return y


def _ones(expert):
    return torch.ones(expert.shape, dtype=torch.float32, device=expert.device)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, expert, pos, num_experts, capacity):
        ctx.save_for_backward(expert, pos)
        ctx.x_dtype = x.dtype
        return _dispatch(x, expert, pos, num_experts, capacity)

    @staticmethod
    def backward(ctx, dbuf):
        expert, pos = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _combine(dbuf.contiguous(), expert, pos, _ones(expert)) \
                .to(ctx.x_dtype)
        return dx, None, None, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, expert, pos, gate):
        ctx.save_for_backward(buf, expert, pos, gate)
        return _combine(buf, expert, pos, gate)

    @staticmethod
    def backward(ctx, dy):
        buf, expert, pos, gate = ctx.saved_tensors
        dy = dy.contiguous()
        dbuf = dgate = None
        if ctx.needs_input_grad[0]:
            E, C, _ = buf.shape
            dbuf = _dispatch((dy * gate[:, None]).contiguous(), expert, pos,
                             E, C)
        if ctx.needs_input_grad[3]:
            gathered = _combine(buf, expert, pos, _ones(expert))
            dgate = (dy * gathered).sum(-1).to(gate.dtype)
        return dbuf, None, None, dgate


def dispatch_to_experts(x, expert, pos, num_experts, capacity):
    """Gather tokens into per-expert capacity buffers: (N, D) -> (E, C, D)
    float32. Differentiable in x."""
    return _Dispatch.apply(x, expert, pos, int(num_experts), int(capacity))


def combine_from_experts(buf, expert, pos, gate):
    """Scatter expert outputs back to token order, gate-weighted: (E, C,
    D) -> (N, D) float32; dropped tokens combine to zeros (they pass
    through the residual upstream). Differentiable in buf and gate."""
    return _Combine.apply(buf, expert, pos, gate)
