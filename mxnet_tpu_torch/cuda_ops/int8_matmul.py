"""Int8 serving matmul with the per-channel rescale fused (counterpart of
`mxnet_tpu/pallas_ops/int8_matmul.py`).

`int8_matmul(x_q, w_q_t, x_scale, w_scale, bias=None, relu=False,
w_q_k=None)` computes `relu?(float(x_q @ w_q_t) * (x_scale * w_scale) +
bias)` in float32 from int8 activations (..., K) and the int8 weight
pre-transposed to (K, O), the JAX package's `QuantizedDense` layout. For
CPU tensors it runs the plain version, `int8_matmul_reference`; any other
device but CUDA raises. For CUDA tensors it launches one of the three
routes of `csrc/int8_matmul.cu` (int32 accumulator kept in registers, the
rescale, bias and relu in the epilogue) and counts the launch:

  * M <= 16 rows (decode): the split-K cluster kernel (`launches_decode`);
  * M > 16 with K % 16 == 0 and x on the 16-byte grid: int8 wgmma fed by
    TMA (`launches_wgmma`). It reads the weight K-major, as `w_q_k`, the
    contiguous (O, K) transpose of `w_q_t` (`QuantizedDense` keeps one);
    without it the wrapper makes the transpose itself, one more launch,
    counted in `launches_transpose`;
  * any other M > 16 shape: mma.sync on the (K, O) weight
    (`launches_mma`).

`launches` counts every GEMM launch, whatever its route. The scale
`x_scale * w_scale` is formed in the kernel's epilogue: x_scale is a
host number or a one-element tensor (float32 or bfloat16 stay where they
are, so the dynamic activation scale is never read back to the host),
w_scale (O,) or (1,) float32.

The plain version forms the integer product in float64 (exact: every
partial sum is an integer below 2^53) and casts it to int32, because
torch's `int8 @ int8` returns int8 and wraps, and torch has no CUDA
int8 matmul. The kernel's output equals it bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_reference"]

launches = 0
launches_decode = 0
launches_wgmma = 0
launches_mma = 0
launches_transpose = 0

_ROUTE_DECODE, _ROUTE_WGMMA, _ROUTE_MMA = 0, 1, 2


def _check_int8(x_q, w_q_t):
    if x_q.dtype != torch.int8 or w_q_t.dtype != torch.int8:
        raise TypeError(
            f"int8_matmul needs int8 operands, got {x_q.dtype} x "
            f"{w_q_t.dtype} (quantize first; the fp path is nn.Dense)")


def _combined_scale(x_scale, w_scale, O, device):
    """float32 (O,) scale x_scale * w_scale on `device` (a per-tensor
    (1,) or () w_scale is broadcast)."""
    xs = torch.as_tensor(x_scale, device=device).float()
    s = (xs * torch.as_tensor(w_scale, device=device).float()).reshape(-1)
    if s.numel() == 1 and O > 1:
        s = s.expand(O)
    return s


def int8_matmul_reference(x_q, w_q_t, x_scale, w_scale, bias=None,
                          relu=False):
    """Plain version: the exact int32 product, one rescale to float32,
    then bias and relu. Returns (..., O) float32."""
    _check_int8(x_q, w_q_t)
    acc = torch.matmul(x_q.double(), w_q_t.double()).to(torch.int32)
    out = acc.float() * _combined_scale(x_scale, w_scale, w_q_t.shape[1],
                                        x_q.device)
    if bias is not None:
        out = out + bias.float()
    if relu:
        out = torch.relu(out)
    return out


_fn = None
_stream = None


def _entry():
    global _fn, _stream
    if _fn is None:
        fn = _build.library().mx_int8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p, ctypes.c_int,
                                                ctypes.c_void_p,
                                                ctypes.c_void_p] \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _stream = torch._C._cuda_getCurrentRawStream
        _fn = fn
    return _fn


def _x_scale_arg(x_scale, dev):
    """(pointer, is bfloat16, host value) of x_scale for the kernel, and
    the tensor that must stay alive through the call."""
    if not isinstance(x_scale, torch.Tensor):
        return None, 0, float(x_scale), None
    if x_scale.numel() != 1:
        raise ValueError(f"int8_matmul: x_scale has {x_scale.numel()} "
                         "elements; it is one per tensor")
    if x_scale.device != dev:
        return None, 0, float(x_scale.float()), None
    dt = x_scale.dtype
    if dt == torch.bfloat16:
        return x_scale.data_ptr(), 1, 0.0, x_scale
    if dt != torch.float32:
        x_scale = x_scale.float()
    return x_scale.data_ptr(), 0, 0.0, x_scale


def int8_matmul(x_q, w_q_t, x_scale, w_scale, bias=None, relu=False,
                w_q_k=None):
    """Quantized matmul with fused per-channel rescale.

    x_q (..., K) int8; w_q_t (K, O) int8; x_scale a number or a
    one-element tensor; w_scale (O,) float32 (a (1,) per-tensor scale is
    broadcast); bias optional (O,); w_q_k optional, the contiguous (O, K)
    transpose of w_q_t, read by the card's M > 16 route. Returns
    (..., O) float32."""
    _check_int8(x_q, w_q_t)
    dev = x_q.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return int8_matmul_reference(x_q, w_q_t, x_scale, w_scale, bias,
                                         relu)
        raise ValueError(f"int8_matmul: unsupported device {dev}")
    K, O = w_q_t.shape
    xs = x_q.shape
    if xs[-1] != K:
        raise ValueError(f"int8_matmul: x_q {tuple(xs)} against "
                         f"w_q_t {tuple(w_q_t.shape)}")
    if w_q_t.device != dev:
        raise ValueError(f"int8_matmul: w_q_t on {w_q_t.device}, x_q on "
                         f"{dev}")
    if not (x_q.is_contiguous() and w_q_t.is_contiguous()):
        raise ValueError("int8_matmul: x_q and w_q_t must be contiguous")
    # xs_keep holds a converted scale alive until the launch has read it
    xs_ptr, xs_bf16, xs_host, xs_keep = _x_scale_arg(x_scale, dev)
    ws = w_scale
    if not (isinstance(ws, torch.Tensor) and ws.dtype == torch.float32
            and ws.device == dev and ws.is_contiguous()):
        ws = torch.as_tensor(ws, device=dev).float().contiguous()
    n_ws = ws.numel()
    if n_ws != O and n_ws != 1:
        raise ValueError(f"int8_matmul: w_scale gives {n_ws} scales for "
                         f"{O} channels")
    b_ptr = None
    if bias is not None:
        if not (bias.dtype == torch.float32 and bias.device == dev
                and bias.is_contiguous()):
            bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        if bias.shape != (O,):
            raise ValueError(f"int8_matmul: bias {tuple(bias.shape)}, "
                             f"expected ({O},)")
        b_ptr = bias.data_ptr()
    M = x_q.numel() // K
    out = torch.empty(xs[:-1] + (O,), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    global launches, launches_decode, launches_wgmma, launches_mma
    global launches_transpose
    wk_ptr = None
    x_ptr = x_q.data_ptr()
    if M <= 16:
        route = _ROUTE_DECODE
    elif K % 16 == 0 and x_ptr % 16 == 0:
        route = _ROUTE_WGMMA
        if w_q_k is None:
            w_q_k = w_q_t.t().contiguous()
            launches_transpose += 1
        elif (w_q_k.dtype != torch.int8 or w_q_k.shape != (O, K)
              or w_q_k.device != dev or not w_q_k.is_contiguous()
              or w_q_k.data_ptr() % 16):
            raise ValueError(
                f"int8_matmul: w_q_k must be the contiguous (O, K) = "
                f"({O}, {K}) int8 transpose of w_q_t on {dev}, 16-byte "
                f"aligned; got {w_q_k.dtype} {tuple(w_q_k.shape)} on "
                f"{w_q_k.device}")
        wk_ptr = w_q_k.data_ptr()
    else:
        route = _ROUTE_MMA
    err = (_fn or _entry())(x_ptr, w_q_t.data_ptr(), wk_ptr, xs_ptr, xs_bf16,
                            xs_host, ws.data_ptr(), n_ws == O, b_ptr,
                            out.data_ptr(), M, K, O, route, 1 if relu else 0,
                            _stream(dev.index))
    if err:
        _build.check(err, "int8_matmul")
    launches += 1
    if route == _ROUTE_DECODE:
        launches_decode += 1
    elif route == _ROUTE_WGMMA:
        launches_wgmma += 1
    else:
        launches_mma += 1
    del xs_keep
    return out
