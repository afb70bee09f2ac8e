"""Int8 serving matmul with the per-channel rescale fused (counterpart of
`mxnet_tpu/pallas_ops/int8_matmul.py`).

`int8_matmul(x_q, w_q_t, x_scale, w_scale, bias=None, relu=False)`
computes `relu?(float(x_q @ w_q_t) * (x_scale * w_scale) + bias)` in
float32 from int8 activations (..., K) and the int8 weight pre-transposed
to (K, O), the JAX package's `QuantizedDense` layout. For CUDA tensors it
launches the hand-written tensor-core kernel of `csrc/int8_matmul.cu`
(int32 accumulator kept in registers, the rescale, bias and relu in its
epilogue); for CPU tensors it runs the plain version,
`int8_matmul_reference`. The combined scale `x_scale * w_scale` is
computed on the device, so a scale that is a 0-d device tensor (the
dynamic activation scale) is never read back to the host. Any other
device raises.

The plain version forms the integer product in float64 (exact: every
partial sum is an integer below 2^53) and casts it to int32, because
torch's `int8 @ int8` returns int8 and wraps, and torch has no CUDA
int8 matmul. The kernel's output equals it bit for bit.

`launches` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_reference"]

launches = 0


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


def _entry():
    global _fn
    if _fn is None:
        fn = _build.library().mx_int8_matmul
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        _fn = fn
    return _fn


def int8_matmul(x_q, w_q_t, x_scale, w_scale, bias=None, relu=False):
    """Quantized matmul with fused per-channel rescale.

    x_q (..., K) int8; w_q_t (K, O) int8; x_scale a float or a 0-d tensor;
    w_scale (O,) float32 (a (1,) per-tensor scale is broadcast); bias
    optional (O,). Returns (..., O) float32."""
    _check_int8(x_q, w_q_t)
    dev = x_q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {dev}")
    if dev.type == "cpu":
        return int8_matmul_reference(x_q, w_q_t, x_scale, w_scale, bias,
                                     relu)
    K, O = w_q_t.shape
    if x_q.shape[-1] != K:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} against "
                         f"w_q_t {tuple(w_q_t.shape)}")
    if w_q_t.device != dev:
        raise ValueError(f"int8_matmul: w_q_t on {w_q_t.device}, x_q on "
                         f"{dev}")
    if not (x_q.is_contiguous() and w_q_t.is_contiguous()):
        raise ValueError("int8_matmul: x_q and w_q_t must be contiguous")
    lead = x_q.shape[:-1]
    M = x_q.numel() // K
    s = _combined_scale(x_scale, w_scale, O, dev).contiguous()
    if s.shape != (O,):
        raise ValueError(f"int8_matmul: w_scale gives {tuple(s.shape)} "
                         f"scales for {O} channels")
    b = None
    if bias is not None:
        b = bias.to(device=dev, dtype=torch.float32).contiguous()
        if b.shape != (O,):
            raise ValueError(f"int8_matmul: bias {tuple(b.shape)}, "
                             f"expected ({O},)")
    out = torch.empty(lead + (O,), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    x_vec = int(x_q.data_ptr() % 16 == 0 and K % 16 == 0)
    w_vec = int(w_q_t.data_ptr() % 4 == 0 and O % 4 == 0)
    err = _entry()(x_q.data_ptr(), w_q_t.data_ptr(), s.data_ptr(),
                   None if b is None else b.data_ptr(), out.data_ptr(),
                   M, K, O, x_vec, w_vec, int(bool(relu)),
                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int8_matmul")
    global launches
    launches += 1
    return out
