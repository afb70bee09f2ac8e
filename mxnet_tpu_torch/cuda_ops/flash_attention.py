"""Flash attention forward (counterpart of
`mxnet_tpu/pallas_ops/flash_attention.py`).

Layout (batch, heads, seq, head_dim). For CUDA tensors `flash_fwd`
launches the hand-written kernel in `csrc/flash_fwd.cu`, which emits O
and the row log-sum-exp without materialising the L x L scores. For CPU
tensors it runs the plain version, `flash_fwd_reference` (the JAX
package's `mha_reference` expression plus the LSE). Any other device
raises. Attention dropout (the Philox in-kernel dropout of training)
and the backward kernels arrive with the training slice.

`launches` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_reference"]

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def flash_fwd_reference(q, k, v, bias, causal=False, sm_scale=None):
    """Plain PyTorch forward: scores in float32 plus the (B, Lk) additive
    bias row, the causal mask aligned so the last query sees the last
    key, softmax rounded to q.dtype before P.V. Returns (O in q.dtype,
    LSE (B*H, Lq) float32)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    s = s + bias[:, None, None, :]
    if causal:
        row = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        col = torch.arange(Lk, device=q.device)[None, :]
        s = torch.where(col <= row, s, _NEG)
    lse = torch.logsumexp(s, dim=-1).reshape(B * H, Lq)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v), lse


_fn = None


def _entry():
    global _fn
    if _fn is not None:
        return _fn
    fn = _build.library().mx_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _fn = fn
    return fn


def flash_fwd(q, k, v, bias, causal=False, sm_scale=None):
    """The kernel's wrapper: q (B,H,Lq,D), k/v (B,H,Lk,D) float32 or
    bfloat16, bias (B, Lk) float32 additive. Returns (O, LSE)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, bias, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape \
            or bias.shape != (B, Lk):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, bias "
            f"{tuple(bias.shape)} disagree")
    for name, x in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         "float32 or bfloat16")
    if bias.dtype != torch.float32:
        raise ValueError("flash_attention: bias must be float32")
    if D % 8 or D > 128:
        raise ValueError(f"flash_attention: head dim {D} must be a "
                         "multiple of 8 and <= 128")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), B, H, Lq, Lk, D,
                   float(sm_scale), int(bool(causal)), _DTYPE_CODE[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    return out, lse


def flash_attention(q, k, v, mask=None, causal=False, sm_scale=None,
                    dropout=0.0):
    """Multi-head attention, flash-style (the JAX signature).

    q, k, v: (batch, heads, seq, head_dim), float32 or bfloat16.
    mask: optional (batch, kv_seq), True/1 where attendable.
    Returns (batch, heads, q_seq, head_dim) in q.dtype."""
    if dropout > 0.0:
        raise NotImplementedError(
            "flash_attention: attention dropout arrives with the training "
            "slice (in-kernel Philox dropout and the backward kernels)")
    B, Lk = q.shape[0], k.shape[2]
    if mask is not None:
        bias = torch.where(mask.to(torch.bool), 0.0, _NEG) \
            .to(device=q.device, dtype=torch.float32).contiguous()
    else:
        bias = torch.zeros((B, Lk), dtype=torch.float32, device=q.device)
    return flash_fwd(q, k, v, bias, causal, sm_scale)[0]
