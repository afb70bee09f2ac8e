"""Paged decode attention: one-token attention through a page table
(counterpart of `mxnet_tpu/pallas_ops/paged_attention.py`).

For CUDA tensors `paged_attention` launches the hand-written kernel in
`csrc/paged_attention.cu`, which walks row b's page table inside the
block and never materialises the gathered (B, H, L, D) cache. For CPU
tensors it runs the plain version, `paged_attention_reference`: the
gather followed by VERBATIM the dense slot-cache step's float32
score/softmax/PV expression (`models/_decode.batched_cached_attention_step`)
at the gathered shapes, which is what keeps `pages="on"` serving on the
CPU bit-identical to `pages="off"`. Any other device raises.

`launches` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference"]

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def paged_attention_reference(q, k_pages, v_pages, tables, t):
    """Plain PyTorch paged decode attention.

    q (B,H,1,D); k_pages/v_pages (P,H,ps,D); tables (B,n_pg) int page
    ids; t (B,) int positions. Returns (B,H,1,D) in q.dtype."""
    kc = k_pages[tables]                          # (B, n_pg, H, ps, D)
    B, n_pg, H, ps, D = kc.shape
    kc = kc.permute(0, 2, 1, 3, 4).reshape(B, H, n_pg * ps, D)
    vc = v_pages[tables].permute(0, 2, 1, 3, 4).reshape(B, H, n_pg * ps, D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) / (D ** 0.5)
    valid = torch.arange(kc.shape[2], device=q.device)[None, None, None, :] \
        <= t[:, None, None, None]
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vc.float()).to(q.dtype)


_fn = None


def _entry():
    global _fn
    if _fn is not None:
        return _fn
    fn = _build.library().mx_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    _fn = fn
    return fn


def paged_attention(q, k_pages, v_pages, tables, t):
    """Single-query decode attention through a page table.

    q: (B, H, 1, D); k_pages, v_pages: (P, H, page_size, D) pooled pages
    (page id p is physical row p); tables: (B, n_pg) int32 page ids, row
    b's positions [0, n_pg*page_size) map page-major onto its entries;
    t: (B,) int32, row b attends positions <= t[b].
    Returns (B, H, 1, D) in q.dtype."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, tables, t)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    B, H, one, D = q.shape
    P, Hp, ps, Dp = k_pages.shape
    if one != 1 or (Hp, Dp) != (H, D) or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} disagree")
    if tables.dim() != 2 or tables.shape[0] != B or t.shape != (B,):
        raise ValueError(f"paged_attention: tables {tuple(tables.shape)} / "
                         f"t {tuple(t.shape)} do not match batch {B}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("t", t)):
        if x.device != q.device:
            raise ValueError(f"paged_attention: {name} on {x.device}, "
                             f"q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged_attention: dtypes q {q.dtype} / pages {k_pages.dtype} "
            "must both be float32 or both bfloat16")
    if tables.dtype != torch.int32 or t.dtype != torch.int32:
        raise ValueError("paged_attention: tables and t must be int32")
    if D % 8 or D > 128:
        raise ValueError(f"paged_attention: head dim {D} must be a "
                         "multiple of 8 and <= 128")
    out = torch.empty_like(q)
    err = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   tables.data_ptr(), t.data_ptr(), out.data_ptr(),
                   B, H, ps, D, tables.shape[1], 1.0 / (D ** 0.5),
                   _DTYPE_CODE[q.dtype],
                   torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    global launches
    launches += 1
    return out
