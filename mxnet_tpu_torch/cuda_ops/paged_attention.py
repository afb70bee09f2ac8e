"""Paged decode attention: one-token attention through a page table
(counterpart of `mxnet_tpu/pallas_ops/paged_attention.py`).

For CUDA tensors `paged_attention` launches the hand-written kernel in
`csrc/paged_attention.cu`, which splits row b's pages over a cluster of
blocks, streams them from the pool with bulk copies and merges the
partial softmax states in the same launch; the gathered (B, H, L, D)
cache is never materialised. For CPU
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
_stream = None


def _entry():
    global _fn, _stream
    if _fn is None:
        fn = _build.library().mx_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _stream = torch._C._cuda_getCurrentRawStream
        _fn = fn
    return _fn


def _refuse(q, k_pages, v_pages, tables, t):
    """Why the kernel cannot take these operands, or None if it can."""
    qs, ks = q.shape, k_pages.shape
    if len(qs) != 4 or qs[2] != 1 or len(ks) != 4 or ks[1] != qs[1] \
            or ks[3] != qs[3] or v_pages.shape != ks:
        return (f"shapes q {tuple(qs)}, pages {tuple(ks)}/"
                f"{tuple(v_pages.shape)} disagree")
    B, D = qs[0], qs[3]
    if tables.dim() != 2 or tables.shape[0] != B or t.shape != (B,):
        return (f"tables {tuple(tables.shape)} / t {tuple(t.shape)} do not "
                f"match batch {B}")
    dev = q.device
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("t", t)):
        if x.device != dev:
            return f"{name} on {x.device}, q on {dev}"
        if not x.is_contiguous():
            return f"{name} is not contiguous"
    dt = q.dtype
    if dt not in _DTYPE_CODE or k_pages.dtype != dt or v_pages.dtype != dt:
        return (f"dtypes q {dt} / pages {k_pages.dtype} must both be "
                "float32 or both bfloat16")
    if tables.dtype != torch.int32 or t.dtype != torch.int32:
        return "tables and t must be int32"
    if D % 8 or D > 128:
        return f"head dim {D} must be a multiple of 8 and <= 128"
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        return "k_pages and v_pages must start on the 16-byte grid"
    return None


def paged_attention(q, k_pages, v_pages, tables, t):
    """Single-query decode attention through a page table.

    q: (B, H, 1, D); k_pages, v_pages: (P, H, page_size, D) pooled pages
    (page id p is physical row p); tables: (B, n_pg) int32 page ids, row
    b's positions [0, n_pg*page_size) map page-major onto its entries;
    t: (B,) int32, row b attends positions <= t[b].
    Returns (B, H, 1, D) in q.dtype."""
    dev = q.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return paged_attention_reference(q, k_pages, v_pages, tables, t)
        raise ValueError(f"paged_attention: unsupported device {dev}")
    why = _refuse(q, k_pages, v_pages, tables, t)
    if why is not None:
        raise ValueError(f"paged_attention: {why}")
    B, H, _, D = q.shape
    out = torch.empty_like(q)
    fn = _entry()
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             tables.data_ptr(), t.data_ptr(), out.data_ptr(), B, H,
             k_pages.shape[2], D, tables.shape[1], 1.0 / (D ** 0.5),
             _DTYPE_CODE[q.dtype], _stream(dev.index))
    if err:
        _build.check(err, "paged_attention")
    global launches
    launches += 1
    return out
