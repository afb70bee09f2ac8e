"""Incremental-decode attention steps (counterpart of
`mxnet_tpu/models/_decode.py`).

Every K/V write below happens IN PLACE in the cache or page pool it is
given. The JAX package wrote a new array and donated the old buffer to
the executable, so no step double-buffered the cache; PyTorch mutates
the tensor itself to the same end. The caches are returned all the same
so the call shapes match the JAX package's.

The score/softmax/PV math is float32 whatever the cache dtype, and the
dense steps and the paged step's plain version share it verbatim at the
same operand shapes: that is what keeps `pages="on"` serving on the CPU
bit-identical to `pages="off"`.
"""
from __future__ import annotations

import torch

from ..cuda_ops.paged_attention import paged_attention

_NEG = -1e30


def _attend(q, kc, vc, valid):
    """q (B,H,1,D); caches (B,H,L,D); valid broadcastable to
    (B,H,1,L). Returns (B,1,H*D) in q.dtype."""
    B, H, _, D = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) / (D ** 0.5)
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vc.float()).to(q.dtype)
    return o.transpose(1, 2).reshape(B, 1, H * D)


def cached_self_attention_step(q, k_new, v_new, k_cache, v_cache, t):
    """One-token causal KV-cache attention at one position for every
    row: write this token's K/V at position t (a Python int), attend q
    over positions <= t.

    q/k_new/v_new (B,H,1,D); caches (B,H,Lmax,D), written in place.
    Returns (out (B,1,H*D), k_cache, v_cache)."""
    k_cache[:, :, t] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, t] = v_new[:, :, 0].to(v_cache.dtype)
    valid = torch.arange(k_cache.shape[2], device=q.device) <= t
    return _attend(q, k_cache, v_cache, valid), k_cache, v_cache


def batched_cached_attention_step(q, k_new, v_new, k_cache, v_cache, t):
    """`cached_self_attention_step` with PER-ROW positions t (B,): row b
    writes at t[b] and attends positions <= t[b], so a request's logits
    do not depend on what the other slots do.

    Caches are written in place. Returns (out (B,1,H*D), k_cache,
    v_cache)."""
    rows = torch.arange(q.shape[0], device=q.device)
    k_cache[rows, :, t] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[rows, :, t] = v_new[:, :, 0].to(v_cache.dtype)
    valid = torch.arange(k_cache.shape[2], device=q.device)[
        None, None, None, :] <= t[:, None, None, None]
    return _attend(q, k_cache, v_cache, valid), k_cache, v_cache


def paged_attention_step(q, k_new, v_new, k_pages, v_pages, tables, wp, wo,
                         t):
    """`batched_cached_attention_step` over a block-table cache: row b
    writes this token's K/V into page wp[b] at in-page offset wo[b] and
    attends over positions <= t[b] through its page table, by the paged
    attention kernel (its plain version on the CPU).

    The write targets are distinct by construction (every slot owns its
    write page; masked rows write their private scratch page), so the
    in-place scatter never sees a duplicate index.

    q (contiguous)/k_new/v_new (B,H,1,D); pages (P,H,ps,D), written in
    place; tables (B,n_pg) int32; wp/wo/t (B,) int32. Returns
    (out (B,1,H*D), k_pages, v_pages)."""
    k_pages[wp, :, wo] = k_new[:, :, 0].to(k_pages.dtype)
    v_pages[wp, :, wo] = v_new[:, :, 0].to(v_pages.dtype)
    B, H, _, D = q.shape
    o = paged_attention(q, k_pages, v_pages, tables, t)
    return o.transpose(1, 2).reshape(B, 1, H * D), k_pages, v_pages
