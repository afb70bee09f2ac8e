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

`beam_search_loop` is the JAX package's host-side beam bookkeeping,
copied verbatim (numpy on the host), so a model's beams, tokens and
scores follow the JAX package's from the same logits; its `step`
returns host logits.
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


def beam_search_loop(logits0, step, reorder, B, beam, eos, max_steps,
                     alpha=0.6, seqs0=None, lengths0=1):
    """Host-side beam bookkeeping shared by TransformerNMT.beam_search and
    GPTForCausalLM.generate(num_beams>1): device emits logits, the host
    selects top-k continuations, and `reorder` gathers the KV caches by
    beam parent on-device.

    logits0: (B*beam, V) for the FIRST expansion (encoder bos step for
    NMT, prompt prefill for GPT) — only beam 0 is live so the expansion
    yields `beam` DISTINCT tokens, not copies of the argmax.
    step(tok_flat (B*beam,) int32, i) -> (B*beam, V) logits for expansion
    i+1.  reorder(gather (B*beam,) int32) reindexes the caches.
    Returns (seqs (B, <=max_steps [+ seqs0 cols]), scores (B,)) — the
    best beam per batch under Sockeye/GNMT length norm
    lp(l) = ((5+l)/6)^alpha."""
    import numpy as np

    if seqs0 is None:
        seqs = np.zeros((B, beam, 0), np.int32)
    else:
        seqs = np.asarray(seqs0, np.int32)
    cum = np.full((B, beam), -np.inf, np.float32)
    cum[:, 0] = 0.0
    finished = np.zeros((B, beam), bool)
    lengths = np.full((B, beam), lengths0, np.int32)
    batch_off = np.arange(B)[:, None] * beam
    logits = logits0

    for i in range(max_steps):
        lg = np.asarray(logits, np.float32)
        V = lg.shape[-1]
        m = lg.max(-1, keepdims=True)
        logp = lg - np.log(np.exp(lg - m).sum(-1, keepdims=True)) - m
        logp = logp.reshape(B, beam, V)
        # finished beams may only emit eos, at no additional cost
        fin_row = np.full((V,), -np.inf, np.float32)
        fin_row[eos] = 0.0
        logp = np.where(finished[:, :, None], fin_row[None, None, :], logp)
        flat = (cum[:, :, None] + logp).reshape(B, beam * V)
        top = np.argpartition(-flat, beam - 1, axis=1)[:, :beam]
        order = np.argsort(-np.take_along_axis(flat, top, 1), axis=1)
        top = np.take_along_axis(top, order, 1)              # sorted top-k
        parent = top // V                                    # (B, beam)
        tok = (top % V).astype(np.int32)
        cum = np.take_along_axis(flat, top, 1)
        finished = np.take_along_axis(finished, parent, 1)
        lengths = np.take_along_axis(lengths, parent, 1) + (~finished)
        seqs = np.take_along_axis(seqs, parent[:, :, None], 1)
        seqs = np.concatenate([seqs, tok[:, :, None]], axis=2)
        finished = finished | (tok == eos)
        reorder((batch_off + parent).reshape(-1).astype(np.int32))
        if finished.all():
            break
        if i < max_steps - 1:
            logits = step(tok.reshape(-1).astype(np.int32), i)

    lp = ((5.0 + lengths) / 6.0) ** alpha
    norm = cum / lp
    norm = np.where(np.isfinite(norm), norm, -np.inf)
    best = norm.argmax(axis=1)
    idx = np.arange(B)
    return seqs[idx, best], norm[idx, best]
