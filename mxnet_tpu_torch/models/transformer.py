"""Sockeye-style Transformer NMT (counterpart of
`mxnet_tpu/models/transformer.py`; BASELINE.json workload #3).

Post-LN encoder-decoder with separate q/k/v projections, sinusoidal
positions and label smoothing. Training runs `forward` (teacher forcing)
through the flash kernels: the encoder's self-attention with the
(B, Ls) padding mask of `src_valid`, the decoder's causal
self-attention, and cross-attention with Lq = Lt, Lk = Ls under the same
mask; `_heads_of`'s (B, H, L, D) views pay one copy each into the
kernels' contiguous layout (`nn_ops.flash_attention`). Parameter paths
equal the JAX package's `collect_params()` paths.

Inference encodes once (one flash forward per encoder layer), computes
every decoder layer's cross K/V once, and steps the decoder one token at
a time against per-layer self-attention caches written in place
(`_decode.cached_self_attention_step`), where the JAX package jits one
step per geometry and donates the caches. `greedy_decode` and
`beam_search` run under `torch.no_grad()`; beam bookkeeping is the JAX
package's `beam_search_loop` on the host (it copies each step's
(B·beam, V) logits to the host), and a beam reorder is an
`index_select` of every layer's self caches (the cross K/V and the mask
are beam-invariant).

`device=None` builds the parameters on the card (raising when there is
none); pass `device="cpu"` to build them on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import context
from ..gluon import HybridBlock, nn
from ..gluon.parameter import Constant
from ..ndarray.ndarray import NDArray
from ..ops import nn_ops
from ._decode import _attend, beam_search_loop, cached_self_attention_step

__all__ = ["MultiHeadAttention", "TransformerLayer", "TransformerNMT",
           "label_smoothing_loss"]


def _positional_encoding(max_len, units):
    pos = np.arange(max_len)[:, None]
    dim = np.arange(units // 2)[None, :]
    angle = pos / np.power(10000, 2 * dim / units)
    enc = np.zeros((max_len, units), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


def _tensor(x, device):
    """A token or length array (NDArray, tensor or array-like) as a
    tensor on `device`."""
    if isinstance(x, NDArray):
        x = x._t
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device)


class MultiHeadAttention(HybridBlock):
    def __init__(self, units, num_heads, dtype="float32"):
        super().__init__()
        self._units = units
        self._heads = num_heads
        self.q_proj = nn.Dense(units, in_units=units, flatten=False,
                               dtype=dtype, weight_initializer="xavier")
        self.k_proj = nn.Dense(units, in_units=units, flatten=False,
                               dtype=dtype, weight_initializer="xavier")
        self.v_proj = nn.Dense(units, in_units=units, flatten=False,
                               dtype=dtype, weight_initializer="xavier")
        self.out_proj = nn.Dense(units, in_units=units, flatten=False,
                                 dtype=dtype, weight_initializer="xavier")

    def forward(self, q, kv, mask=None, causal=False):
        B, Lq, E = q.shape
        out = nn_ops.flash_attention(self._heads_of(self.q_proj, q),
                                     self._heads_of(self.k_proj, kv),
                                     self._heads_of(self.v_proj, kv), mask,
                                     causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, E))

    # -- incremental decode ------------------------------------------------
    def _heads_of(self, proj, x):
        """proj(x) (B, L, E) as a (B, H, L, D) view."""
        B, L, _ = x.shape
        H, D = self._heads, self._units // self._heads
        return proj(x).reshape(B, L, H, D).transpose(1, 2)

    def precompute_kv(self, kv):
        """Cross-attention K/V of a fixed memory (the encoder output),
        once per sequence instead of once per step."""
        return self._heads_of(self.k_proj, kv), self._heads_of(self.v_proj, kv)

    def attend_cached(self, x, k_cache, v_cache, mask):
        """One-token attention over cached K/V: x (B,1,E); caches
        (B,H,Lc,D); mask (B,Lc) True where attendable. float32 scores,
        as the JAX package's einsum."""
        o = _attend(self._heads_of(self.q_proj, x), k_cache, v_cache,
                    mask[:, None, None, :])
        return self.out_proj(o)

    def self_step(self, x, k_cache, v_cache, t):
        """Write this token's K/V at position t (in place), attend over
        positions <= t. Returns (out (B,1,E), k_cache, v_cache)."""
        o, k_cache, v_cache = cached_self_attention_step(
            self._heads_of(self.q_proj, x), self._heads_of(self.k_proj, x),
            self._heads_of(self.v_proj, x), k_cache, v_cache, t)
        return self.out_proj(o), k_cache, v_cache


class TransformerLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 is_decoder=False, dtype="float32"):
        super().__init__()
        self._is_decoder = is_decoder
        self.self_attn = MultiHeadAttention(units, num_heads, dtype)
        self.self_ln = nn.LayerNorm(in_channels=units)
        if is_decoder:
            self.cross_attn = MultiHeadAttention(units, num_heads, dtype)
            self.cross_ln = nn.LayerNorm(in_channels=units)
        self.ffn_in = nn.Dense(hidden_size, in_units=units, flatten=False,
                               dtype=dtype, weight_initializer="xavier")
        self.ffn_out = nn.Dense(units, in_units=hidden_size, flatten=False,
                                dtype=dtype, weight_initializer="xavier")
        self.ffn_ln = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def _ffn(self, x):
        return self.ffn_out(torch.relu(self.ffn_in(x)))

    def forward(self, x, enc_out=None, self_mask=None, enc_mask=None):
        h = self.self_attn(x, x, mask=self_mask, causal=self._is_decoder)
        if self.dropout:
            h = self.dropout(h)
        x = self.self_ln(x + h)
        if self._is_decoder and enc_out is not None:
            h = self.cross_attn(x, enc_out, mask=enc_mask)
            if self.dropout:
                h = self.dropout(h)
            x = self.cross_ln(x + h)
        h = self._ffn(x)
        if self.dropout:
            h = self.dropout(h)
        return self.ffn_ln(x + h)

    def step(self, x, k_cache, v_cache, t, enc_k, enc_v, enc_mask):
        """One-token decoder step against this layer's KV cache
        (inference: no dropout). Returns (y (B,1,E), k_cache, v_cache)."""
        h, k_cache, v_cache = self.self_attn.self_step(x, k_cache, v_cache, t)
        x = self.self_ln(x + h)
        x = self.cross_ln(x + self.cross_attn.attend_cached(x, enc_k, enc_v,
                                                            enc_mask))
        return self.ffn_ln(x + self._ffn(x)), k_cache, v_cache


class TransformerNMT(HybridBlock):
    """Encoder-decoder for translation. forward() = teacher-forced
    training scores; `greedy_decode` / `beam_search` for inference."""

    def __init__(self, src_vocab, tgt_vocab, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, max_length=256, dropout=0.1,
                 dtype="float32", device=None):
        super().__init__()
        self._units = units
        self._max_length = max_length
        with context.resolve(device):
            self.src_embed = nn.Embedding(src_vocab, units, dtype=dtype,
                                          weight_initializer="xavier")
            self.tgt_embed = nn.Embedding(tgt_vocab, units, dtype=dtype,
                                          weight_initializer="xavier")
            self.pos_enc = Constant("pos_enc",
                                    _positional_encoding(max_length, units))
            self.encoder = nn.HybridSequential()
            for _ in range(num_layers):
                self.encoder.add(TransformerLayer(units, hidden_size,
                                                  num_heads, dropout, False,
                                                  dtype))
            self.decoder = nn.HybridSequential()
            for _ in range(num_layers):
                self.decoder.add(TransformerLayer(units, hidden_size,
                                                  num_heads, dropout, True,
                                                  dtype))
            self.out_proj = nn.Dense(tgt_vocab, in_units=units,
                                     flatten=False, dtype=dtype,
                                     weight_initializer="xavier")

    @property
    def device(self):
        return self.src_embed.weight.device

    def _scaled(self, x):
        """x · sqrt(units), the scale rounded to x's dtype first (jnp's
        weak-typed scalar)."""
        return x * nn_ops.weak_scalar(self._units ** 0.5, x.dtype)

    def _embed(self, embed, tokens):
        x = self._scaled(embed(tokens))
        return x + self.pos_enc[:tokens.shape[1]][None]

    def encode(self, src_tokens, src_valid=None):
        """(encoder output (B, Ls, E), mask (B, Ls) bool or None)."""
        x = self._embed(self.src_embed, src_tokens)
        mask = None
        if src_valid is not None:
            L = src_tokens.shape[1]
            mask = torch.arange(L, device=x.device)[None, :] \
                < src_valid.to(x.device).to(torch.int32)[:, None]
        for layer in self.encoder:
            x = layer(x, self_mask=mask)
        return x, mask

    def forward(self, src_tokens, tgt_tokens, src_valid=None):
        enc_out, enc_mask = self.encode(src_tokens, src_valid)
        y = self._embed(self.tgt_embed, tgt_tokens)
        for layer in self.decoder:
            y = layer(y, enc_out=enc_out, enc_mask=enc_mask)
        return self.out_proj(y)

    # -- inference ---------------------------------------------------------
    def decode_step(self, tok, t, enc_mask, self_k, self_v, enc_k, enc_v):
        """One incremental decode step at position t (int) for every row:
        tok (B,) int. Returns (logits (B,V), self_k, self_v), the caches
        written in place."""
        x = self._scaled(self.tgt_embed(tok.reshape(-1, 1)))
        x = x + self.pos_enc[t][None, None]
        for i, layer in enumerate(self.decoder):
            x, _, _ = layer.step(x, self_k[i], self_v[i], t, enc_k[i],
                                 enc_v[i], enc_mask)
        return self.out_proj(x).reshape(tok.shape[0], -1), self_k, self_v

    def _init_decode(self, src_tokens, src_valid, beam, max_len):
        """Encode once, compute every decoder layer's cross K/V (tiled
        over the beams), allocate the zeroed self caches (B·beam, H,
        max_len, D). Returns (enc_mask, enc_k, enc_v, self_k, self_v)."""
        B, Ls = src_tokens.shape
        enc_out, enc_mask = self.encode(src_tokens, src_valid)
        if enc_mask is None:
            enc_mask = torch.ones((B, Ls), dtype=torch.bool,
                                  device=enc_out.device)
        enc_mask = enc_mask.repeat_interleave(beam, dim=0)
        enc_k, enc_v = [], []
        for layer in self.decoder:
            k, v = layer.cross_attn.precompute_kv(enc_out)
            enc_k.append(k.repeat_interleave(beam, dim=0).contiguous())
            enc_v.append(v.repeat_interleave(beam, dim=0).contiguous())
        H = self.decoder[0].self_attn._heads
        shape = (B * beam, H, max_len, self._units // H)
        self_k = [torch.zeros(shape, dtype=enc_k[0].dtype,
                              device=enc_out.device) for _ in self.decoder]
        self_v = [torch.zeros_like(k) for k in self_k]
        return enc_mask, enc_k, enc_v, self_k, self_v

    def _decode_inputs(self, src_tokens, src_valid):
        dev = self.device
        src = _tensor(src_tokens, dev)
        return src, None if src_valid is None else _tensor(src_valid, dev)

    @torch.no_grad()
    def greedy_decode(self, src_tokens, bos=1, eos=2, max_len=None,
                      src_valid=None):
        """KV-cache greedy decode: one encoder pass and one step per
        emitted token. Returns (B, <= max_len) numpy int32 sequences,
        starting with bos; a row that emitted eos keeps emitting eos."""
        src, valid = self._decode_inputs(src_tokens, src_valid)
        max_len = max_len or min(self._max_length, 2 * src.shape[1] + 8)
        B = src.shape[0]
        enc_mask, enc_k, enc_v, self_k, self_v = self._init_decode(
            src, valid, 1, max_len)
        tgt = np.full((B, 1), bos, np.int32)
        finished = np.zeros(B, bool)
        cur = torch.full((B,), bos, dtype=torch.int32, device=self.device)
        for t in range(max_len - 1):
            logits, self_k, self_v = self.decode_step(
                cur, t, enc_mask, self_k, self_v, enc_k, enc_v)
            nxt = logits.argmax(-1).cpu().numpy()
            nxt = np.where(finished, eos, nxt)
            finished |= nxt == eos
            tgt = np.concatenate([tgt, nxt[:, None].astype(np.int32)], axis=1)
            if finished.all():
                break
            cur = torch.from_numpy(tgt[:, -1].copy()).to(self.device)
        return tgt

    @torch.no_grad()
    def beam_search(self, src_tokens, beam=4, bos=1, eos=2, max_len=None,
                    src_valid=None, alpha=0.6, return_scores=False):
        """Beam search with KV-cache incremental decode and Sockeye/GNMT
        length normalisation lp(l) = ((5+l)/6)^alpha. Returns (B,
        <= max_len) int32 sequences (the best beam per row), or (seqs,
        scores)."""
        src, valid = self._decode_inputs(src_tokens, src_valid)
        max_len = max_len or min(self._max_length, 2 * src.shape[1] + 8)
        B = src.shape[0]
        enc_mask, enc_k, enc_v, self_k, self_v = self._init_decode(
            src, valid, beam, max_len)
        state = {"k": self_k, "v": self_v}
        dev = self.device

        def dev_step(tok, t):
            logits, _, _ = self.decode_step(
                torch.from_numpy(np.asarray(tok, np.int32)).to(dev), t,
                enc_mask, state["k"], state["v"], enc_k, enc_v)
            return logits.float().cpu().numpy()

        def reorder(gather):
            g = torch.from_numpy(gather).to(dev)
            state["k"] = [c.index_select(0, g) for c in state["k"]]
            state["v"] = [c.index_select(0, g) for c in state["v"]]

        logits0 = dev_step(np.full((B * beam,), bos, np.int32), 0)
        out, scores = beam_search_loop(
            logits0, lambda tok, i: dev_step(tok, i + 1), reorder,
            B, beam, eos, max_len - 1, alpha=alpha,
            seqs0=np.full((B, beam, 1), bos, np.int32))
        if return_scores:
            return out, scores
        return out


def label_smoothing_loss(logits, labels, smoothing=0.1, pad_id=0):
    """Sockeye-style smoothed cross entropy in float32, the mean over the
    positions whose label is not `pad_id`. NDArray inputs give an
    NDArray loss."""
    nd_in = isinstance(logits, NDArray)
    if nd_in:
        logits = logits._t
    if isinstance(labels, NDArray):
        labels = labels._t
    logp = torch.log_softmax(logits.float(), -1)
    lbl = labels.to(torch.int64)
    nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    uniform = -logp.mean(-1)
    loss = (1 - smoothing) * nll + smoothing * uniform
    keep = (lbl != pad_id).float()
    out = (loss * keep).sum() / torch.clamp(keep.sum(), min=1.0)
    return NDArray(out) if nd_in else out
