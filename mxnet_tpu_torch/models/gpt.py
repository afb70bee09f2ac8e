"""GPT-2-style decoder-only causal language model (counterpart of
`mxnet_tpu/models/gpt.py`).

Pre-LN blocks over the fused-QKV attention of `bert.BERTAttention`
with `causal=True`; the LM head ties the token embedding. Training runs
`forward` in training mode (dropout on the embeddings and after
attention and the MLP; the causal flash kernels forward and backward)
under `parallel.ShardedTrainer` with `gpt_lm_loss`. The decode surface
the server drives is the JAX package's: `decode_step_slots` (dense
per-slot caches), `decode_paged_chunk` (block-table pages) and
`decode_paged_draft` (a drafter's greedy chain for speculative serving),
plus `generate`, whose prompt prefill is one causal flash pass, greedy,
sampled or by beam search (`num_beams`). A model whose
Dense layers `contrib.quantization.quantize_block` swapped for int8 runs
the same decode surface.

The block stack of a training forward runs under the remat policy
(`Block.remat`, the `remat_policy` knob, or the config's `remat`: True
is "layers"), each policy on `torch.utils.checkpoint` with the random
streams replayed, as BERT's encoder layers do (`_remat.stack_call`).

Differences from the JAX package, all of them idiom: PyTorch runs
eagerly, so there is no jit cache, `lax.scan` is a Python loop and
caches are updated in place (see `_decode`); the configs' `scan_layers`
flag is a compile-time choice that the port accepts as a no-op;
sequence parallelism is not in the port.
"""
import numpy as np
import torch

from .. import context
from ..cuda_ops.flash_attention import flash_attention
from ..gluon import HybridBlock, nn
from ..gluon.parameter import Parameter
from ..ndarray.ndarray import _unwrap
from ..ops import nn_ops
from ._decode import (batched_cached_attention_step, beam_search_loop,
                      cached_self_attention_step, paged_attention_step)
from .. import memsafe as _memsafe
from ._remat import remat_policy, stack_call
from .bert import BERTAttention, _positions


def gpt2_117m_config(**overrides):
    cfg = dict(vocab_size=50257, units=768, hidden_size=3072, num_layers=12,
               num_heads=12, max_length=1024, dropout=0.1, attn_dropout=0.0,
               seq_parallel=False, dtype="float32", remat=False,
               scan_layers=False)
    cfg.update(overrides)
    return cfg


def gpt2_345m_config(**overrides):
    cfg = gpt2_117m_config(units=1024, hidden_size=4096, num_layers=24,
                           num_heads=16, remat=True, scan_layers=True)
    cfg.update(overrides)
    return cfg


def gpt_long_config(**overrides):
    cfg = gpt2_117m_config(max_length=8192, seq_parallel=True, remat=True,
                           scan_layers=True)
    cfg.update(overrides)
    return cfg


def gpt_tiny_config(**overrides):
    cfg = gpt2_117m_config(vocab_size=128, units=64, hidden_size=128,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    cfg.update(overrides)
    return cfg


class GPTBlock(HybridBlock):
    """Pre-LN decoder block (LN -> attn -> dropout -> +res, LN -> MLP ->
    dropout -> +res); dropout is active in training mode only."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32", attn_dropout=0.0):
        super().__init__()
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.attn = BERTAttention(units, num_heads, attn_dropout, dtype,
                                  causal=True)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.ffn_in = nn.Dense(hidden_size, in_units=units, flatten=False,
                               dtype=dtype, weight_initializer="xavier")
        self.ffn_out = nn.Dense(units, in_units=hidden_size, flatten=False,
                                dtype=dtype, weight_initializer="xavier")
        self.dropout = nn.Dropout(dropout) if dropout else None

    def _mlp(self, x):
        return self.ffn_out(nn_ops.gelu(self.ffn_in(self.ln2(x))))

    def _split(self, x):
        """ln1 + fused QKV projection, split into contiguous (B,H,L,D)
        q, k, v."""
        return nn_ops.split_heads(self.attn.qkv(self.ln1(x)),
                                  self.attn._num_heads)

    def forward(self, x, mask=None):
        a = self.attn(self.ln1(x), mask)
        if self.dropout:
            a = self.dropout(a)
        x = x + a
        h = self._mlp(x)
        if self.dropout:
            h = self.dropout(h)
        return x + h

    def prefill(self, x, k_cache, v_cache):
        """Full-prompt forward that also writes K/V[0:Lp] into the caches
        (in place): one causal flash pass instead of Lp one-token steps.
        x (B, Lp, E); caches (B,H,Lmax,D). Returns (y, k_cache, v_cache)."""
        q, k, v = self._split(x)
        B, H, Lp, D = q.shape
        k_cache[:, :, :Lp] = k.to(k_cache.dtype)
        v_cache[:, :, :Lp] = v.to(v_cache.dtype)
        o = flash_attention(q, k, v, None, causal=True)      # (B,H,Lp,D)
        x = x + self.attn.proj(o.transpose(1, 2).reshape(B, Lp, H * D))
        return x + self._mlp(x), k_cache, v_cache

    def step(self, x, k_cache, v_cache, t):
        """One-token step at position t (int) for every row; x (B,1,E)."""
        q, k, v = self._split(x)
        o, k_cache, v_cache = cached_self_attention_step(
            q, k, v, k_cache, v_cache, t)
        x = x + self.attn.proj(o)
        return x + self._mlp(x), k_cache, v_cache

    def step_slots(self, x, k_cache, v_cache, t):
        """`step` with PER-SLOT positions t (B,): each row is an
        independent request at its own position."""
        q, k, v = self._split(x)
        o, k_cache, v_cache = batched_cached_attention_step(
            q, k, v, k_cache, v_cache, t)
        x = x + self.attn.proj(o)
        return x + self._mlp(x), k_cache, v_cache

    def step_slots_paged(self, x, k_pages, v_pages, tables, wp, wo, t):
        """`step_slots` against a block-table cache: the K/V write lands
        in page wp[b] offset wo[b]; attention reads through tables
        (B,n_pg). Everything around the cache access is `step_slots`."""
        q, k, v = self._split(x)
        o, k_pages, v_pages = paged_attention_step(
            q, k, v, k_pages, v_pages, tables, wp, wo, t)
        x = x + self.attn.proj(o)
        return x + self._mlp(x), k_pages, v_pages


class GPTModel(HybridBlock):
    """Token + position embeddings -> pre-LN block stack -> final LN.
    Returns hidden states (B, L, E)."""

    # remat policies route here (`Block.remat`, the `remat_policy` knob):
    # the layer stack checkpoints per layer, not the whole block
    _remat_handles_policy = True

    def __init__(self, vocab_size, units, hidden_size, num_layers, num_heads,
                 max_length=1024, dropout=0.1, attn_dropout=0.0,
                 seq_parallel=False, dtype="float32", remat=False,
                 scan_layers=False):
        super().__init__()
        if seq_parallel:
            raise NotImplementedError(
                "sequence parallelism is not in the port's serving slice")
        self._remat = remat_policy(remat)
        self.word_embed = nn.Embedding(vocab_size, units, dtype=dtype,
                                       weight_initializer="xavier")
        self.position_embed = Parameter("position_weight",
                                        (max_length, units), dtype, "xavier")
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(GPTBlock(units, hidden_size, num_heads, dropout,
                                     dtype, attn_dropout=attn_dropout))
        self.ln_f = nn.LayerNorm(in_channels=units)

    def forward(self, inputs, valid_length=None):
        B, L = inputs.shape
        x = self.word_embed(inputs) \
            + _positions(self.position_embed, L)[None]
        if self.embed_dropout:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            mask = torch.arange(L, device=x.device)[None, :] \
                < valid_length.to(x.device).long()[:, None]
        x = stack_call(self.layers, x, mask, _memsafe.effective_policy(
            self._remat_policy, self._remat))
        return self.ln_f(x)


class GPTForCausalLM(HybridBlock):
    """Hidden states -> tied-embedding logits (B, L, V).

    `device=None` builds the parameters on the card (raising when there
    is none); pass `device="cpu"` to build them on the CPU."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        with context.resolve(device):
            self.gpt = GPTModel(**cfg)

    @property
    def device(self):
        return self.gpt.word_embed.weight.device

    def _logits(self, h):
        return torch.matmul(h, self.gpt.word_embed.weight.t().to(h.dtype))

    def _pos_embed(self, pos):
        """Position-embedding rows at pos, clamped to the table as the
        JAX package's gather clamps: a chunk round steps a row C times
        whatever its count, so a masked step may pass max_length - 1.
        Its logits are discarded."""
        pe = self.gpt.position_embed
        return pe[pos.clamp(max=pe.shape[0] - 1)]

    def forward(self, inputs, valid_length=None):
        return self._logits(self.gpt(inputs, valid_length))

    # -- incremental generation (dense KV cache) --------------------------
    def decode_step(self, tok, t, self_k, self_v):
        """One step at position t (int) for every row: tok (B,) int.
        Returns (logits (B,V), self_k, self_v), caches updated in place."""
        g = self.gpt
        x = g.word_embed(tok.reshape(-1, 1)) + g.position_embed[t][None, None]
        for i, layer in enumerate(g.layers):
            x, _, _ = layer.step(x, self_k[i], self_v[i], t)
        logits = self._logits(g.ln_f(x))
        return logits.reshape(tok.shape[0], -1), self_k, self_v

    def decode_step_slots(self, tok, t, self_k, self_v):
        """`decode_step` with PER-SLOT positions t (B,) int: row b is an
        independent request at position t[b] (the server's dense decode).
        Returns (logits (B,V), self_k, self_v)."""
        g = self.gpt
        x = g.word_embed(tok.reshape(-1, 1)) + self._pos_embed(t)[:, None, :]
        for i, layer in enumerate(g.layers):
            x, _, _ = layer.step_slots(x, self_k[i], self_v[i], t)
        logits = self._logits(g.ln_f(x))
        return logits.reshape(tok.shape[0], -1), self_k, self_v

    # -- paged decode (block-table cache) ---------------------------------
    def _paged_token_step(self, tok, pos, tables, wp, wo, ks, vs):
        """One-token paged step: the `decode_step_slots` computation with
        the layers' cache access routed through `step_slots_paged`; ks/vs
        are the pooled (P,H,ps,D) page arrays per layer, written in
        place. Returns float32 logits (B,V)."""
        g = self.gpt
        x = g.word_embed(tok.reshape(-1, 1)) \
            + self._pos_embed(pos)[:, None, :]
        for i, layer in enumerate(g.layers):
            x, _, _ = layer.step_slots_paged(x, ks[i], vs[i], tables, wp,
                                             wo, pos)
        logits = self._logits(g.ln_f(x))
        return logits.reshape(tok.shape[0], -1).float()

    @staticmethod
    def _paged_write_targets(pos, active, tables, page_size):
        """Write page/offset for one chunk step: active rows write page
        tables[b, pos//ps] at offset pos%ps; masked rows (and positions
        past the table) write their private scratch page (page id ==
        batch row — the pool reserves pages 0..slots-1), so a batched
        step never scatters two rows into one cell and never pollutes a
        real page of an inactive request."""
        B, n_pg = tables.shape
        idx = torch.clamp(pos // page_size, 0, n_pg - 1)
        real = torch.gather(tables, 1, idx[:, None].long())[:, 0]
        scratch = torch.arange(B, dtype=torch.int32, device=pos.device)
        ok = active & (pos < n_pg * page_size)
        wp = torch.where(ok, real.to(torch.int32), scratch)
        wo = torch.where(ok, pos % page_size, 0).to(torch.int32)
        return wp, wo

    def decode_paged_chunk(self, toks, t0, n, tables, flat, page_size,
                           full=False):
        """Chunked paged decode: row b feeds its n[b] tokens toks[b, :n[b]]
        at positions t0[b].. — many prompt tokens per dispatch (batched
        prefill), one (steady decode), or a speculative round's k+1
        (`full`). C one-token steps, each exactly the `decode_step_slots`
        computation, so a chunk's logits equal feeding the same tokens one
        dispatch at a time. Rows past their count run masked into their
        scratch page; their logits are discarded.

        toks (B,C) int32; t0/n (B,) int32; tables (B,n_pg) int32; flat =
        2*n_l pooled page arrays (K per layer, then V), written in place.
        Returns (float32 logits (B,V) of each row's last active token —
        or, with `full`, every step's float32 logits stacked (B,C,V), the
        speculative verify surface — and flat)."""
        n_l = len(self.gpt.layers)
        ks, vs = flat[:n_l], flat[n_l:]
        B, C = toks.shape
        last, stack = None, []
        for j in range(C):
            pos = t0 + j
            wp, wo = self._paged_write_targets(pos, j < n, tables, page_size)
            lg = self._paged_token_step(toks[:, j], pos, tables, wp, wo,
                                        ks, vs)
            if full:
                stack.append(lg)
            else:
                last = lg if last is None else torch.where(
                    (n - 1 == j)[:, None], lg, last)
        return (torch.stack(stack, dim=1) if full else last), flat

    def decode_paged_draft(self, tok0, t0, active, tables, flat, page_size,
                           n_draft):
        """Greedy draft chain (on the DRAFTER model): feed tok0[b] at
        position t0[b], take the argmax as the next token, repeat —
        n_draft proposals in one call, the argmax on the device. The
        drafter writes its own pooled page arrays (`flat`, the pool's
        'draft' stream) through the SAME page tables as the target, so a
        prefix-tree hit skips drafter prefill too. Inactive rows (active[b]
        False — not in a speculative round) run fully masked into scratch.

        tok0/t0 (B,) int32; active (B,) bool; tables (B,n_pg) int32.
        Returns (drafts (B, n_draft) int32, flat)."""
        n_l = len(self.gpt.layers)
        ks, vs = flat[:n_l], flat[n_l:]
        tok, drafts = tok0.to(torch.int32), []
        for i in range(n_draft):
            pos = t0 + i
            wp, wo = self._paged_write_targets(pos, active, tables,
                                               page_size)
            lg = self._paged_token_step(tok, pos, tables, wp, wo, ks, vs)
            tok = lg.argmax(-1).to(torch.int32)
            drafts.append(tok)
        return torch.stack(drafts, dim=1), flat

    def _alloc_caches(self, B, max_len):
        """Zeroed per-layer K+V caches (B, H, max_len, D), 2*n_l of them."""
        g = self.gpt
        H = g.layers[0].attn._num_heads
        D = g.word_embed.weight.shape[1] // H
        dt = g.word_embed.weight.dtype
        return [torch.zeros((B, H, max_len, D), dtype=dt, device=self.device)
                for _ in range(2 * len(g.layers))]

    def _prefill_body(self, prompt, lp, flat):
        """Batched prefill: embed + per-layer flash pass writing
        K/V[0:Lp] in place; returns (float32 logits at the last REAL
        prompt position lp-1 (B, V), ks, vs)."""
        g = self.gpt
        n_l = len(g.layers)
        x = g.word_embed(prompt) + g.position_embed[:prompt.shape[1]][None]
        ks, vs = list(flat[:n_l]), list(flat[n_l:])
        for i, layer in enumerate(g.layers):
            x, _, _ = layer.prefill(x, ks[i], vs[i])
        h_last = g.ln_f(x)[:, lp - 1]
        return self._logits(h_last).float(), ks, vs

    @staticmethod
    def _prompt_bucket(Lp, max_len):
        """The 16*2^k length a prompt right-pads to for its prefill."""
        Lp_b = 16
        while Lp_b < Lp:
            Lp_b *= 2
        return min(Lp_b, max_len - 1)

    def _generate_beam(self, prompt, max_new, eos, num_beams, alpha,
                       max_len, return_scores):
        """Beam search over the dense cache: ONE batched flash prefill at
        batch B (beams are identical copies until the first expansion),
        the caches tiled beam-wise (row b*beam+j is beam j of batch b, the
        layout the reorder's gather indices expect), then one-token
        `decode_step`s with the host's top-k bookkeeping
        (`beam_search_loop`) and an `index_select` reorder of every
        cache. The JAX package's `_generate_beam`."""
        B, Lp = prompt.shape
        Lp_b = self._prompt_bucket(Lp, max_len)
        prompt_pad = np.concatenate(
            [prompt, np.zeros((B, Lp_b - Lp), np.int32)], axis=1)
        dev = self.device
        logits0, ks, vs = self._prefill_body(
            torch.from_numpy(prompt_pad).to(dev), Lp,
            self._alloc_caches(B, max_len))
        state = {"k": [c.repeat_interleave(num_beams, 0) for c in ks],
                 "v": [c.repeat_interleave(num_beams, 0) for c in vs]}
        del ks, vs
        logits0 = logits0.repeat_interleave(num_beams, 0).cpu().numpy()

        def dev_step(tok, t):
            logits, _, _ = self.decode_step(
                torch.from_numpy(np.asarray(tok, np.int32)).to(dev), t,
                state["k"], state["v"])
            return logits.float().cpu().numpy()

        def reorder(gather):
            g = torch.from_numpy(gather).to(dev)
            state["k"] = [c.index_select(0, g) for c in state["k"]]
            state["v"] = [c.index_select(0, g) for c in state["v"]]

        out, scores = beam_search_loop(
            logits0, lambda tok, i: dev_step(tok, Lp + i), reorder,
            B, num_beams, eos, max_new, alpha=alpha)
        return (out, scores) if return_scores else out

    @torch.no_grad()
    def generate(self, prompt, max_new_tokens=32, eos=None, temperature=0.0,
                 top_k=0, seed=0, num_beams=1, alpha=0.6,
                 return_scores=False):
        """Autoregressive generation from int prompt tokens (B, Lp):
        greedy at temperature 0, else softmax sampling at `temperature`
        (optionally truncated to the top_k logits) from a torch.Generator
        seeded with `seed` (a different stream from the JAX package's).
        The prompt right-pads to a 16*2^k bucket and prefills in one
        causal flash pass; generation then steps the dense cache. Returns
        (B, <= max_new_tokens) numpy int32 tokens (rows stop growing at
        `eos`).

        num_beams > 1 switches to beam search (requires `eos`; Sockeye
        length norm with `alpha`; `return_scores` adds per-batch
        scores)."""
        prompt = np.asarray(prompt, np.int32)
        B, Lp = prompt.shape
        need = Lp + max_new_tokens
        limit = self.gpt.position_embed.shape[0]
        if need > limit:
            raise ValueError(
                f"prompt {Lp} + max_new_tokens {max_new_tokens} exceeds "
                f"max_length {limit}")
        if Lp == 0 or max_new_tokens <= 0:
            return np.zeros((B, 0), np.int32)
        max_len = 16
        while max_len < need:
            max_len *= 2
        max_len = min(max_len, limit)
        if num_beams > 1:
            if eos is None:
                raise ValueError("beam search needs an `eos` id (scoring "
                                 "terminates beams on it)")
            if (temperature and temperature > 0.0) or top_k:
                raise ValueError("num_beams > 1 is deterministic beam "
                                 "search — temperature/top_k do not apply")
            return self._generate_beam(prompt, max_new_tokens, eos,
                                       num_beams, alpha, max_len,
                                       return_scores)
        Lp_b = self._prompt_bucket(Lp, max_len)
        prompt_pad = np.concatenate(
            [prompt, np.zeros((B, Lp_b - Lp), np.int32)], axis=1)
        dev = self.device
        logits, ks, vs = self._prefill_body(
            torch.from_numpy(prompt_pad).to(dev), Lp,
            self._alloc_caches(B, max_len))
        do_sample = bool(temperature and temperature > 0.0)
        gen = None
        if do_sample:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        out = []
        for i in range(max_new_tokens):
            lg = logits
            if do_sample:
                if top_k:
                    kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
                    lg = torch.where(lg < kth, -torch.inf, lg)
                probs = torch.softmax(lg / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = lg.argmax(-1)
            nxt = nxt.to(torch.int32)
            if eos is not None:
                nxt = torch.where(finished, int(eos), nxt).to(torch.int32)
                finished = finished | (nxt == eos)
            out.append(nxt)
            if i < max_new_tokens - 1:
                logits, ks, vs = self.decode_step(nxt, Lp + i, ks, vs)
                logits = logits.float()
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        if eos is not None:
            # trim trailing columns after every row finished (the step
            # where the last row emits eos is kept)
            allf = np.all(np.cumsum(toks == eos, axis=1) >= 1, axis=0)
            if allf.any():
                toks = toks[:, :int(np.argmax(allf)) + 1]
        return toks


def gpt_lm_loss(logits, labels, weights):
    """Next-token cross entropy: logits (B, L, V) at the input positions,
    labels (B, L) the NEXT token at each position (pre-shifted by the
    data pipeline), weights (B, L) 0/1. float32 log-softmax; the weighted
    mean over max(sum of weights, 1). Tensors, or NDArrays as
    `ShardedTrainer` gives them."""
    logits, labels, weights = map(_unwrap, (logits, labels, weights))
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_synthetic_batch(cfg, batch_size, seq_len, seed=0):
    """Tokens + pre-shifted next-token labels + weights, numpy (the JAX
    package's generator: the same arrays for the same seed)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg["vocab_size"],
                       (batch_size, seq_len + 1)).astype(np.int32)
    return {
        "input_ids": toks[:, :-1],
        "labels": toks[:, 1:],
        "weights": np.ones((batch_size, seq_len), np.float32),
        "valid_length": np.full((batch_size,), seq_len, np.int32),
    }
