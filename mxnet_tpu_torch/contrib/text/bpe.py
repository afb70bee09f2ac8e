"""Byte-level BPE tokenization (reference: gluonnlp's GPT-2 BPE vocab
support in the text_generation scripts; upstream algorithm per Sennrich
et al. 2016 subword-nmt and the byte-level variant GPT-2 popularized).

Zero-egress: no pretrained merge table ships, so `learn_bpe` trains one
from any in-memory corpus and `BPETokenizer` encodes/decodes with it.
Byte-level means ANY unicode text round-trips exactly — unknown symbols
cannot occur (the base alphabet is all 256 bytes).

Pre-tokenization approximates the GPT-2 regex with python-`re`-expressible
classes (contractions, unicode letter runs, digit runs, other-symbol runs,
each optionally space-prefixed); the deviation only affects merge
granularity, never reversibility.
"""
from __future__ import annotations

import json
import re
from collections import Counter

__all__ = ["learn_bpe", "BPETokenizer"]

# every byte must map to a PRINTABLE unicode char so merge tables stay
# readable/serializable: printable latin bytes map to themselves, the
# rest shift into the 256+ plane (the standard byte-level BPE alphabet)
def _byte_alphabet():
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    table = {}
    bump = 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + bump)
            bump += 1
    return table


_B2U = _byte_alphabet()
_U2B = {u: b for b, u in _B2U.items()}

_PRETOK = re.compile(
    r"'(?:s|t|re|ve|m|ll|d)| ?[^\W\d_]+| ?\d+| ?(?:_|[^\s\w])+"
    r"|\s+(?!\S)|\s+")   # `_` is \w but not a letter: bucket with symbols


def _pre_tokenize(text):
    return _PRETOK.findall(text)


def _to_symbols(word):
    return tuple(_B2U[b] for b in word.encode("utf-8"))


def _merge_word(sym, pair, joined):
    out = []
    i = 0
    while i < len(sym):
        if i + 1 < len(sym) and sym[i] == pair[0] and sym[i + 1] == pair[1]:
            out.append(joined)
            i += 2
        else:
            out.append(sym[i])
            i += 1
    return tuple(out)


def learn_bpe(texts, num_merges):
    """Learn `num_merges` byte-level BPE merges from an iterable of
    strings. Returns a merge list (pairs of symbol strings, highest
    priority first) for BPETokenizer. Deterministic: frequency ties break
    lexicographically.

    Incremental formulation (subword-nmt style): each merge re-scans only
    the words CONTAINING the merged pair, not the whole corpus — a 32k
    table over ~100k word types is minutes, not hours."""
    word_freq = Counter()
    for t in texts:
        for w in _pre_tokenize(t):
            word_freq[_to_symbols(w)] += 1

    pair_count = Counter()
    pair_words = {}                        # pair -> set of words holding it
    for w, f in word_freq.items():
        for p in zip(w, w[1:]):
            pair_count[p] += f
            pair_words.setdefault(p, set()).add(w)

    merges = []
    for _ in range(int(num_merges)):
        pair_count = +pair_count           # drop <=0 entries
        if not pair_count:
            break
        best = min(pair_count.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        merges.append(best)
        joined = best[0] + best[1]
        for w in list(pair_words.get(best, ())):
            f = word_freq.pop(w, 0)
            if not f:
                continue
            for p in zip(w, w[1:]):
                pair_count[p] -= f
                s = pair_words.get(p)
                if s is not None:
                    s.discard(w)
            nw = _merge_word(w, best, joined)
            word_freq[nw] += f
            for p in zip(nw, nw[1:]):
                pair_count[p] += f
                pair_words.setdefault(p, set()).add(nw)
    return merges


class BPETokenizer:
    """Encode/decode with a learned merge table.

    ids 0..255 are the byte alphabet (in byte order); merge k gets id
    256+k; special tokens (e.g. an eos marker for `GPTForCausalLM.
    generate`) append after. decode(encode(s)) == s for ANY string."""

    def __init__(self, merges, special_tokens=()):
        self.merges = [tuple(m) for m in merges]
        self.ranks = {m: i for i, m in enumerate(self.merges)}
        self.token_to_idx = {}
        self.idx_to_token = []
        # two merges CAN concatenate to the same string (('a','bc') and
        # ('ab','c')): keep one id per distinct string so len() is the
        # usable vocab and no embedding row is unreachable
        for s in [_B2U[b] for b in range(256)] + \
                 [a + b for a, b in self.merges]:
            if s not in self.token_to_idx:
                self.token_to_idx[s] = len(self.idx_to_token)
                self.idx_to_token.append(s)
        self.special_tokens = {}
        for s in special_tokens:
            if s in self.token_to_idx:
                # overwriting would make that text encode to a special id
                # that decode drops — silent data loss
                raise ValueError(
                    f"special token {s!r} collides with an existing "
                    "symbol/merge string")
            self.special_tokens[s] = len(self.idx_to_token)
            self.token_to_idx[s] = len(self.idx_to_token)
            self.idx_to_token.append(s)
        self._cache = {}

    def __len__(self):
        return len(self.idx_to_token)

    def _bpe(self, word):
        got = self._cache.get(word)
        if got is not None:
            return got
        sym = _to_symbols(word)
        while len(sym) > 1:
            ranked = [(self.ranks[p], p) for p in zip(sym, sym[1:])
                      if p in self.ranks]
            if not ranked:
                break
            _, pair = min(ranked)
            sym = _merge_word(sym, pair, pair[0] + pair[1])
        self._cache[word] = sym
        return sym

    def encode(self, text):
        """text -> list of int ids."""
        ids = []
        for w in _pre_tokenize(text):
            ids.extend(self.token_to_idx[s] for s in self._bpe(w))
        return ids

    def decode(self, ids):
        """ids -> text (special tokens are dropped)."""
        n_spec = len(self.special_tokens)
        base = len(self.idx_to_token) - n_spec
        # 0 <= guard: a negative id (e.g. -1 padding) would python-wrap
        # to the END of idx_to_token and leak special-token text
        text = "".join(self.idx_to_token[i] for i in ids if 0 <= i < base)
        data = bytes(_U2B[u] for u in text)
        return data.decode("utf-8", errors="replace")

    # -- persistence ------------------------------------------------------
    def save(self, path):
        with open(path, "w", encoding="utf8") as f:
            json.dump({"merges": [list(m) for m in self.merges],
                       "special_tokens": list(self.special_tokens)}, f,
                      ensure_ascii=False)

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf8") as f:
            d = json.load(f)
        return cls(d["merges"], special_tokens=d.get("special_tokens", ()))
