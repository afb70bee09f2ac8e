"""Vocabulary for text token indexing (reference:
python/mxnet/contrib/text/vocab.py `Vocabulary`).

Indexing contract (matching the reference): index 0 is the unknown token
`<unk>`; `reserved_tokens` follow; then corpus tokens by descending
frequency (ties broken alphabetically), filtered by `most_freq_count` /
`min_freq`."""
from __future__ import annotations


class Vocabulary:
    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        if reserved_tokens is not None:
            rset = set(reserved_tokens)
            if len(rset) != len(reserved_tokens):
                raise ValueError("reserved_tokens must not be duplicated")
            if unknown_token in rset:
                raise ValueError(
                    "unknown_token must not appear in reserved_tokens")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) if reserved_tokens \
            else None
        self._idx_to_token = [unknown_token] + (list(reserved_tokens)
                                               if reserved_tokens else [])
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        exclude = set(self._idx_to_token)
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = 0
        for token, freq in pairs:
            if freq < min_freq:
                break
            if most_freq_count is not None and kept >= most_freq_count:
                break
            if token in exclude:
                continue
            self._idx_to_token.append(token)
            kept += 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index(es); unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"token index {i} out of range")
            out.append(self._idx_to_token[i])
        return out[0] if single else out
