"""Tokenizers for BERT-style pipelines (reference: gluonnlp
BERTBasicTokenizer + BERTTokenizer — whitespace/punctuation splitting and
greedy longest-match-first WordPiece).

Pure python, no downloads: build the vocab from any source (a
`text.vocab.Vocabulary`, a token->id dict, or a plain wordpiece vocab
file with one token per line)."""
from __future__ import annotations

import unicodedata

__all__ = ["BasicTokenizer", "WordpieceTokenizer", "BERTTokenizer"]


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp):
    """CJK codepoint ranges from the reference tokenizer — these are
    tokenized character-by-character (no whitespace between words)."""
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """Whitespace split + punctuation split + optional lowercasing/accent
    stripping (reference BERTBasicTokenizer)."""

    def __init__(self, lower=True):
        self.lower = lower

    def __call__(self, text):
        text = "".join(" " if _is_whitespace(c) else c
                       for c in text if not _is_control(c))
        # space out CJK characters so they wordpiece individually
        # (reference _tokenize_chinese_chars)
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        tokens = []
        for tok in text.split():
            if self.lower:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _split_punct(tok):
        out, cur = [], []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out


class WordpieceTokenizer:
    """Greedy longest-match-first subword split (reference
    BERTTokenizer's wordpiece stage): unknown pieces map to `unknown_token`,
    continuations get the '##' prefix."""

    def __init__(self, vocab, unknown_token="[UNK]", max_input_chars=200):
        self.vocab = set(vocab)  # dict iteration yields keys
        self.unknown_token = unknown_token
        self.max_input_chars = max_input_chars

    def __call__(self, token):
        if len(token) > self.max_input_chars:
            return [self.unknown_token]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unknown_token]
            pieces.append(piece)
            start = end
        return pieces


class BERTTokenizer:
    """basic + wordpiece composition with id conversion (reference
    gluonnlp BERTTokenizer).

    vocab: a `text.vocab.Vocabulary`, a token->id dict, or a path to a
    wordpiece vocab file (one token per line, line number = id)."""

    def __init__(self, vocab, lower=True, unknown_token="[UNK]"):
        if isinstance(vocab, str):
            with open(vocab, encoding="utf8") as f:
                vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        if hasattr(vocab, "token_to_idx"):
            vocab = dict(vocab.token_to_idx)
        self.token_to_idx = vocab
        self.unknown_token = unknown_token
        self.basic = BasicTokenizer(lower=lower)
        self.wordpiece = WordpieceTokenizer(vocab, unknown_token)

    def __call__(self, text):
        out = []
        for tok in self.basic(text):
            out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens):
        unk = self.token_to_idx.get(self.unknown_token, 0)
        return [self.token_to_idx.get(t, unk) for t in tokens]

    def encode(self, text_a, text_b=None, max_length=None,
               cls_token="[CLS]", sep_token="[SEP]", pad_token="[PAD]"):
        """Full BERT input build: [CLS] a [SEP] (b [SEP]), token_type ids,
        valid_length, padded to max_length when given. Over-long inputs
        truncate the TEXT (longest segment first, the reference's
        _truncate_seq_pair rule) so the terminal [SEP] of each segment is
        always present. Returns (input_ids, token_types, valid_length)."""
        a = self(text_a)
        b = self(text_b) if text_b is not None else []
        if max_length is not None:
            budget = max_length - (3 if b else 2)  # [CLS] + [SEP](s)
            budget = max(budget, 0)
            while len(a) + len(b) > budget:
                (a if len(a) >= len(b) else b).pop()
        tokens = [cls_token] + a + [sep_token]
        types = [0] * len(tokens)
        if b:
            tokens += b + [sep_token]
            types += [1] * (len(b) + 1)
        ids = self.convert_tokens_to_ids(tokens)
        valid = len(ids)
        if max_length is not None and valid < max_length:
            pad = self.token_to_idx.get(pad_token, 0)
            ids += [pad] * (max_length - valid)
            types += [0] * (max_length - valid)
        return ids, types, valid
