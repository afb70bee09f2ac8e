"""Pretrained token embeddings (counterpart of
`mxnet_tpu/contrib/text/embedding.py`; reference:
python/mxnet/contrib/text/embedding.py — `register`/`create` registry,
`GloVe`, `FastText`, `CustomEmbedding`, `CompositeEmbedding`).

Zero-egress translation: the reference downloads pretrained archives from
s3; here every loader reads a LOCAL text file (`pretrained_file_path`) in
the standard GloVe/fastText format — one token per line followed by its
vector. The registry, the vocabulary-attachment flow, `get_vecs_by_tokens`,
and `update_token_vectors` keep the reference API. The vector table is an
NDArray on the current device (the entered context's, else the card);
a lookup gathers its rows there (`nd.take`)."""
from __future__ import annotations

import io
import os

import numpy as np

from ... import ndarray as nd_mod
from ...ndarray import NDArray
from .vocab import Vocabulary

nd = nd_mod

_REGISTRY = {}


def register(cls):
    """Register a TokenEmbedding subclass under its lowercase name
    (reference `text.embedding.register`)."""
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(embedding_name, **kwargs):
    """Instantiate a registered embedding by name (reference
    `text.embedding.create`)."""
    name = embedding_name.lower()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown embedding '{embedding_name}'; registered: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Names of pretrained files the reference ships per embedding. Under
    zero egress these are documentation only — pass the file you have via
    `pretrained_file_path`."""
    table = {c.__name__.lower(): list(c.pretrained_file_names)
             for c in _REGISTRY.values()}
    if embedding_name is not None:
        return table[embedding_name.lower()]
    return table


class _TokenEmbedding:
    """Base: loads `token v1 .. vD` lines; index 0 is `<unk>` mapped to
    `init_unknown_vec` (zeros by default, reference behavior)."""

    pretrained_file_names = ()

    def __init__(self, pretrained_file_path=None, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=None,
                 unknown_token="<unk>", vocabulary=None):
        self._unknown_token = unknown_token
        self._idx_to_token = [unknown_token]
        self._token_to_idx = {unknown_token: 0}
        self._idx_to_vec = None
        self._vec_len = None
        if pretrained_file_path is not None:
            self._load_embedding(pretrained_file_path, elem_delim, encoding,
                                 init_unknown_vec or np.zeros)
        if vocabulary is not None:
            if self._idx_to_vec is None:
                raise ValueError(
                    "attach a vocabulary only to a loaded embedding")
            self._build_for_vocabulary(vocabulary)

    # -- loading ----------------------------------------------------------
    def _load_embedding(self, path, elem_delim, encoding, init_unknown_vec):
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"pretrained embedding file '{path}' not found. The "
                "reference downloads these; this build is offline — supply "
                "a local GloVe/fastText-format file")
        vecs = []
        with io.open(path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if line_num == 0 and len(parts) == 2 \
                        and parts[0].isdigit() and parts[1].isdigit():
                    continue  # fastText header "N D"
                token, elems = parts[0], parts[1:]
                if not elems:
                    continue
                if self._vec_len is None:
                    self._vec_len = len(elems)
                elif len(elems) != self._vec_len:
                    raise ValueError(
                        f"line {line_num + 1}: vector length "
                        f"{len(elems)} != {self._vec_len}")
                if token in self._token_to_idx:
                    continue  # reference keeps the first occurrence
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                vecs.append(np.asarray(elems, np.float32))
        if self._vec_len is None:
            raise ValueError(f"no vectors found in '{path}'")
        unk = init_unknown_vec(shape=self._vec_len) \
            if _wants_shape_kw(init_unknown_vec) \
            else init_unknown_vec(self._vec_len)
        mat = np.vstack([np.asarray(unk, np.float32).reshape(1, -1)] + vecs)
        self._idx_to_vec = nd.array(mat)

    def _build_for_vocabulary(self, vocabulary):
        """Re-index to the vocabulary's token order (the reference flow when
        constructing with `vocabulary=`): tokens missing from the pretrained
        file get the unknown vector."""
        src_tok2idx = self._token_to_idx
        src = self._idx_to_vec.asnumpy()
        rows = [src[src_tok2idx.get(t, 0)] for t in vocabulary.idx_to_token]
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        self._idx_to_vec = nd.array(np.vstack(rows))

    # -- API --------------------------------------------------------------
    def __len__(self):
        return len(self._idx_to_token)

    @property
    def vec_len(self):
        return self._vec_len

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    @property
    def unknown_token(self):
        return self._unknown_token

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        idxs = []
        for t in toks:
            if t in self._token_to_idx:
                idxs.append(self._token_to_idx[t])
            elif lower_case_backup:
                idxs.append(self._token_to_idx.get(t.lower(), 0))
            else:
                idxs.append(0)
        # device-side row gather — never copies the full matrix to host
        rows = nd.take(self._idx_to_vec,
                       nd.array(np.asarray(idxs, np.int32)))
        return rows.reshape(-1) if single else rows

    def update_token_vectors(self, tokens, new_vectors):
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        new = new_vectors.asnumpy() if isinstance(new_vectors, NDArray) \
            else np.asarray(new_vectors, np.float32)
        new = new.reshape(len(toks), -1)
        mat = np.array(self._idx_to_vec.asnumpy())
        for t, v in zip(toks, new):
            if t not in self._token_to_idx:
                raise ValueError(
                    f"token '{t}' is not indexed in this embedding")
            mat[self._token_to_idx[t]] = v
        self._idx_to_vec = nd.array(mat)


def _wants_shape_kw(fn):
    try:
        import inspect
        return "shape" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@register
class GloVe(_TokenEmbedding):
    """GloVe format: `token v1 .. vD` per line (reference class of the same
    name; files like glove.6B.50d.txt)."""
    pretrained_file_names = (
        "glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
        "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
        "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
        "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt")


@register
class FastText(_TokenEmbedding):
    """fastText `.vec` format (optional `N D` header line tolerated)."""
    pretrained_file_names = (
        "wiki.en.vec", "wiki.simple.vec", "crawl-300d-2M.vec")


class CustomEmbedding(_TokenEmbedding):
    """Any local file in `token<delim>v1<delim>..vD` format (reference
    `CustomEmbedding` — not in the registry, constructed directly)."""


class CompositeEmbedding(_TokenEmbedding):
    """Concatenate several loaded embeddings over one vocabulary
    (reference `CompositeEmbedding`)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(vocabulary, Vocabulary):
            raise TypeError("vocabulary must be a text.vocab.Vocabulary")
        if isinstance(token_embeddings, _TokenEmbedding):
            token_embeddings = [token_embeddings]
        self._unknown_token = vocabulary.unknown_token
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        parts = []
        for emb in token_embeddings:
            if emb.idx_to_vec is None:
                raise ValueError("all component embeddings must be loaded")
            src = emb.idx_to_vec.asnumpy()
            rows = [src[emb.token_to_idx.get(t, 0)]
                    for t in self._idx_to_token]
            parts.append(np.vstack(rows))
        mat = np.concatenate(parts, axis=1)
        self._vec_len = mat.shape[1]
        self._idx_to_vec = nd.array(mat)
