"""PyTorch port, `contrib.text` against the JAX package's
`mxnet_tpu.contrib.text` on the CPU (`tests/unittest/test_contrib_text.py`
case by case, each on both packages): token counting, the vocabulary's
indexing rules, embeddings from local files (custom, GloVe, fastText,
composite, attached to a vocabulary), `get_vecs_by_tokens`,
`update_token_vectors`, byte-level BPE and the BERT tokenizers.

`bpe`, `tokenizer`, `vocab` and `utils` are copies, so their results are
equal; the embeddings hold their table as an NDArray (the port's inside
`with mx.cpu():`), compared exactly. The BPE merges and ids of
`examples/gpt/generate.py`'s corpus equal the JAX package's.
"""
import numpy as np
import pytest

from mxnet_tpu.contrib import text as text_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.contrib import text as text_t

PKGS = [pytest.param(text_j, id="jax"), pytest.param(text_t, id="port")]
# examples/gpt/generate.py's corpus
CORPUS = (
    "the quick brown fox jumps over the lazy dog . "
    "the lazy dog sleeps in the warm sun . "
    "the quick fox runs through the green field . "
    "a brown dog chases the quick fox . "
) * 8


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def make_counter(text):
    return text.utils.count_tokens_from_str(
        "the quick brown fox the quick the")


@pytest.mark.parametrize("text", PKGS)
def test_count_tokens_from_str(text):
    c = make_counter(text)
    assert c["the"] == 3 and c["quick"] == 2 and c["fox"] == 1
    c2 = text.utils.count_tokens_from_str("The THE", to_lower=True)
    assert c2["the"] == 2


@pytest.mark.parametrize("text", PKGS)
def test_vocabulary_ordering_and_limits(text):
    v = text.vocab.Vocabulary(make_counter(text))
    assert v.idx_to_token == ["<unk>", "the", "quick", "brown", "fox"]
    assert v.to_indices("the") == 1
    assert v.to_indices(["fox", "nope"]) == [4, 0]
    assert v.to_tokens([1, 2]) == ["the", "quick"]
    with pytest.raises(ValueError):
        v.to_tokens(99)
    v2 = text.vocab.Vocabulary(make_counter(text), most_freq_count=2,
                               reserved_tokens=["<pad>"])
    assert v2.idx_to_token == ["<unk>", "<pad>", "the", "quick"]
    v3 = text.vocab.Vocabulary(make_counter(text), min_freq=2)
    assert set(v3.idx_to_token) == {"<unk>", "the", "quick"}


@pytest.mark.parametrize("text", PKGS)
def test_vocabulary_validation(text):
    with pytest.raises(ValueError):
        text.vocab.Vocabulary(make_counter(text), min_freq=0)
    with pytest.raises(ValueError):
        text.vocab.Vocabulary(make_counter(text), reserved_tokens=["<unk>"])
    with pytest.raises(ValueError):
        text.vocab.Vocabulary(make_counter(text), reserved_tokens=["a", "a"])


def write_embedding(path, header=False):
    lines = ["3 4"] if header else []
    lines += ["the 1 2 3 4", "fox 5 6 7 8", "dog 9 10 11 12",
              "the 0 0 0 0"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _table(emb):
    return np.asarray(emb.idx_to_vec.asnumpy())


def test_custom_embedding_load_lookup_and_update(tmp_path):
    p = write_embedding(tmp_path / "emb.txt")
    tables = []
    for text in (text_j, text_t):
        emb = text.embedding.CustomEmbedding(pretrained_file_path=p)
        assert emb.vec_len == 4 and len(emb) == 4
        np.testing.assert_array_equal(
            emb.get_vecs_by_tokens("fox").asnumpy(), [5, 6, 7, 8])
        vecs = emb.get_vecs_by_tokens(["dog", "missing"]).asnumpy()
        np.testing.assert_array_equal(vecs, [[9, 10, 11, 12], [0, 0, 0, 0]])
        np.testing.assert_array_equal(
            emb.get_vecs_by_tokens("The", lower_case_backup=True).asnumpy(),
            [1, 2, 3, 4])
        emb.update_token_vectors("the", np.ones(4, np.float32))
        emb.update_token_vectors(["fox", "dog"],
                                 np.arange(8, dtype=np.float32))
        np.testing.assert_array_equal(
            emb.get_vecs_by_tokens("the").asnumpy(), np.ones(4))
        with pytest.raises(ValueError):
            emb.update_token_vectors("nope", np.ones(4, np.float32))
        tables.append((_table(emb), emb.idx_to_token))
    np.testing.assert_array_equal(tables[1][0], tables[0][0])
    assert tables[1][1] == tables[0][1]
    assert text_t.embedding.CustomEmbedding(
        pretrained_file_path=p).idx_to_vec.context.device_type == "cpu"


@pytest.mark.parametrize("text", PKGS)
def test_fasttext_header_tolerated(text, tmp_path):
    p = write_embedding(tmp_path / "wiki.vec", header=True)
    emb = text.embedding.FastText(pretrained_file_path=p)
    assert len(emb) == 4 and emb.vec_len == 4


@pytest.mark.parametrize("text", PKGS)
def test_registry_create_and_file_names(text, tmp_path):
    p = write_embedding(tmp_path / "glove.txt")
    emb = text.embedding.create("glove", pretrained_file_path=p)
    assert isinstance(emb, text.embedding.GloVe)
    assert "glove.6B.50d.txt" in \
        text.embedding.get_pretrained_file_names("glove")
    assert text.embedding.get_pretrained_file_names() == \
        text_j.embedding.get_pretrained_file_names()
    with pytest.raises(KeyError):
        text.embedding.create("word2vec9000")
    with pytest.raises(FileNotFoundError):
        text.embedding.create("glove", pretrained_file_path="/nope.txt")


def test_embedding_with_vocabulary_and_composite(tmp_path):
    p1 = write_embedding(tmp_path / "a.txt")
    p2 = tmp_path / "b.txt"
    p2.write_text("the 0.5 0.5\nquick 1 1\n")
    out = []
    for text in (text_j, text_t):
        vocab = text.vocab.Vocabulary(make_counter(text))
        emb = text.embedding.CustomEmbedding(pretrained_file_path=p1,
                                             vocabulary=vocab)
        assert emb.idx_to_token == vocab.idx_to_token
        e1 = text.embedding.CustomEmbedding(pretrained_file_path=p1)
        e2 = text.embedding.CustomEmbedding(pretrained_file_path=str(p2))
        comp = text.embedding.CompositeEmbedding(vocab, [e1, e2])
        assert comp.vec_len == 6
        np.testing.assert_array_equal(
            comp.get_vecs_by_tokens("quick").asnumpy(), [0, 0, 0, 0, 1, 1])
        with pytest.raises(TypeError):
            text.embedding.CompositeEmbedding({"the": 1}, [e1])
        out.append((_table(emb), _table(comp)))
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("merges", [20, 80])
def test_bpe_of_the_generate_example_equals_jax(merges):
    mj = text_j.bpe.learn_bpe([CORPUS], merges)
    mt = text_t.bpe.learn_bpe([CORPUS], merges)
    assert mt == mj
    tj, tt = text_j.BPETokenizer(mj), text_t.BPETokenizer(mt)
    assert len(tt) == len(tj)
    assert tt.encode(CORPUS) == tj.encode(CORPUS)
    assert tt.decode(tt.encode("the quick")) == "the quick"


@pytest.mark.parametrize("text", PKGS)
def test_bpe_roundtrip_any_unicode(text):
    corpus = ["the quick brown fox jumps over the lazy dog",
              "the quick brown fox is quick"]
    tok = text.bpe.BPETokenizer(text.bpe.learn_bpe(corpus, 50))
    for s in ["the quick fox", "Ünïcôdé — naïve café ☕😀",
              "tabs\tand\nnewlines  spaces", "", "日本語テキスト"]:
        assert tok.decode(tok.encode(s)) == s, s


@pytest.mark.parametrize("text", PKGS)
def test_bpe_learns_compression(text):
    corpus = ["low lower lowest slow slower slowest"] * 4
    merges = text.bpe.learn_bpe(corpus, 40)
    enc = text.bpe.BPETokenizer(merges).encode("low lower lowest")
    assert len(enc) < len("low lower lowest".encode("utf8"))
    assert merges == text.bpe.learn_bpe(corpus, 40)


@pytest.mark.parametrize("text", PKGS)
def test_bpe_special_tokens_and_persistence(text, tmp_path):
    tok = text.bpe.BPETokenizer(text.bpe.learn_bpe(["aa ab aa"], 10),
                                special_tokens=("<eos>",))
    eos = tok.special_tokens["<eos>"]
    assert eos == len(tok) - 1
    assert tok.decode(tok.encode("aa ab") + [eos]) == "aa ab"
    p = str(tmp_path / "bpe.json")
    tok.save(p)
    for other in (text_j, text_t):       # each package reads the other's
        tok2 = other.bpe.BPETokenizer.load(p)
        assert tok2.encode("aa ab") == tok.encode("aa ab")
        assert tok2.special_tokens == tok.special_tokens


@pytest.mark.parametrize("text", PKGS)
def test_bpe_underscore_negative_ids_and_collisions(text):
    tok = text.bpe.BPETokenizer(text.bpe.learn_bpe(["a b"], 5))
    for s in ["snake_case_name", "__init__", "a_b c _"]:
        assert tok.decode(tok.encode(s)) == s
    with pytest.raises(ValueError):
        text.bpe.BPETokenizer([], special_tokens=("a",))
    tok = text.bpe.BPETokenizer(text.bpe.learn_bpe(["ab abc"], 8),
                                special_tokens=("<eos>",))
    ids = tok.encode("ab") + [-1, tok.special_tokens["<eos>"]]
    assert tok.decode(ids) == "ab"
    tok2 = text.bpe.BPETokenizer([("a", "bc"), ("b", "c"), ("ab", "c")])
    assert len(tok2.idx_to_token) == len(set(tok2.idx_to_token))
    assert len(tok2) == len(tok2.token_to_idx)


def test_bert_tokenizer_equals_jax():
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "##est",
             "brown", "fox", "un", "##aff", "##able", ",", "."]
    s = "The quickest brown fox, unaffable. Jumps!"
    out = []
    for text in (text_j, text_t):
        tok = text.BERTTokenizer({w: i for i, w in enumerate(words)})
        out.append((tok(s), tok.convert_tokens_to_ids(tok(s)),
                    tok.encode(s, "the fox", max_length=12)))
    assert out[1] == out[0]
