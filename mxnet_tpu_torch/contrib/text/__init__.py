"""Text utilities (counterpart of `mxnet_tpu/contrib/text/`; reference:
python/mxnet/contrib/text/): vocabulary, pretrained embeddings from local
files, byte-level BPE and the BERT tokenizers."""
from . import bpe, embedding, tokenizer, utils, vocab  # noqa: F401
from .bpe import BPETokenizer, learn_bpe           # noqa: F401
from .tokenizer import BERTTokenizer               # noqa: F401
from .vocab import Vocabulary                      # noqa: F401
