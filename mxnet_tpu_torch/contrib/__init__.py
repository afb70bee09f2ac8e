"""Contributed extensions of the port (counterpart of
`mxnet_tpu/contrib`): post-training int8 quantization, and `text`
(vocabulary, embeddings, BPE and the BERT tokenizers)."""
from . import quantization, text

__all__ = ["quantization", "text"]
