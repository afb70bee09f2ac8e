"""Contributed extensions of the port (counterpart of
`mxnet_tpu/contrib`): post-training int8 quantization, `text`
(vocabulary, embeddings, BPE and the BERT tokenizers), and `onnx`,
whose export and import raise `NotPortedError`."""
from . import onnx, quantization, text

__all__ = ["onnx", "quantization", "text"]
