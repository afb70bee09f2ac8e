"""Contributed extensions of the port (counterpart of
`mxnet_tpu/contrib`): post-training int8 quantization."""
from . import quantization

__all__ = ["quantization"]
