"""Model families of the port: BERT (pretraining), the GPT-2 family,
ResNet v1/v2 and the Sockeye Transformer NMT."""
from . import bert, gpt, resnet, transformer

__all__ = ["bert", "gpt", "resnet", "transformer"]
