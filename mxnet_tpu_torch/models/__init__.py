"""Model families of the port: BERT (pretraining), the GPT-2 family and
ResNet v1/v2."""
from . import bert, gpt, resnet

__all__ = ["bert", "gpt", "resnet"]
