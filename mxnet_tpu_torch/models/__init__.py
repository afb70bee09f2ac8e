"""Model families of the port: BERT (pretraining), the GPT-2 family,
ResNet v1/v2, the Sockeye Transformer NMT and the detection models
YOLOv3-tiny and SSD."""
from . import bert, gpt, resnet, ssd, transformer, yolo

__all__ = ["bert", "gpt", "resnet", "ssd", "transformer", "yolo"]
