"""Model families of the port: BERT (pretraining and the fine-tuning
heads, whose names are also exported here), the GPT-2 family, ResNet
v1/v2, the Sockeye Transformer NMT, the detection models YOLOv3-tiny and
SSD, DeepAR forecasting and CRNN sequence recognition."""
from . import bert, crnn, deepar, gpt, resnet, ssd, transformer, yolo
from .bert import BERTClassifier, BERTForQuestionAnswering, bert_qa_loss

__all__ = ["bert", "crnn", "deepar", "gpt", "resnet", "ssd", "transformer",
           "yolo", "BERTClassifier", "BERTForQuestionAnswering",
           "bert_qa_loss"]
