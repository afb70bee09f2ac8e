"""Gluon surface of the port: Block, Parameter, the layers, the
recurrent layers and cells, the losses, the eager `Trainer`, the data
pipeline (`data`) and the vision model zoo (`model_zoo`)."""
from . import loss, nn, rnn
from . import data, model_zoo
from .block import Block, HybridBlock, HybridSequential
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["loss", "nn", "rnn", "data", "model_zoo", "Block", "HybridBlock",
           "HybridSequential", "Parameter", "ParameterDict", "Constant",
           "Trainer"]
