"""Gluon surface of the port: Block, Parameter, the layers, the
recurrent layers and cells, the losses and the eager `Trainer`."""
from . import loss, nn, rnn
from .block import Block, HybridBlock, HybridSequential
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["loss", "nn", "rnn", "Block", "HybridBlock", "HybridSequential",
           "Parameter", "ParameterDict", "Constant", "Trainer"]
