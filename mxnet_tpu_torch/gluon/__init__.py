"""Gluon surface of the port: Block, Parameter, the layers, the
recurrent layers and cells, the losses, the eager `Trainer`, the data
pipeline (`data`), the vision model zoo (`model_zoo`) and `SymbolBlock`
(a symbolic graph as a Block)."""
from . import loss, nn, rnn
from . import data, model_zoo
from .block import Block, HybridBlock, HybridSequential
from .parameter import Constant, Parameter, ParameterDict
from .symbol_block import SymbolBlock
from .trainer import Trainer

__all__ = ["loss", "nn", "rnn", "data", "model_zoo", "Block", "HybridBlock",
           "HybridSequential", "Parameter", "ParameterDict", "Constant",
           "SymbolBlock", "Trainer"]
