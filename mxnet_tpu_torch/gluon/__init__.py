"""Gluon surface of the port: Block, Parameter, the layers, the
recurrent layers and cells, the losses, the eager `Trainer`, the data
pipeline (`data`), the vision model zoo (`model_zoo`), `SymbolBlock`
(a symbolic graph as a Block), `utils` and `contrib` (the contrib layers
and cells and the Estimator fit loop)."""
from . import loss, nn, rnn, utils
from . import contrib, data, model_zoo
from .block import (Block, HybridBlock, HybridSequential, Sequential,
                    functional_call)
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .symbol_block import SymbolBlock
from .trainer import Trainer

__all__ = ["loss", "nn", "rnn", "utils", "contrib", "data", "model_zoo",
           "Block",
           "HybridBlock", "Sequential", "HybridSequential", "functional_call",
           "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "SymbolBlock", "Trainer"]
