"""Gluon surface of the port: Block, Parameter, the layers and the
losses."""
from . import loss, nn
from .block import Block, HybridBlock, HybridSequential
from .parameter import Constant, Parameter

__all__ = ["loss", "nn", "Block", "HybridBlock", "HybridSequential",
           "Parameter", "Constant"]
