"""Gluon surface of the port: Block, Parameter and the layers."""
from . import nn
from .block import Block, HybridBlock, HybridSequential
from .parameter import Constant, Parameter

__all__ = ["nn", "Block", "HybridBlock", "HybridSequential", "Parameter",
           "Constant"]
