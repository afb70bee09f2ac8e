"""Recurrent layers and cells (counterpart of `mxnet_tpu/gluon/rnn/`)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ResidualCell",
           "ZoneoutCell", "BidirectionalCell"]
