"""gluon.contrib (counterpart of `mxnet_tpu/gluon/contrib/`; reference:
`python/mxnet/gluon/contrib/`): the contrib layers (`nn`), the contrib
recurrent cells (`rnn`) and the `estimator` fit loop."""
from . import estimator, nn, rnn

__all__ = ["nn", "rnn", "estimator"]
