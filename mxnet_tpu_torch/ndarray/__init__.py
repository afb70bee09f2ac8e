"""`mx.nd` namespace of the port (counterpart of `mxnet_tpu/ndarray/`):
the NDArray, its constructors, every op of the port's op registry
(`ops.OPS`: `nd.transpose`, `nd.FullyConnected`, `nd.broadcast_add`,
...) under the JAX registry's names, and `nd.contrib`.
Any other `nd.<op>` raises `NotPortedError` (a NotImplementedError and
an AttributeError) naming ROADMAP.md queue 1's "The eager MXNet
surface"."""
from . import contrib, params_io  # noqa: F401
from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray, NotPortedError, __getattr__  # noqa: F401
