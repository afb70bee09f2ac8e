"""`mx.nd` namespace of the port (counterpart of `mxnet_tpu/ndarray/`):
the NDArray, its constructors, every op of the port's op registry
(`ops.OPS`: `nd.transpose`, `nd.FullyConnected`, `nd.broadcast_add`,
`nd.sgd_update`, ...) under the JAX registry's names, `nd.contrib`,
`nd.random` and `nd.sparse` (row_sparse and csr storage,
`nd.cast_storage`).
Any other `nd.<op>` raises `NotPortedError` (a NotImplementedError and
an AttributeError) naming ROADMAP.md queue 1's "The eager MXNet
surface"."""
from . import contrib, params_io, random, sparse  # noqa: F401
from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray, NotPortedError, __getattr__  # noqa: F401
from .sparse import CSRNDArray, RowSparseNDArray, cast_storage  # noqa: F401
