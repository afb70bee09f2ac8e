"""`nd.contrib` (counterpart of the registry passthrough of
`mxnet_tpu/ndarray/contrib.py`): every ported `_contrib_X` op is also
`nd.contrib.X`."""
from .ndarray import _registry, registry_op


def __getattr__(name):
    full = "_contrib_" + name
    if full in _registry():
        return registry_op(full)
    raise AttributeError(f"module 'nd.contrib' has no attribute '{name}'")
