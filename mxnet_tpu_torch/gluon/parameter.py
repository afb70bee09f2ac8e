"""Parameters (counterpart of `mxnet_tpu/gluon/parameter.py`).

A parameter is a `torch.nn.Parameter` that remembers its own
initializer, so `Block.initialize()` can apply the JAX package's rule:
the initializer passed to `initialize`, else the parameter's own, else
uniform. The slice is inference-only, so parameters carry no gradient.
Storage is allocated on torch's current default device, which the model
constructors set to the model's device.
"""
from __future__ import annotations

import torch

__all__ = ["Parameter", "dtype_of"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(dtype):
    """torch dtype for a JAX-package dtype name (or a torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def Parameter(name, shape, dtype="float32", init=None):  # noqa: N802
    p = torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype_of(dtype)),
                           requires_grad=False)
    p.mx_name = name
    p.mx_init = init
    return p
