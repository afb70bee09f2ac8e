"""Weight bridge: load named numpy arrays into a port model.

The port's parameter paths equal the JAX package's `collect_params()`
paths, so weights carried across from `mxnet_tpu` (as
`{path: np.asarray(param)}`) load by name with no renaming. Anything
that does not line up raises: a missing name, an extra name, or a shape
mismatch. A parameter whose shape is still deferred takes the array's
(its known dimensions must agree), so a model loads before its first
forward.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_named_arrays"]


def _to_tensor(arr):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":         # ml_dtypes bfloat16 from jax
        return torch.from_numpy(arr.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))           # a writable copy


def load_named_arrays(model, arrays):
    """Copy `arrays` ({dotted path: array}) into `model`'s parameters,
    casting to each parameter's dtype and device. Each loaded parameter
    counts as initialised: a later `initialize()` leaves it alone."""
    params = model.collect_params()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"load_named_arrays: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        src = _to_tensor(arrays[name])
        if getattr(p, "mx_deferred", False):
            if src.dim() != p.dim() or any(
                    s not in (0, n) for s, n in zip(p.shape, src.shape)):
                raise ValueError(
                    f"load_named_arrays: {name} has shape "
                    f"{tuple(src.shape)}, the model expects "
                    f"{tuple(p.shape)} (0: any)")
            p.data = torch.empty(src.shape, dtype=p.dtype, device=p.device)
            p.mx_deferred = False
            p.mx_init_requested = None
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"load_named_arrays: {name} has shape {tuple(src.shape)}, "
                f"the model expects {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(src.to(device=p.device, dtype=p.dtype))
        p.mx_initialized = True
    return model
