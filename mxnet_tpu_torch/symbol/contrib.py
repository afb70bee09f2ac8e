"""`sym.contrib` (counterpart of `mxnet_tpu/symbol/contrib.py`): every
`_contrib_X` registry op as `sym.contrib.X` (reference:
`python/mxnet/symbol/contrib.py`, generated from the op registry).

The symbolic control flow of the JAX module (`foreach`, `while_loop`,
`cond`, over `ops/control_flow.py`) is not in the port yet: those names
raise `NotPortedError`."""
from __future__ import annotations

from ..ops import OPS as _OPS

_CONTROL_FLOW = ("foreach", "while_loop", "cond")


def __getattr__(name):
    full = "_contrib_" + name
    if full in _OPS:
        from . import _make_sym_op
        fn = _make_sym_op(full)
        fn.__name__ = name
        globals()[name] = fn
        return fn
    if name in _CONTROL_FLOW:
        from ..ndarray.ndarray import NotPortedError
        raise NotPortedError(
            f"sym.contrib.{name} (symbolic control flow) is not in the port "
            "yet (ROADMAP.md queue 1, \"The facades\")")
    raise AttributeError(f"module 'sym.contrib' has no attribute '{name}'")
