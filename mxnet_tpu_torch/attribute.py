"""Attribute scoping (counterpart of `mxnet_tpu/attribute.py`, copied;
reference: `python/mxnet/attribute.py` AttrScope).

`with mx.AttrScope(ctx_group='dev1'):` stamps attributes onto every symbol
created inside the scope. The reference used this to drive the PlaceDevice
pass (coarse model parallelism, `nnvm/src/pass/place_device.cc`); here the
attrs ride along on symbol nodes and in their JSON (`Symbol.attr`,
`attr_dict`, `tojson`); the port's executor places the whole graph on the
bound device.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = [{}]
    return _state.stack


def current_attrs():
    """The merged attribute dict symbols should inherit right now."""
    return dict(_stack()[-1])


class AttrScope:
    def __init__(self, **attrs):
        for v in attrs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings "
                                 "(matches reference)")
        self._attrs = attrs

    def __enter__(self):
        merged = dict(_stack()[-1])
        merged.update(self._attrs)
        _stack().append(merged)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False
