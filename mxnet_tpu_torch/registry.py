"""Registry helper factories (counterpart of `mxnet_tpu/registry.py`,
copied; reference: python/mxnet/registry.py —
get_register_func / get_create_func over the dmlc registry; here over
`base.Registry`).

`create` accepts the reference's flexible specs: an instance (passed
through), a registered name, a (name, kwargs) dict, or name plus kwargs —
the pattern `mx.optimizer.create` and `mx.initializer` use.
"""
from __future__ import annotations

import json

from .base import Registry

__all__ = ["get_register_func", "get_create_func", "get_registry"]

_registries = {}


def get_registry(base_class, nickname=None):
    """The Registry for a base class. Bridges to the in-tree convention
    first — modules like `optimizer`/`initializer`/`metric` keep a
    module-level `_registry` next to their base class, and the reference's
    registry functions share exactly that store (so
    `get_create_func(mx.optimizer.Optimizer)("sgd")` finds SGD).  Falls
    back to one fresh Registry per base-class OBJECT (not name: two
    unrelated `Loss` classes must not share a namespace)."""
    import sys
    mod = sys.modules.get(getattr(base_class, "__module__", None))
    shared = getattr(mod, "_registry", None)
    if isinstance(shared, Registry):
        return shared
    if base_class not in _registries:
        _registries[base_class] = Registry(
            nickname or base_class.__name__.lower())
    return _registries[base_class]


def get_register_func(base_class, nickname=None):
    reg = get_registry(base_class, nickname)

    def register(klass, name=None):
        if not (isinstance(klass, type) and issubclass(klass, base_class)):
            raise TypeError(f"can only register subclasses of "
                            f"{base_class.__name__}")
        return reg.register(name or klass.__name__, klass)

    register.__doc__ = f"Register a {reg.kind} subclass."
    return register


def get_create_func(base_class, nickname=None):
    reg = get_registry(base_class, nickname)

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            if len(args) > 1 or kwargs:
                raise ValueError("no extra arguments with an instance")
            return args[0]
        if args and isinstance(args[0], str):
            name, args = args[0], args[1:]
            try:                      # JSON spec like '{"type": {...}}'
                spec = json.loads(name)
            except ValueError:
                spec = None
            if isinstance(spec, dict) and len(spec) == 1:
                ((name, kwargs2),) = spec.items()
                if not isinstance(kwargs2, dict):
                    raise ValueError(
                        f"JSON {reg.kind} spec must map a name to a kwargs "
                        f"dict, got {kwargs2!r}")
                kwargs = {**kwargs2, **kwargs}
            return reg.get(name)(*args, **kwargs)
        raise ValueError(f"cannot create {reg.kind} from {args!r}")

    create.__doc__ = f"Create a {reg.kind} from a name/instance/JSON spec."
    return create
