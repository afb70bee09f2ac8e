"""Symbol auto-naming scopes (counterpart of `mxnet_tpu/name.py`, copied;
reference: `python/mxnet/name.py` —
`NameManager` and `Prefix`, used as `with mx.name.Prefix('mlp_'):`)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current():
    s = _stack()
    return s[-1] if s else None


class NameManager:
    """Assigns names to symbols created without an explicit `name=`. The
    base manager produces `hint0`, `hint1`, ... per hint; subclasses
    customize (reference semantics)."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return f"{hint}{i}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


class Prefix(NameManager):
    """Prepend a fixed prefix to every auto-generated name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
