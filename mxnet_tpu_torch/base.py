"""Base utilities of the port (counterpart of `mxnet_tpu/base.py`): the
framework's error type `MXNetError`, the name -> object `Registry` and
`part_range`, copied (the port never imports the JAX package)."""
from __future__ import annotations

import threading

__all__ = ["MXNetError", "Registry", "part_range"]


class MXNetError(RuntimeError):
    """Framework error type (reference: `include/mxnet/base.h` dmlc::Error)."""


def part_range(n, num_parts, part_index):
    """Record range [lo, hi) owned by one input-sharding worker (reference:
    `src/io/iter_image_recordio_2.cc` num_parts/part_index — each worker
    reads a disjoint slice; slices union to exactly one epoch)."""
    num_parts, part_index = int(num_parts), int(part_index)
    if num_parts < 1 or not 0 <= part_index < num_parts:
        raise ValueError(
            f"invalid partition: part_index={part_index} num_parts={num_parts}")
    lo = n * part_index // num_parts
    hi = n * (part_index + 1) // num_parts
    if num_parts > 1 and lo >= hi:
        raise ValueError(f"empty partition: {num_parts} parts over {n} records")
    return lo, hi


class Registry:
    """Generic name → object registry (reference: dmlc registry template,
    `3rdparty/dmlc-core/include/dmlc/registry.h`)."""

    def __init__(self, kind):
        self.kind = kind
        self._lock = threading.Lock()
        self._map = {}

    def register(self, name=None, obj=None, *, allow_override=False):
        def do_register(o, key):
            key = (key or getattr(o, "__name__", None) or str(o)).lower()
            with self._lock:
                if key in self._map and not allow_override:
                    raise ValueError(f"{self.kind} '{key}' already registered")
                self._map[key] = o
            return o

        if obj is not None:
            return do_register(obj, name)
        if callable(name) and not isinstance(name, str):
            return do_register(name, None)
        return lambda o: do_register(o, name)

    def get(self, name):
        try:
            return self._map[name.lower()]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Registered: {sorted(self._map)}"
            ) from None

    def __contains__(self, name):
        return name.lower() in self._map

    def keys(self):
        return sorted(self._map)
