"""Run one of the repo's examples, unchanged, on the port.

    python -m mxnet_tpu_torch.run_example [--device cpu] \\
        examples/<dir>/<script>.py [script arguments...]

The examples import `mxnet_tpu`. While the script runs, a `sys.meta_path`
finder placed ahead of every other maps `mxnet_tpu` and each
`mxnet_tpu.<sub>` to the very module object of `mxnet_tpu_torch.<sub>`,
so `mxnet_tpu.gluon.Block is mxnet_tpu_torch.gluon.Block`, and the
repository root that an example puts first on `sys.path` cannot bring
the JAX package in. The script runs as `__main__` (`runpy.run_path`),
inside `with mx.cpu():` when `--device cpu` is given, else on the card.
After it, the runner fails if any module whose file lies in the JAX
package was loaded, then prints one JSON line: `launches`, every
`launches*` counter of `cuda_ops` (the kernels the run launched),
`seconds`, the script's wall time, and where the card was used,
`max_memory_allocated_bytes`, its peak device memory.

Importing this module installs nothing: the alias exists only while
`run` runs a script, and is removed after it.
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import json
import os
import pkgutil
import runpy
import sys
import time

__all__ = ["run", "main", "launch_counts"]

_ALIAS = "mxnet_tpu"
_PORT = "mxnet_tpu_torch"
_JAX_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), _ALIAS) + os.sep


def _aliased(name):
    return name == _ALIAS or name.startswith(_ALIAS + ".")


class _PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds `mxnet_tpu[.sub]` as the module `mxnet_tpu_torch[.sub]`."""

    def find_spec(self, fullname, path=None, target=None):
        if _aliased(fullname):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_PORT + spec.name[len(_ALIAS):])

    def exec_module(self, module):
        pass                            # the port's module is loaded already


def launch_counts():
    """{"<module>.<counter>": n} of every cuda_ops launch counter."""
    pkg = importlib.import_module(_PORT + ".cuda_ops")
    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for attr, value in sorted(vars(mod).items()):
            if attr.startswith("launches") and isinstance(value, int):
                out[f"{info.name}.{attr}"] = value
    return out


def _jax_modules():
    """Loaded modules whose file lies in the JAX package."""
    return sorted(name for name, m in list(sys.modules.items())
                  if (getattr(m, "__file__", None) or "").startswith(_JAX_DIR))


def run(script, args=(), device=None):
    """Run `script` as `__main__` with `args` under the alias (inside
    `with Context(device):` when a device is named); returns the launch
    counters. Raises if a module of the JAX package was loaded."""
    from . import context
    finder = _PortAlias()
    saved_argv, saved_path = sys.argv, list(sys.path)
    already = _jax_modules()
    if already:
        raise RuntimeError(f"the JAX package is loaded already: {already}")
    sys.meta_path.insert(0, finder)
    sys.argv = [script, *args]
    try:
        if device is None:
            runpy.run_path(script, run_name="__main__")
        else:
            with context.Context(device):
                runpy.run_path(script, run_name="__main__")
    finally:
        sys.meta_path.remove(finder)
        sys.argv = saved_argv
        sys.path[:] = saved_path
        for name in [n for n in sys.modules if _aliased(n)]:
            del sys.modules[name]
    loaded = _jax_modules()
    if loaded:
        raise RuntimeError(f"{script} loaded the JAX package: {loaded}")
    return launch_counts()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    out = {"launches": run(argv[0], argv[1:], device),
           "seconds": time.perf_counter() - t0}
    import torch
    if torch.cuda.is_initialized():
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
