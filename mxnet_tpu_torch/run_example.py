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

    python -m mxnet_tpu_torch.run_example [--device cpu] \\
        --pytest tests/unittest/<file>.py [pytest arguments...]

runs pytest on an unchanged test file of the JAX package under the same
alias (`run_pytest`), with `--noconftest` (the suite's conftest imports
jax) and in its place a fixture that seeds `random` and numpy's global
stream with 0 before each test, as that conftest does. It fails if any
module of the JAX package loaded, and prints one JSON line: `passed`,
`failed`, `failures` (each failed test's id), `skipped`, `passed_ids`
(each passed test's id: more files may follow the first among the
pytest arguments) and `launches`.
Run it in a fresh process: one that holds the JAX package already is
refused. With `RUN_EXAMPLE_STACKS_AFTER=<seconds>` in the environment,
the process writes every thread's stack to stderr once that many
seconds have passed (`faulthandler.dump_traceback_later`), so a run cut
by its caller's time limit shows where it waited.

Importing this module installs nothing: the alias exists only while
`run` runs a script, and is removed after it.
"""
from __future__ import annotations

import faulthandler
import importlib
import importlib.abc
import importlib.util
import json
import os
import pkgutil
import runpy
import sys
import time

__all__ = ["run", "run_pytest", "main", "launch_counts"]

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


def _aliased_call(fn, argv, device):
    """fn() under the alias, with `sys.argv` = argv, inside
    `with Context(device):` when a device is named. Raises if a module of
    the JAX package was loaded before or during the call."""
    from . import context
    finder = _PortAlias()
    saved_argv, saved_path = sys.argv, list(sys.path)
    already = _jax_modules()
    if already:
        raise RuntimeError(f"the JAX package is loaded already: {already}")
    sys.meta_path.insert(0, finder)
    sys.argv = list(argv)
    try:
        if device is None:
            result = fn()
        else:
            with context.Context(device):
                result = fn()
    finally:
        sys.meta_path.remove(finder)
        sys.argv = saved_argv
        sys.path[:] = saved_path
        for name in [n for n in sys.modules if _aliased(n)]:
            del sys.modules[name]
    loaded = _jax_modules()
    if loaded:
        raise RuntimeError(f"{argv[0]} loaded the JAX package: {loaded}")
    return result


def run(script, args=(), device=None):
    """Run `script` as `__main__` with `args` under the alias (inside
    `with Context(device):` when a device is named); returns the launch
    counters. Raises if a module of the JAX package was loaded."""
    _aliased_call(lambda: runpy.run_path(script, run_name="__main__"),
                  [script, *args], device)
    return launch_counts()


class _Seeded:
    """The pytest plugin that stands in for the suite's conftest: each
    test starts from `random.seed(0)` and `np.random.seed(0)`, and the
    outcome of each test is kept."""

    def __init__(self):
        self.passed, self.failures, self.skipped = [], [], []

    def pytest_runtest_setup(self, item):
        import numpy as np
        from . import random
        random.seed(0)
        np.random.seed(0)

    def pytest_runtest_logreport(self, report):
        if report.failed:
            if report.nodeid not in self.failures:
                self.failures.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)
        elif report.when == "call":
            self.passed.append(report.nodeid)

    def pytest_collectreport(self, report):
        if report.failed:
            self.failures.append(report.nodeid)


def run_pytest(path, args=(), device=None):
    """pytest on the test file `path` under the alias, with
    `--noconftest` and `_Seeded` in the suite's conftest's place.
    Returns {"passed", "failed", "failures", "skipped", "passed_ids",
    "launches", "exit_code"}; raises if a module of the JAX package was
    loaded."""
    import pytest
    plugin = _Seeded()
    code = _aliased_call(
        lambda: pytest.main(["--noconftest", "-p", "no:cacheprovider",
                             "-p", "no:randomly", "-q", path, *args],
                            plugins=[plugin]),
        [path, *args], device)
    return {"passed": len(plugin.passed), "failed": len(plugin.failures),
            "failures": plugin.failures, "skipped": len(plugin.skipped),
            "passed_ids": plugin.passed, "exit_code": int(code),
            "launches": launch_counts()}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if os.environ.get("RUN_EXAMPLE_STACKS_AFTER"):
        faulthandler.dump_traceback_later(
            float(os.environ["RUN_EXAMPLE_STACKS_AFTER"]), exit=False)
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "--pytest":
        out = run_pytest(argv[1], argv[2:], device)
        print(json.dumps(out))
        return 0 if out["failed"] == 0 else 1
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
