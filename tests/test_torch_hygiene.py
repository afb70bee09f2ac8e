"""PyTorch port hygiene: the package and `chip_smoke.py` never import
JAX or the JAX package (the machine with the card has neither), and the
port does not fall back to the CPU when nobody asked for it."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")
_FORBIDDEN = ("jax", "mxnet_tpu", "jaxlib")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in _FORBIDDEN]
    return bad


def test_no_jax_import_in_port_sources():
    files = _port_files()
    assert len(files) > 15
    bad = {os.path.relpath(f, ROOT): _forbidden_imports(f) for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


@pytest.mark.parametrize("module", ["config", "memsafe", "resilience",
                                    "serve"])
def test_serving_lifecycle_modules_stand_alone(module):
    """The serving lifecycle's modules (the knobs, the budget check, retry
    and fault injection, the server) are among the checked sources,
    import no JAX, and loaded alone pull in none."""
    path = os.path.join(PKG, module + ".py")
    assert path in _port_files()
    assert _forbidden_imports(path) == []
    code = (f"import sys; import mxnet_tpu_torch.{module}\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{_FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_EXAMPLES_SLICE = ["context", "run_example", "ops.shape_ops",
                   "parallel.distributed", "gluon.data.dataloader",
                   "gluon.data.vision.datasets",
                   "gluon.data.vision.transforms", "gluon.model_zoo.vision",
                   "contrib.text.embedding", "contrib.text.bpe"]


def test_examples_slice_modules_stand_alone():
    """The modules that run the repo's examples (contexts, shape ops,
    gluon.data, the model zoo, contrib.text, the runner) are among the
    checked sources and import no JAX; loaded together, one after the
    other, they pull in none (so none does alone), and importing the
    runner installs no alias."""
    for module in _EXAMPLES_SLICE:
        path = os.path.join(PKG, *module.split(".")) + ".py"
        assert path in _port_files()
        assert _forbidden_imports(path) == [], module
    code = ("import importlib, sys\n"
            f"for m in {_EXAMPLES_SLICE!r}:\n"
            "    importlib.import_module('mxnet_tpu_torch.' + m)\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{_FORBIDDEN!r}]\n"
            "    assert not bad, (m, bad)\n"
            "assert not [f for f in sys.meta_path\n"
            "            if type(f).__name__ == '_PortAlias']\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_SYMBOLIC_SLICE = ["symbol", "symbol.executor", "symbol.contrib", "module",
                   "io", "callback", "monitor", "name", "attribute",
                   "registry", "ops", "ops.math_ops", "gluon.symbol_block"]


def _module_path(module):
    path = os.path.join(PKG, *module.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(PKG, *module.split("."), "__init__.py")
    return path


@pytest.mark.parametrize("module", _SYMBOLIC_SLICE)
def test_symbolic_slice_module_imports_no_jax(module):
    """Each module of MXNet's symbolic half (the op registry, symbol with
    its executor, module, io, callback, monitor, name, attribute,
    registry, SymbolBlock) is among the checked sources and imports no
    JAX."""
    path = _module_path(module)
    assert path in _port_files()
    assert _forbidden_imports(path) == []


def test_symbolic_slice_modules_stand_alone():
    """Loaded one after the other, the symbolic half's modules pull in no
    JAX (so none does alone), nor do the package's lazy aliases
    (`mx.sym`, `mx.mod`, ...)."""
    code = ("import importlib, sys\n"
            f"for m in {_SYMBOLIC_SLICE!r}:\n"
            "    importlib.import_module('mxnet_tpu_torch.' + m)\n"
            "    bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{_FORBIDDEN!r}]\n"
            "    assert not bad, (m, bad)\n"
            "import mxnet_tpu_torch as mx\n"
            "mx.sym, mx.mod, mx.io, mx.callback, mx.mon, mx.executor\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{_FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil\n"
            "import mxnet_tpu_torch as m\n"
            "for info in pkgutil.walk_packages(m.__path__, m.__name__ + '.'):\n"
            "    importlib.import_module(info.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            f"{_FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok', len([k for k in sys.modules "
            "if k.startswith('mxnet_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok") and int(out.stdout.split()[1]) > 15


def test_entry_points_refuse_a_missing_card(monkeypatch):
    from mxnet_tpu_torch import context, pages
    from mxnet_tpu_torch.models import gpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GPTForCausalLM(gpt.gpt_tiny_config())
    with pytest.raises(RuntimeError):
        pages.PagePool(4, 2, 1, {"target": []})
    with pytest.raises(RuntimeError):
        context.resolve("cuda")
    assert context.resolve("cpu") == torch.device("cpu")


def test_wrappers_refuse_other_devices():
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    from mxnet_tpu_torch.cuda_ops import paged_attention as pa
    q = torch.zeros((1, 1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_fwd(q, q, q, torch.zeros((1, 4), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attention(q[:, :, :1], q, q,
                           torch.zeros((1, 1), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32))


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """With no CUDA device visible, chip_smoke (here a copy standing alone
    in a directory) exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        lone.write_text(fh.read())
    out = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2, out.stderr
    assert '"ok"' not in out.stdout
