"""PyTorch port held to the JAX package's own unit tests: each file below
runs unchanged through `python -m mxnet_tpu_torch.run_example --device
cpu --pytest tests/unittest/<file>.py` (the `mxnet_tpu` alias, pytest
with `--noconftest`, a seeding fixture in the conftest's place), each in
a fresh process, which fails if any module of the JAX package loaded.
One case a file: its failures must be exactly the named exclusions, and
its pass count the file's test count less those.

The exclusions, each waiting for a ROADMAP.md queue 1 item:
  * test_sparse_ndarray.py: the three lazy row-sparse optimizer updates
    ("What the GPT-2 lifecycle left out": row-sparse gradients and
    `lazy_update`) and the two kvstore tests ("Multi-device": the
    kvstore).

The files run two at a time (one intra-op thread each), so the whole
set takes about a minute on one test worker and adds one process to the
machine's load beside it.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# a run cut at TIMEOUT has written every thread's stack to stderr first
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
           MKL_NUM_THREADS="1", RUN_EXAMPLE_STACKS_AFTER=str(TIMEOUT - 30))

# file -> (tests in the file, the tests expected to fail)
FILES = {
    "test_optimizer.py": (20, []),
    "test_ndarray.py": (14, []),
    "test_misc_ops.py": (47, []),
    "test_symbol.py": (13, []),
    "test_autograd.py": (13, []),
    "test_autograd_modes.py": (5, []),
    "test_module.py": (9, []),
    "test_monitor.py": (5, []),
    "test_gluon_data.py": (10, []),
    "test_model_zoo.py": (15, []),
    "test_gluon.py": (18, []),
    "test_sparse_ndarray.py": (14, [
        "test_lazy_sgd_update_touches_only_grad_rows",
        "test_lazy_adam_update", "test_sgd_lazy_update_false_decays_all_rows",
        "test_kvstore_row_sparse_pull", "test_kvstore_sparse_push"]),
}


def run_file(name):
    """The harness's JSON line for one JAX test file (and its exit
    code)."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.run_example", "--device",
           "cpu", "--pytest", f"tests/unittest/{name}", "-p", "no:xdist"]
    try:
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=TIMEOUT, env=ENV)
    except subprocess.TimeoutExpired as e:
        err = e.stderr or b""            # bytes, whatever `text` says
        raise AssertionError(f"{name} ran past {TIMEOUT} s:\n" + (
            err.decode(errors="replace") if isinstance(err, bytes)
            else err)[-8000:]) from None
    lines = out.stdout.strip().splitlines()
    assert lines, out.stderr[-4000:]
    try:
        res = json.loads(lines[-1])
    except ValueError:
        raise AssertionError(out.stdout[-4000:] + out.stderr[-4000:])
    return out.returncode, res


@pytest.fixture(scope="module")
def runs():
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    futures = {name: pool.submit(run_file, name) for name in FILES}
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("name", list(FILES))
def test_jax_unit_tests_pass_on_the_port(runs, name):
    total, excluded = FILES[name]
    code, res = runs[name].result()
    failed = sorted(f.split("::")[-1] for f in res["failures"])
    assert failed == sorted(excluded), res["failures"]
    assert res["passed"] == total - len(excluded)
    assert res["skipped"] == 0
    assert code == (1 if excluded else 0)
    assert not any(res["launches"].values()), res["launches"]
