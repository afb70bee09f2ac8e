"""PyTorch port held to the JAX package's unit tests of control flow
(`nd.contrib` and `sym.contrib` foreach, while_loop, cond), BERT's
fine-tuning heads and the report tools, with the runner of
`tests/test_torch_jax_unittests_more.py` (a file of its own so that
`--dist loadfile` can put it on another worker): each file runs
unchanged through `python -m mxnet_tpu_torch.run_example --device cpu
--pytest tests/unittest/<file>.py -m "not slow"` in a fresh process,
which fails if any module of the JAX package loaded. One case a file:
its failures must be exactly the named exclusions, and its pass count
the file's count less those.

The exclusions:
  * the test's own use of JAX: `jax.jit` of the JAX module's
    `ops.control_flow.while_loop`, and the import of the JAX package's
    Pallas kernels (`mxnet_tpu.pallas_ops`, which the port has no copy
    of: its kernels are CUDA);
  * the port's `hybridize()` is eager: a hybridized block's `cond` runs
    one branch, so a branch whose structure differs from the other's is
    never traced and raises no TypeError (ROADMAP.md "Not faults");
  * "The facades" (ROADMAP.md queue 1): ONNX export and import.

The files run two at a time (one intra-op thread each), about 20 s in
all.
"""
import concurrent.futures

import pytest

import test_torch_jax_unittests_more as _runner

_JNP = "the test's own use of JAX"
_EAGER = "hybridize() is eager: the other branch is never traced"
_ONNX = "The facades: contrib.onnx"

# file -> (tests run, {expected failure: reason}, deselected tests)
FILES = {
    "test_control_flow.py": (11, {
        "test_while_loop_traced_vec1_pred": _JNP,
        "test_cond_traced_structure_mismatch": _EAGER,
    }, []),
    "test_symbol_control_flow.py": (13, {
        "test_onnx_if_roundtrip": _ONNX,
        "test_onnx_scan_roundtrip": _ONNX,
        "test_onnx_loop_roundtrip": _ONNX,
        "test_onnx_scan_unused_final_state": _ONNX,
        "test_onnx_reducesum_axes_not_param": _ONNX,
    }, []),
    "test_bert_finetune.py": (9, {
        "test_fit_block_handles_odd_requests": _JNP,
    }, []),
    "test_report_tools.py": (12, {}, []),
}


@pytest.fixture(scope="module")
def runs():
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    futures = {name: pool.submit(_runner.run_file, name, FILES)
               for name in FILES}
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("name", list(FILES))
def test_jax_unit_tests_pass_on_the_port(runs, name):
    _runner.check_file(FILES, name, *runs[name].result())
