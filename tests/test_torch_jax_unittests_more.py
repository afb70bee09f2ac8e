"""PyTorch port held to more of the JAX package's own unit tests: the
observability layer (telemetry, trace, diagnostics, profiler, inspect)
and the modules it hooks into (memsafe, resilience), plus CTC, the
detection ops, contrib.text, gluon.rnn and the params format. The same
runner as `tests/test_torch_jax_unittests.py` (a second file so that
`--dist loadfile` can put it on another worker): each file runs
unchanged through `python -m mxnet_tpu_torch.run_example --device cpu
--pytest tests/unittest/<file>.py -m "not slow"` in a fresh process,
which fails if any module of the JAX package loaded. One case a file:
its failures must be exactly the named exclusions, and its pass count
the file's count less those.

The exclusions, each naming the ROADMAP.md queue 1 item it waits for, the
test's own use of JAX, or a knob of the JAX package's own:
  * the kvstore (item "Multi-device");
  * multi-device: a mesh of more than one device, its collectives and
    their traffic estimate, fsdp, resharding;
  * the `fused_lamb` knob, which the port does not declare: it has no
    switch away from its LAMB kernels;
  * the test's own use of JAX: a `jnp` array handed to the port, or
    XLA's out-of-memory text (`RESOURCE_EXHAUSTED`) raised by the test.

On the card (`chip_smoke.py` phase 46, the card the default device)
six more fail, each on the test's own assumption of the CPU (`ON_CARD`):
the CPU's unknown peak FLOP/s and memory capacity (the H100's are
known), `np.asarray` of the trainer's parameters (a CUDA tensor has no
host conversion; a JAX array has), a 1e-6 tolerance between a padded
and a solo cuDNN LSTM (float32, another summation order: 3.4e-6 apart
on the card), and a 1e-5 tolerance between cuDNN's LSTM and the cell's
own GEMMs (1.6e-5 apart on the card).

Deselected (neither run nor counted): the tests whose child processes
import `mxnet_tpu` outside the runner's alias, so that they would run
the JAX package, not the port (`tools/launch.py` gangs and crash
drills), and, as in tier-1, the tests marked slow.

The files run two at a time (one intra-op thread each).
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

_MULTI = "multi-device"
_FUSED_LAMB = "the JAX package's `fused_lamb` knob"
_JNP = "the test's own use of JAX"

# file -> (tests run, {expected failure: reason}, deselected tests)
FILES = {
    "test_telemetry.py": (16, {
        "test_dataloader_wait_and_kvstore_bytes": _MULTI,
        "test_kvstore_failed_push_not_counted": _MULTI,
        "test_kvstore_compressed_push_counts_wire_bytes": _MULTI,
    }, []),
    "test_trace.py": (18, {}, []),
    "test_diagnostics.py": (24, {}, ["test_forced_crash_in_toy_train_loop_leaves_postmortem",
        "test_two_rank_launch_leaves_postmortems_and_report_names_rank1"]),
    "test_profiler.py": (9, {}, []),
    "test_inspect.py": (16, {
        "test_sharded_trainer_records_cost_and_memory": _MULTI,
        "test_fsdp_mode_estimates_gather_and_scatter": _MULTI,
        "test_cost_events_and_gauges_flow_into_telemetry": _MULTI,
        "test_telemetry_report_cost_section_and_verdict": _MULTI,
    }, ["test_two_rank_launch_then_inspect_report"]),
    "test_memsafe.py": (15, {
        "test_eager_trainer_oom_counts_and_annotates": _JNP,
    }, []),
    "test_resilience.py": (37, {
        "test_mesh_mismatch_raises_only_when_reshard_off": _MULTI,
        "test_fused_lamb_rng_counter_roundtrip_bit_exact": _FUSED_LAMB,
    }, []),
    "test_ctc.py": (5, {}, []),
    "test_detection_ops.py": (8, {}, []),
    "test_contrib_text.py": (13, {}, []),
    "test_gluon_rnn.py": (11, {
        "test_gru_linear_before_reset_false": _JNP,
    }, []),
    "test_params_io.py": (8, {
        "test_bfloat16_upcasts_on_save": _JNP,
    }, []),
}


_CPU_ONLY = "asserts the CPU's unknown peak or capacity"

# file -> {test expected to fail on the card besides FILES': reason}
ON_CARD = {
    "test_inspect.py": {
        "test_mfu_null_when_peak_unknown_number_when_configured": _CPU_ONLY,
        "test_dump_and_inspect_report_single_file": _CPU_ONLY,
    },
    "test_memsafe.py": {
        "test_capacity_knob_overrides_and_cpu_has_none": _CPU_ONLY,
        "test_microbatch_grad_parity": "np.asarray of a CUDA tensor",
    },
    "test_gluon_rnn.py": {
        "test_rnn_varlen_matches_per_sample":
            "cuDNN sums packed and solo LSTMs in other orders",
        "test_lstm_cell_unroll_matches_layer":
            "cuDNN's LSTM against the cell's GEMMs: 1.6e-5 apart",
    },
}


def run_file(name, files=None):
    """The harness's JSON line for one JAX test file of `files` (this
    module's `FILES` by default), and its exit code."""
    _, _, deselected = (files or FILES)[name]
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.run_example", "--device",
           "cpu", "--pytest", f"tests/unittest/{name}", "-p", "no:xdist",
           "-m", "not slow"]
    for test in deselected:
        cmd += ["--deselect", f"tests/unittest/{name}::{test}"]
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


def check_file(files, name, code, res):
    """A file's run fails exactly its named exclusions and passes the
    rest, with nothing skipped and no kernel launched."""
    total, excluded, _ = files[name]
    failed = sorted(f.split("::")[-1] for f in res["failures"])
    assert failed == sorted(excluded), res["failures"]
    assert res["passed"] == total - len(excluded)
    assert res["skipped"] == 0
    assert code == (1 if excluded else 0)
    assert not any(res["launches"].values()), res["launches"]


@pytest.mark.parametrize("name", list(FILES))
def test_jax_unit_tests_pass_on_the_port(runs, name):
    check_file(FILES, name, *runs[name].result())
