"""PyTorch port held to the JAX package's own unit tests of the serving
path and the operations layer: `serve` and `pages` (the port's main
path), and `guard`, `check`, `slo`, `goodput`, `scope`, `ledger` and
`fleet`. The same
runner as `tests/test_torch_jax_unittests.py` (a file of its own so
that `--dist loadfile` can put it on another worker): each file runs
unchanged through `python -m mxnet_tpu_torch.run_example --device cpu
--pytest tests/unittest/<file>.py -m "not slow"` in a fresh process,
which fails if any module of the JAX package loaded. One case a file:
its failures must be exactly the named exclusions, and its pass count
the file's count less those.

The exclusions, each naming the ROADMAP.md queue 1 item it waits for,
the port's documented meaning of a rule, or the test's own use of JAX:
  * multi-device: per-replica digests over an 8-device mesh (the port
    holds one copy of the parameters a process, so its in-process vote
    has one voter), replicated parameters on a data mesh;
  * a check rule whose port meaning differs (`check.py`'s docstring,
    ROADMAP.md "Not faults"): `donate=False` changes nothing in the
    port's in-place step, and the learning rate is no part of a port
    step's signature;
  * the port refuses a drafter with another vocabulary at construction
    (`serve.py`'s docstring), where the JAX package serves it and only
    its lint flags it;
  * the test's own use of JAX: `jnp` arithmetic on the JAX NDArray's
    `_data`, `jax.jit` patched to count compiles, `jit_flat_step`;
  * `ledger.PERF_KNOBS` (the port's ledger docstring): the knobs the
    port declares, without the JAX package's `kernels` or `zero`.

`test_ledger.py::test_ledger_off_is_a_zero_hook_fast_path` passes: the
JAX bench's hook it calls (`benchmarks/_provenance.py`) imports
`mxnet_tpu.ledger`, which the alias resolves to the port's module.

Deselected (neither run nor counted): the test whose child process runs
`tools/check_graph.py`, which imports the JAX package outside the
runner's alias; the five `test_ledger.py` tests that load
`tools/ledger_report.py`, which exercises the JAX package's `ledger.py`
by file path (`tests/test_torch_ledger.py` holds the tool against a
ledger the port wrote); and, as in tier-1, the tests marked slow (the
fleet's rolling update and launcher; `tests/test_torch_fleet.py` runs
the port's launcher).

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
_PORT_RULE = "a check rule whose port meaning differs"
_DRAFTER = "the port refuses a drafter of another vocabulary"
_JNP = "the test's own use of JAX"
_PORT_KNOB = ("reads the `kernels` knob and sets `zero`: the first has no "
              "meaning in the port, the second waits for Multi-device")

# the tests that load tools/ledger_report.py, which loads the JAX
# package's ledger.py by file path: they exercise that file, not the port
_LEDGER_REPORT = [
    "test_backfill_import_idempotent_and_anchor_renders",
    "test_report_parse_pytest_log_and_budget_warning",
    "test_gate_cli_seeded_regression",
    "test_gate_cli_nothing_to_judge",
    "test_render_report_sparklines_and_verdict",
]

# file -> (tests run, {expected failure: reason}, deselected tests)
FILES = {
    "test_serve.py": (36, {
        "test_bucketing_bounds_executables_and_check_quiet": _JNP,
    }, []),
    "test_pages.py": (20, {
        "test_copy_page_copies_every_stream": _JNP,
        "test_degenerate_paging_drafter_vocab_finding": _DRAFTER,
    }, []),
    "test_guard.py": (27, {
        "test_param_digests_deterministic_per_replica": _MULTI,
        "test_corrupt_replica_digest_vote_names_rank": _MULTI,
        "test_sdc_check_restores_last_verified_checkpoint": _MULTI,
        "test_sdc_two_strikes_quarantine_via_elastic_shrink": _MULTI,
        "test_sdc_file_exchange_across_launcher_ranks": _MULTI,
        "test_sdc_replayed_round_ignores_stale_digest_files": _MULTI,
        "test_sdc_partial_exchange_never_convicts": _MULTI,
        "test_corrupt_grad_fires_at_step_via_fault_point": _MULTI,
    }, []),
    "test_check.py": (29, {
        "test_donation_miss_fires_on_donate_false_and_not_on_default":
            _PORT_RULE,
        "test_retrace_hazard_fires_on_baked_lr_scalar": _PORT_RULE,
        "test_degenerate_sharding_fires_on_replicated_params": _MULTI,
        "test_donation_miss_fires_on_undonated_state_threading": _JNP,
        "test_large_constant_fires_and_names_block": _JNP,
        "test_dtype_promotion_fires_on_nonweak_scalar_only": _JNP,
        "test_check_error_raises_and_evicts": _JNP,
        "test_findings_surface_in_telemetry": _JNP,
        "test_dump_and_check_graph_report": _JNP,
    }, ["test_check_graph_zoo_error_mode_reports_per_model"]),
    "test_slo.py": (19, {}, []),
    "test_goodput.py": (11, {}, []),
    "test_scope.py": (14, {}, []),
    "test_ledger.py": (16, {
        "test_config_fingerprint_tracks_perf_knobs": _PORT_KNOB,
    }, _LEDGER_REPORT),
    "test_fleet.py": (17, {}, []),
}


def run_file(name):
    """The harness's JSON line for one JAX test file (and its exit
    code)."""
    _, _, deselected = FILES[name]
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


@pytest.mark.parametrize("name", list(FILES))
def test_jax_unit_tests_pass_on_the_port(runs, name):
    total, excluded, _ = FILES[name]
    code, res = runs[name].result()
    failed = sorted(f.split("::")[-1] for f in res["failures"])
    assert failed == sorted(excluded), res["failures"]
    assert res["passed"] == total - len(excluded)
    assert res["skipped"] == 0
    assert code == (1 if excluded else 0)
    assert not any(res["launches"].values()), res["launches"]
