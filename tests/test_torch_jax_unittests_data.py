"""PyTorch port held to the JAX package's unit tests of the input-to-device
layer (`dataflow`: prefetch_to_mesh, BucketPad, the trainer's
step_async and device step counter), the Estimator fit loop and
`gluon.contrib`, with the runner of
`tests/test_torch_jax_unittests_more.py` (a file of its own so that
`--dist loadfile` can put it on another worker): each file runs
unchanged through `python -m mxnet_tpu_torch.run_example --device cpu
--pytest tests/unittest/<file>.py -m "not slow"` in a fresh process,
which fails if any module of the JAX package loaded. One case a file:
its failures must be exactly the named exclusions, and its pass count
the file's count less those.

The exclusions of `test_dataflow.py`:
  * jit's executable cache: a learning-rate change re-jits (the port
    compiles nothing, and its learning rate is a host float, no part of
    a step's signature);
  * the traced learning rate (`FunctionalOptimizer.lr_traced`): the
    port computes every learning rate on the host;
  * the test's own use of JAX: the fence test counts calls of a
    patched `jax.block_until_ready`, which the port never calls (its
    fences are `ShardedTrainer._fence`, counted in `fences`); the
    sharding test reads `NDArray._data.sharding`, a JAX array's
    attribute, where the port's `_data` is a host numpy copy;
  * the compile-cache knob (`compile_cache_dir`, XLA's persistent
    cache): no meaning in the port, which compiles nothing.

Deselected (neither run nor counted):
`test_overlap_speedup_with_slow_host_iterator`, a wall-clock ratio
between two loops of sleeps and steps. On the CPU it passed in ten
copies run at once on eight cores; on an H100 (`chip_smoke.py` phase 46)
it gave 1.35x against its 1.5x in one run and passed in the next: the
step takes 2 ms there, the floor of its calibrated sleep, and the
loops' host work is of the same order. `tests/test_torch_dataflow.py`
holds the overlap by events instead (batch i+1 is staged while step i
runs).

The files run one at a time (one intra-op thread each).
"""
import concurrent.futures

import pytest

import test_torch_jax_unittests_more as _runner

_JIT_CACHE = "jit's executable cache: the port compiles nothing"
_TRACED_LR = "a traced learning rate: the port's is a host float"
_JNP = "the test's own use of JAX"
_COMPILE_CACHE = "the compile_cache_dir knob (XLA's cache)"

# file -> (tests run, {expected failure: reason}, deselected tests)
FILES = {
    "test_dataflow.py": (23, {
        "test_constant_lr_change_rejits_instead_of_stale_rate": _JIT_CACHE,
        "test_scheduler_field_mutation_rejits": _JIT_CACHE,
        "test_traced_lr_matches_host_lr_for_builtin_schedulers": _TRACED_LR,
        "test_fence_every_knob_controls_sync_step_fencing": _JNP,
        "test_prefetch_stages_with_trainer_shardings": _JNP,
        "test_ensure_compile_cache_wires_jax_and_is_idempotent":
            _COMPILE_CACHE,
        "test_ensure_compile_cache_failure_never_claims_success":
            _COMPILE_CACHE,
    }, ["test_overlap_speedup_with_slow_host_iterator"]),
    "test_estimator.py": (4, {}, []),
    "test_gluon_contrib.py": (6, {}, []),
}


@pytest.fixture(scope="module")
def runs():
    # one file at a time: the suite's other harnesses run two
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    futures = {name: pool.submit(_runner.run_file, name, FILES)
               for name in FILES}
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("name", list(FILES))
def test_jax_unit_tests_pass_on_the_port(runs, name):
    _runner.check_file(FILES, name, *runs[name].result())
