"""PyTorch port, the serving request lifecycle against the JAX package:
deadlines (an injected clock), the default-deadline knob, cancellation
(by call, by the `cancel@req:N` fault, and the step-less spec that waits
for its target), dispatch retry, a scheduler error, stop, the burst and
slow-client drills (the cases of tests/unittest/test_serve.py), each
with the same verdicts, tokens and stats counters from both packages'
`Server` over the same gpt_tiny weights (CPU, float32); then the paged
server's expiry and cancellation returning their pages, and the port's
`RetryPolicy`, `FaultInjector.parse` and `config.set` against the JAX
package's.
"""
import gc
import random
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import memsafe as memsafe_j
from mxnet_tpu import pages as pages_j
from mxnet_tpu import parallel
from mxnet_tpu import resilience as res_j
from mxnet_tpu import serve as serve_j
from mxnet_tpu.models import gpt as gpt_j

from mxnet_tpu_torch import config as config_t
from mxnet_tpu_torch import memsafe as memsafe_t
from mxnet_tpu_torch import resilience as res_t
from mxnet_tpu_torch import serve as serve_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import gpt as gpt_t

_VOCAB = 128


@pytest.fixture(autouse=True)
def _clean():
    yield
    # drop this test's JAX servers now: a live one stays in
    # mxnet_tpu.serve's registry and shows in tests of other files
    # that share the worker (test_scope.py's /statusz)
    gc.collect()
    serve_j.disable()
    pages_j.disable()
    res_j.uninstall()
    memsafe_j.reset()
    memsafe_j.disable()
    config_j.reset()
    res_t.disable()
    memsafe_t.reset()
    config_t.reset()


@pytest.fixture(scope="module")
def sides():
    """(JAX side, port side): each a dict of its serve, config and
    resilience modules and its gpt_tiny model, the same weights."""
    parallel.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    return (dict(serve=serve_j, config=config_j, res=res_j, model=jm),
            dict(serve=serve_t, config=config_t, res=res_t, model=tm))


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _both(sides, scenario):
    """Run `scenario(side)` on the JAX side and the port's; the port's
    result must equal the JAX package's. Returns the port's."""
    ref, got = (scenario(s) for s in sides)
    assert got == ref
    return got


_STATS = ("submitted", "completed", "rejected", "shed", "expired",
          "cancelled", "failed", "tokens", "requeues", "degraded", "retries")


def _counters(srv):
    st = srv.stats()
    return {k: st[k] for k in _STATS}


def _outcome(r):
    return r.state, r.verdict, list(r.tokens)


# -- deadlines ---------------------------------------------------------------

def _deadline_mid_generation(s):
    clk = _FakeClock()
    srv = s["serve"].Server(s["model"], slots=2, clock=clk)
    r = srv.submit(_prompt(3), max_new_tokens=30, deadline_ms=100)
    while srv.busy():
        srv.step()
        clk.t += 0.02          # the deadline passes mid-generation
    return _outcome(r), srv._groups == {}, _counters(srv)


def _deadline_in_queue(s):
    clk = _FakeClock()
    srv = s["serve"].Server(s["model"], slots=1, clock=clk)
    a = srv.submit(_prompt(3), max_new_tokens=20)
    b = srv.submit(_prompt(3), max_new_tokens=4, deadline_ms=50)
    srv.step()                 # a takes the only slot; b waits
    clk.t = 1.0
    srv.step()
    mid = _outcome(b)
    srv.drain()
    return mid, _outcome(a), _counters(srv)


def _default_deadline_knob(s):
    clk = _FakeClock()
    s["config"].set("serve_deadline_ms", 80.0)
    srv = s["serve"].Server(s["model"], slots=2, clock=clk)
    r = srv.submit(_prompt(3), max_new_tokens=30)
    deadline = r.deadline
    clk.t = 1.0
    srv.step()
    return round(deadline, 9), _outcome(r), _counters(srv)


_DEADLINES = {"mid_generation": _deadline_mid_generation,
              "in_queue": _deadline_in_queue,
              "default_knob": _default_deadline_knob}


@pytest.mark.parametrize("case", sorted(_DEADLINES))
def test_deadlines_match_jax(sides, case):
    got = _both(sides, _DEADLINES[case])
    if case == "mid_generation":
        (state, verdict, toks), reclaimed, st = got
        assert state == serve_t.EXPIRED and verdict.startswith("504")
        assert "mid-generation" in verdict and 0 < len(toks) < 30
        assert reclaimed and st["expired"] == 1
    elif case == "in_queue":
        (state, verdict, _), (a_state, _, a_toks), _ = got
        assert state == serve_t.EXPIRED and "queue" in verdict
        assert a_state == serve_t.DONE and len(a_toks) == 20
    else:
        assert got[0] == pytest.approx(0.08)
        assert got[1][0] == serve_t.EXPIRED


def test_pages_freed_by_expiry_admit_same_step(sides):
    """A request expiring frees its slot and caches for an admission in
    the SAME step, at a capacity of exactly one 32-bucket — each side's
    capacity from its own accounting (the port measures no execution
    peak on the CPU)."""
    def run(s):
        clk = _FakeClock()
        srv = s["serve"].Server(s["model"], slots=1, clock=clk)
        cap = srv._params_bytes + srv._cache_bytes(32) \
            + (srv._exec_peak(32) or 0) + 1000
        s["config"].set("device_bytes_limit", cap)
        a = srv.submit(_prompt(4), max_new_tokens=20, deadline_ms=50)
        srv.step()
        first = a.state
        clk.t = 1.0
        b = srv.submit(_prompt(4), max_new_tokens=4)
        srv.step()                  # one step: evict a AND admit b
        mid = (a.state, b.state)
        srv.drain()
        return first, mid, _outcome(a), _outcome(b), b.degraded, \
            _counters(srv)

    got = _both(sides, run)
    assert got[0] == serve_t.RUNNING
    assert got[1] == (serve_t.EXPIRED, serve_t.RUNNING)
    assert got[3][0] == serve_t.DONE and got[4] is None


def test_by_id_pruned_after_terminal(sides):
    def run(s):
        srv = s["serve"].Server(s["model"], slots=2)
        reqs = [srv.submit(_prompt(4, i), max_new_tokens=4)
                for i in range(3)]
        srv.drain()
        return [_outcome(r) for r in reqs], srv._by_id == {}

    outs, pruned = _both(sides, run)
    assert pruned and all(o[0] == serve_t.DONE for o in outs)


# -- cancellation ------------------------------------------------------------

def _cancel_call(s):
    srv = s["serve"].Server(s["model"], slots=2)
    r = srv.submit(_prompt(3), max_new_tokens=20)
    other = srv.submit(_prompt(5, 1), max_new_tokens=6)
    for _ in range(6):
        srv.step()
    srv.cancel(r.id)
    srv.drain()
    return _outcome(r), _outcome(other), srv._groups == {}, _counters(srv)


def _cancel_fault(s):
    s["config"].set("fault_inject", "cancel@req:0@step:4")
    s["res"].enable()
    srv = s["serve"].Server(s["model"], slots=2)
    r = srv.submit(_prompt(3), max_new_tokens=20)
    srv.drain()
    return _outcome(r), srv._groups == {}, _counters(srv)


def _cancel_waits_for_target(s):
    s["config"].set("fault_inject", "cancel@req:0")
    s["res"].enable()
    srv = s["serve"].Server(s["model"], slots=2)
    for _ in range(3):
        srv.step()              # idle ticks before any submission
    r = srv.submit(_prompt(4), max_new_tokens=8)
    srv.drain()
    return _outcome(r), _counters(srv)


_CANCELS = {"by_call": _cancel_call, "fault_at_step": _cancel_fault,
            "fault_waits_for_target": _cancel_waits_for_target}


@pytest.mark.parametrize("case", sorted(_CANCELS))
def test_cancellation_matches_jax(sides, case):
    got = _both(sides, _CANCELS[case])
    state, verdict, toks = got[0]
    assert state == serve_t.CANCELLED and verdict.startswith("499")
    if case != "fault_waits_for_target":
        assert 0 < len(toks) < 20       # cancelled between decode steps
        assert got[-2] is True          # slot evicted, caches reclaimed


# -- dispatch retry, scheduler failure, stop ---------------------------------

def _flaky(s, srv, fails, exc):
    """Make the next `fails["n"]` dense dispatches raise `exc`."""
    if s["serve"] is serve_j:
        orig = srv._runner

        def runner(bucket):
            run = orig(bucket)

            def wrapped(*args):
                if fails["n"] > 0:
                    fails["n"] -= 1
                    raise exc
                return run(*args)

            wrapped.aot_exec_peak = run.aot_exec_peak
            return wrapped

        srv._runner = runner
        return
    model = s["model"]
    real = model.decode_step_slots

    def wrapped(*args):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise exc
        return real(*args)

    model.decode_step_slots = wrapped


def test_retry_transient_dispatch_matches_jax(sides):
    def run(s):
        srv = s["serve"].Server(s["model"], slots=2,
                                retry=s["res"].RetryPolicy(
                                    max_attempts=3, backoff_s=0.001))
        _flaky(s, srv, {"n": 2}, OSError("transient fabric glitch"))
        try:
            r = srv.submit(_prompt(4), max_new_tokens=4)
            srv.drain()
        finally:
            s["model"].__dict__.pop("decode_step_slots", None)
        return _outcome(r), _counters(srv)

    (state, _, toks), st = _both(sides, run)
    assert state == serve_t.DONE and len(toks) == 4
    assert st["retries"] == 2


def test_scheduler_error_fails_requests_not_clients(sides):
    """A non-transient dispatch error in the background scheduler ends
    every live request with a 500 verdict; a later submit fails fast."""
    def run(s):
        srv = s["serve"].Server(s["model"], slots=2,
                                retry=s["res"].RetryPolicy(max_attempts=1))
        _flaky(s, srv, {"n": 100}, ValueError("wedged runtime"))
        try:
            srv.start()
            r = srv.submit(_prompt(4), max_new_tokens=4)
            toks = r.result(timeout=30)
            with pytest.raises(ValueError):
                srv.raise_if_failed()
            r2 = srv.submit(_prompt(4), max_new_tokens=4)
            srv.stop()
        finally:
            s["model"].__dict__.pop("decode_step_slots", None)
        return (r.state, r.verdict, toks.size, r2.state, r2.verdict,
                _counters(srv))

    got = _both(sides, run)
    assert got[0] == serve_t.FAILED and got[1].startswith("500")
    assert got[2] == 0 and got[3] == serve_t.FAILED


def test_stop_finishes_outstanding(sides):
    def run(s):
        srv = s["serve"].Server(s["model"], slots=1)
        reqs = [srv.submit(_prompt(4), max_new_tokens=30) for _ in range(3)]
        srv.step()
        srv.stop()
        r2 = srv.submit(_prompt(4), max_new_tokens=4)
        return [_outcome(r) for r in reqs], _outcome(r2), _counters(srv)

    outs, after, _ = _both(sides, run)
    assert all(o[0] == serve_t.CANCELLED and "server stopped" in o[1]
               for o in outs)
    assert after[0] == serve_t.SHED and "server stopped" in after[1]


# -- fault drills: burst, slow client ----------------------------------------

def test_fault_burst_spec_matches_jax(sides):
    def run(s):
        s["config"].set("fault_inject", "burst:3@step:2")
        s["res"].enable()
        srv = s["serve"].Server(s["model"], slots=4, queue_depth=2,
                                shed="reject")
        extra = []
        srv.on_burst = lambda n: extra.extend(
            srv.submit(_prompt(5, i), max_new_tokens=6) for i in range(n))
        r = srv.submit(_prompt(4), max_new_tokens=10)
        srv.drain()
        return _outcome(r), [_outcome(e) for e in extra], _counters(srv)

    main, extra, st = _both(sides, run)
    assert main[0] == serve_t.DONE and len(extra) == 3
    assert all(e[0] in serve_t.TERMINAL for e in extra)


def test_fault_slow_client_does_not_wedge_scheduler(sides):
    """A consumer stalling 150 ms a token (1.5 s for its 10) never slows
    the scheduler: the drain ends while the consumer is still reading,
    and the consumer still gets every token."""
    def run(s):
        s["config"].set("fault_inject", "slow_client:150")
        s["res"].enable()
        srv = s["serve"].Server(s["model"], slots=2)
        r = srv.submit(_prompt(3), max_new_tokens=10)
        got = []
        th = threading.Thread(target=lambda: got.extend(r.stream()))
        th.start()
        time.sleep(0.05)            # the consumer takes the spec first
        srv.drain()
        reading = th.is_alive()
        th.join(timeout=30)
        return _outcome(r), got, reading

    ref, port = (run(s) for s in sides)
    assert port[:2] == ref[:2]
    assert port[0][0] == serve_t.DONE and port[1] == port[0][2]
    assert port[2]          # the scheduler finished before the client


# -- the paged server: expiry and cancellation return their pages ------------

def test_paged_expiry_and_cancel_return_pages(sides):
    def run(s):
        clk = _FakeClock()
        srv = s["serve"].Server(s["model"], slots=4, pages="on",
                                page_size=4, prefill_chunk=4, clock=clk)
        total = srv._pool.free_pages()
        late = srv.submit(_prompt(9, 1), max_new_tokens=20, deadline_ms=50)
        gone = srv.submit(_prompt(6, 2), max_new_tokens=20)
        keep = srv.submit(_prompt(7, 3), max_new_tokens=8)
        for _ in range(6):
            srv.step()
        clk.t = 1.0
        srv.cancel(gone)
        srv.drain()
        held = sum(1 for p in range(srv._pool.num_pages)
                   if srv._pool.refcount[p] > 0)
        free = srv.stats()["pool_pages_free"]
        srv.stop()
        return (_outcome(late), _outcome(gone), _outcome(keep),
                free + held == total, srv._pool.free_pages() == total,
                _counters(srv))

    late, gone, keep, drained, cleared, _ = _both(sides, run)
    assert late[0] == serve_t.EXPIRED and gone[0] == serve_t.CANCELLED
    assert keep[1] == "200 ok" and drained and cleared


# -- RetryPolicy, FaultInjector.parse, config.set ----------------------------

def test_retry_policy_delay_matches_jax():
    kw = dict(max_attempts=5, backoff_s=0.5, max_backoff_s=3.0)
    ref = res_j.RetryPolicy(rng=random.Random(3), **kw)
    got = res_t.RetryPolicy(rng=random.Random(3), **kw)
    assert [got.delay(a) for a in range(6)] == \
        [ref.delay(a) for a in range(6)]
    assert got.retryable == ref.retryable == (OSError, ConnectionError,
                                              TimeoutError)
    sleeps = []
    pol = res_t.RetryPolicy(max_attempts=3, backoff_s=0.01, jitter=0.0,
                            sleep=sleeps.append)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("slow")
        return "ok"

    assert pol.call(flaky) == "ok" and sleeps == [0.01, 0.02]
    with pytest.raises(RuntimeError):      # a CUDA error is not retried
        pol.call(lambda: (_ for _ in ()).throw(RuntimeError("CUDA error")))


@pytest.mark.parametrize("spec", [
    "slow_client:200", "burst:8@step:3", "cancel@req:2",
    "cancel@req:2@step:5@rank:0", "burst:4@step:1@every_restart,"
    "slow_client:5", "kill@step:3@rank:1, oom@step:2"])
def test_fault_injector_parse_matches_jax(spec):
    assert res_t.FaultInjector.parse(spec)._specs == \
        res_j.FaultInjector.parse(spec)._specs


@pytest.mark.parametrize("spec", ["nosuch@step:1", "burst:2@when:3"])
def test_fault_injector_parse_errors_match_jax(spec):
    with pytest.raises(ValueError) as ej:
        res_j.FaultInjector.parse(spec)
    with pytest.raises(ValueError) as et:
        res_t.FaultInjector.parse(spec)
    assert str(et.value).split(" (know")[0] == str(ej.value).split(" (know")[0]


def test_config_set_matches_jax(monkeypatch):
    for name in ("serve_deadline_ms", "serve_min_new_tokens", "pages_spec_k",
                 "retry_max_attempts", "retry_backoff_s",
                 "retry_max_backoff_s", "device_bytes_limit",
                 "memory_headroom_warn", "fault_inject", "serve_shed",
                 "pages", "serve_slots", "pages_prefill_chunk"):
        assert config_t.get(name) == config_j.get(name), name
    for name, value in (("serve_shed", "oldest"), ("pages", "on"),
                        ("device_bytes_limit", "4096"),
                        ("serve_deadline_ms", 12)):
        config_j.set(name, value)
        config_t.set(name, value)
        assert config_t.get(name) == config_j.get(name), name
    for name, value in (("serve_shed", "drop"), ("pages", "maybe")):
        with pytest.raises(ValueError) as ej:
            config_j.set(name, value)
        with pytest.raises(ValueError) as et:
            config_t.set(name, value)
        assert str(et.value) == str(ej.value)
    config_t.reset()
    monkeypatch.setenv("MXNET_TPU_PAGES_SPEC_K", "7")
    assert config_t.get("pages_spec_k") == 7
    config_t.set("pages_spec_k", 2)
    assert config_t.get("pages_spec_k") == 2      # set() beats the env
