"""PyTorch port, the observability layer against the JAX package on the
CPU, float32, with every observer on (telemetry, trace with every step
sampled and the skew probe every step, diagnostics installed, the NaN
sentinel):

  * a 2-layer BERT (`bert_tiny_config`) `ShardedTrainer` with LAMB, 3
    steps from the same weights and batch (the JAX trainer on a mesh of
    one device, so neither side reduces gradients): the same telemetry
    event kinds in the same order, the same counter values and
    histogram counts (not times), the same span names at each step, and
    the same flight-ring step records (step and lr equal, loss within
    1e-5);
  * a tiny GPT `Server` (an injected clock, one request past its
    deadline): the same request, token and deadline counters and the
    same TTFT and queue-wait counts, equal to `Server.stats()`;
  * with every knob off, a port step starts no thread and records
    nothing;
  * a forked DataLoader worker in a process with diagnostics installed
    (a watchdog thread running) and a module lock held by another
    thread at the fork neither hangs nor touches CUDA.
"""
import gc
import threading

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import diagnostics as diag_j
from mxnet_tpu import nd, parallel
from mxnet_tpu import serve as serve_j
from mxnet_tpu import telemetry as tele_j
from mxnet_tpu import trace as trace_j
from mxnet_tpu.models import bert as bert_j
from mxnet_tpu.models import gpt as gpt_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import config as config_t
from mxnet_tpu_torch import diagnostics as diag_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import serve as serve_t
from mxnet_tpu_torch import telemetry as tele_t
from mxnet_tpu_torch import trace as trace_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import bert as bert_t
from mxnet_tpu_torch.models import gpt as gpt_t

_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")
_COUNTERS = ("compile_total", "recompile_total", "hybrid_cache_hits_total",
             "hybrid_cache_misses_total")
_HISTOGRAMS = ("compile_seconds", "trainer_step_seconds")
_GAUGES = ("step_skew_seconds", "straggler_rank")
_PKGS = {"jax": (tele_j, trace_j, diag_j, config_j),
         "port": (tele_t, trace_t, diag_t, config_t)}


def _arm(pkg, tmp_path):
    tele, trace, diag, config = _PKGS[pkg]
    for m in (tele, trace, diag):
        m.reset()
    tele.enable()
    config.set("nan_sentinel", True)
    trace.enable(sample_every=1, skew_every=1)
    diag.install(diagnostics_dir=str(tmp_path / pkg), rank=0)


def _disarm(pkg):
    tele, trace, diag, config = _PKGS[pkg]
    diag.uninstall()
    trace.disable()
    tele.disable()
    for m in (tele, trace, diag):
        m.reset()
    config.reset()


def _observed(pkg):
    """What the observers saw: event kinds, counters, histogram counts,
    gauges, span names by step, and the flight ring."""
    tele, trace, diag, _ = _PKGS[pkg]
    by_step = {}
    for s in trace.spans():
        by_step.setdefault(s.get("step"), []).append(s["name"])
    return {
        "kinds": [e["kind"] for e in tele.events()],
        "counters": {n: tele.get(n).value for n in _COUNTERS},
        "histograms": {n: tele.get(n).count for n in _HISTOGRAMS},
        "gauges": {n: tele.get(n).value for n in _GAUGES},
        "spans": {k: sorted(v) for k, v in by_step.items()},
        "ring_kinds": [r["kind"] for r in diag.records()],
        "ring_steps": [(r["step"], r["lr"], r["loss"], r["compiled"])
                       for r in diag.records("step")],
    }


@pytest.fixture(scope="module")
def bert_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs")
    b = bert_j.make_synthetic_batch(bert_j.bert_tiny_config(), 8, 32, 6,
                                    seed=1)
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    parallel.make_mesh(dp=1, devices=jax.devices()[:1])
    jm = bert_j.BERTForPretraining(bert_j.bert_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    jt = parallel.ShardedTrainer(jm, bert_j.bert_pretrain_loss, "lamb",
                                 dict(opt))
    _arm("jax", tmp)
    try:
        for _ in range(3):
            jt.step([nd.array(b[k]) for k in _DATA],
                    [nd.array(b[k]) for k in _LABELS])
        jax_seen = _observed("jax")
    finally:
        _disarm("jax")
        parallel.set_mesh(None)

    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    tt = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                   dict(opt), device="cpu")
    _arm("port", tmp)
    try:
        for _ in range(3):
            tt.step([b[k] for k in _DATA], [b[k] for k in _LABELS])
        port_seen = _observed("port")
    finally:
        _disarm("port")
    return jax_seen, port_seen


def test_trainer_events_in_the_jax_order(bert_runs):
    jax_seen, port_seen = bert_runs
    assert port_seen["kinds"] == jax_seen["kinds"]
    assert port_seen["kinds"].count("step") == 2
    assert port_seen["ring_kinds"] == jax_seen["ring_kinds"]


def test_trainer_counters_and_histogram_counts_as_jax(bert_runs):
    jax_seen, port_seen = bert_runs
    for key in ("counters", "histograms", "gauges"):
        assert port_seen[key] == jax_seen[key], key
    assert port_seen["counters"]["compile_total"] == 1
    assert port_seen["histograms"]["trainer_step_seconds"] == 2


def test_trainer_spans_per_step_as_jax(bert_runs):
    jax_seen, port_seen = bert_runs
    assert port_seen["spans"] == jax_seen["spans"]
    assert port_seen["spans"][1] == ["step.compile"]
    assert port_seen["spans"][3] == ["step.dispatch", "step.fence"]


def test_trainer_ring_records_as_jax(bert_runs):
    jax_seen, port_seen = bert_runs
    got, want = port_seen["ring_steps"], jax_seen["ring_steps"]
    assert [(s, c) for s, _, _, c in got] == [(s, c) for s, _, _, c in want]
    np.testing.assert_allclose([lr for _, lr, _, _ in got],
                               [lr for _, lr, _, _ in want], rtol=1e-7)
    np.testing.assert_allclose([x for _, _, x, _ in got],
                               [x for _, _, x, _ in want], atol=1e-5,
                               rtol=0)


# -- serving -----------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


_SERVE_COUNTERS = ("serve_tokens_total", "serve_deadline_missed_total",
                   "serve_degraded_total")


def _serve_run(pkg, model):
    tele = _PKGS[pkg][0]
    serve = serve_j if pkg == "jax" else serve_t
    tele.reset()
    tele.enable()
    try:
        clk = _FakeClock()
        srv = serve.Server(model, slots=2, clock=clk)
        rs = np.random.RandomState(0)
        reqs = [srv.submit(rs.randint(0, 128, (n,)).astype(np.int32),
                           max_new_tokens=m, deadline_ms=d)
                for n, m, d in ((3, 6, None), (5, 4, None), (4, 30, 100))]
        while srv.busy():
            srv.step()
            clk.t += 0.02
        st = srv.stats()
        reqs_total = tele.get("serve_requests_total")
        # series other tests left at zero (reset keeps them) read alike
        out = {"outcomes": {k: c.value for k, c in
                            sorted(reqs_total._children.items())
                            if c.value},
               "counters": {n: tele.get(n).value for n in _SERVE_COUNTERS},
               "ttft": tele.get("serve_ttft_seconds").count,
               "queue_wait": tele.get("serve_queue_wait_seconds").count,
               "states": [r.state for r in reqs]}
        return out, st
    finally:
        tele.disable()
        tele.reset()


def test_server_counters_as_jax():
    parallel.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    try:
        want, _ = _serve_run("jax", jm)
    finally:
        gc.collect()
        parallel.set_mesh(None)
    got, st = _serve_run("port", tm)
    assert got == want
    assert got["states"] == ["done", "done", "expired"]
    assert got["counters"]["serve_tokens_total"] == st["tokens"]
    assert got["counters"]["serve_deadline_missed_total"] == st["expired"]
    outcomes = {k[0][1]: v for k, v in got["outcomes"].items()}
    assert outcomes == {"completed": st["completed"],
                        "expired": st["expired"]}
    assert got["ttft"] == got["queue_wait"] == 3


# -- the disabled fast path --------------------------------------------------

def test_everything_off_starts_no_thread_and_records_nothing():
    assert not (tele_t.enabled() or trace_t.enabled() or diag_t.enabled())
    with mxt.cpu():
        tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(),
                                       device="cpu")
        tr = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss,
                                       "lamb", {"learning_rate": 1e-3},
                                       device="cpu")
    b = bert_t.make_synthetic_batch(bert_t.bert_tiny_config(), 4, 16, 3,
                                    seed=0)
    threads = set(threading.enumerate())
    for _ in range(2):
        tr.step([b[k] for k in _DATA], [b[k] for k in _LABELS])
    assert set(threading.enumerate()) == threads
    assert tele_t.events() == [] and tele_t.get("compile_total").value == 0
    assert trace_t._buf is None and diag_t._ring is None
    assert diag_t._watchdog is None


# -- fork safety ---------------------------------------------------------------

class _Probe:
    """A dataset whose items report, from inside the worker, whether
    CUDA is initialised there and whether a watchdog is set; touching
    the telemetry registry takes its module lock."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        tele_t.counter("obs_fork_probe_total").inc()
        return np.array([float(torch.cuda.is_initialized()),
                         float(diag_t._watchdog is not None), float(i)],
                        np.float32)


def test_forked_worker_with_diagnostics_armed(tmp_path):
    from mxnet_tpu_torch.gluon.data import DataLoader
    config_t.set("watchdog_deadline_s", 30.0)
    config_t.set("dataloader_timeout", 60.0)
    diag_t.install(diagnostics_dir=str(tmp_path), rank=0)
    tele_t.enable()
    held, release = threading.Event(), threading.Event()

    def hold_registry_lock():
        with tele_t._lock:
            held.set()
            release.wait(30)

    holder = threading.Thread(target=hold_registry_lock, daemon=True)
    holder.start()
    try:
        assert diag_t._watchdog is not None and held.wait(10)
        with mxt.cpu():
            loader = DataLoader(_Probe(), batch_size=2, num_workers=2)
            it = iter(loader)
            first = next(it)          # the workers forked with the lock held
            release.set()
            batches = [first] + list(it)
        rows = np.concatenate([b.asnumpy() for b in batches])
        assert rows.shape == (4, 3)
        assert not rows[:, 0].any(), "a worker initialised CUDA"
        assert not rows[:, 1].any(), "a worker kept the parent's watchdog"
        assert sorted(rows[:, 2]) == [0.0, 1.0, 2.0, 3.0]
        assert diag_t._watchdog is not None     # the parent's still runs
    finally:
        release.set()
        holder.join(10)
        diag_t.uninstall()
        diag_t.reset()
        tele_t.disable()
        tele_t.reset()
        config_t.reset()
