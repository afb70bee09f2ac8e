"""PyTorch port, `fleet`: two in-process port replicas (each a
`serve.Server` behind a `fleet.ReplicaEndpoint`) on gpt_tiny weights
carried from the JAX package stream the JAX `serve.Server`'s tokens
through the router, also across a mid-stream `kill()` failover;
`Router.predict_429` and `maybe_autoscale` decide as the JAX package's
do on seeded inputs; faults 21-23 (23: a request queued past the stall
bound keeps its replica); the `wedge_replica`, `slow_replica` and
`kill_replica` drills; fleet=off as one module bool; the router half and
the launcher load without torch; and the port's launcher on the CPU, run
by file path: it maps no torch library, two `--device cpu` replicas, one
SIGKILLed mid-request (the stream completes, equal to its reference),
`restarts.jsonl`'s pair, and rc 143 after SIGTERM with every replica
drained.

Time (one CPU worker): the file ~50 s; the launcher test ~11 s, the
kill_replica, knob, entry-point and wedge tests ~3-4 s each, the rest
1-3 s.
"""
import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import chip_smoke

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import fleet as fleet_j
from mxnet_tpu import parallel
from mxnet_tpu import serve as serve_j
from mxnet_tpu.models import gpt as gpt_j

from mxnet_tpu_torch import config, fleet, resilience, scope, serve, weights
from mxnet_tpu_torch.models import gpt as gpt_t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_VOCAB = 128
_PAGED = dict(pages="on", page_size=4, prefill_chunk=4)
LAUNCH_TIMEOUT_S = 150          # the launcher test's own limit


@pytest.fixture(autouse=True)
def _clean():
    yield
    gc.collect()            # no JAX server outlives its test (test_scope)
    fleet.disable()
    serve.disable()
    resilience.uninstall()
    config.reset()
    serve_j.disable()
    config_j.reset()


@pytest.fixture(scope="module")
def models():
    """The JAX gpt_tiny and two port models carrying its weights (one a
    replica)."""
    parallel.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    ports = []
    for _ in range(2):
        tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
        weights.load_named_arrays(tm, arrays)
        ports.append(tm)
    return jm, ports


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


def _jax_tokens(jm, specs, **server_kw):
    """The JAX package's serve.Server on the same weights: one request a
    (prompt, submit kwargs) spec."""
    srv = serve_j.Server(jm, slots=2, **server_kw)
    reqs = [srv.submit(p, **kw) for p, kw in specs]
    srv.drain()
    out = [list(r.tokens) for r in reqs]
    assert [r.verdict for r in reqs] == ["200 ok"] * len(reqs)
    srv.stop()
    return out


class _Gang:
    """Two in-process port replicas behind one Router."""

    def __init__(self, models, start=(0, 1), server_kw=None, **router_kw):
        server_kw = dict(server_kw or {})
        slots = server_kw.pop("slots", 2)
        self.servers = [serve.Server(m, slots=slots, **server_kw)
                        for m in models]
        for i in start:
            self.servers[i].start()
        self.eps = [fleet.ReplicaEndpoint(s, replica=i)
                    for i, s in enumerate(self.servers)]
        router_kw.setdefault("connect_timeout_s", 2.0)
        router_kw.setdefault("stall_timeout_s", 120.0)
        self.router = fleet.Router(
            {i: ep.url for i, ep in enumerate(self.eps)}, **router_kw)
        self.router.poll_once()

    def close(self):
        self.router.stop()
        for ep in self.eps:
            ep.stop()
        for s in self.servers:
            s.stop()


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# -- the port's fleet against the JAX server ---------------------------------

@pytest.mark.parametrize("server_kw", [{}, _PAGED], ids=["dense", "paged"])
def test_routed_streams_equal_jax_server(models, server_kw):
    jm, ports = models
    specs = [(_prompt(n, seed=n), dict(max_new_tokens=8, seed=i,
                                       temperature=0.8 if i % 2 else 0.0,
                                       top_k=10 if i % 2 else 0))
             for i, n in enumerate((5, 9, 6, 12))]
    ref = _jax_tokens(jm, specs, **server_kw)
    gang = _Gang(ports, server_kw=server_kw)
    try:
        reqs = [gang.router.submit(p, **kw) for p, kw in specs]
        got = [r.result(timeout=60) for r in reqs]
    finally:
        gang.close()
    assert got == ref
    assert all(r.state == serve.DONE and r.verdict == "200 ok"
               for r in reqs)
    assert {r.replicas_tried[0] for r in reqs} == {0, 1}


def test_kill_failover_mid_stream_equals_jax_server(models):
    """A replica killed mid-generation: the router replays the request on
    the survivor from its high-water mark, and the client's stream equals
    the JAX server's tokens, none repeated."""
    jm, ports = models
    p = _prompt(8, seed=2)
    ref = _jax_tokens(jm, [(p, dict(max_new_tokens=24))])[0]
    gang = _Gang(ports)
    try:
        gang.eps[0]._slow_ms, gang.eps[0]._slow_checked = 25.0, True
        gang.router.drain(1, remote=False)     # pin placement to 0
        r = gang.router.submit(p, max_new_tokens=24)
        _wait(lambda: len(r.tokens) >= 3, what="the stream to start")
        pre_kill = len(r.tokens)
        gang.router.undrain(1, remote=False)
        gang.eps[0].kill()
        assert r.result(timeout=60) == ref
    finally:
        gang.close()
    assert r.state == serve.DONE and r.verdict == "200 ok"
    assert r.failovers == 1 and r.replicas_tried == [0, 1]
    assert pre_kill < 24


def test_fault21_router_counts_tree_held_pages_as_free(models):
    """Fault 21: a paged replica's prefix tree keeps the pages of served
    prompts, and admission evicts them on demand, but the admission hints
    published only the free list, so the router predicted a 429 for a
    request the replica would admit (phase 54 on the card: 15 of 32
    requests of the failover pass dropped). The JAX server publishes the
    same free count and its router refuses; the port's hints add the
    tree-only pages, its router places the request, and it is served."""
    jm, ports = models
    kw = dict(pages="on", page_size=4, prefill_chunk=4, pool_pages=24)
    config.set("device_bytes_limit", 1 << 40)     # a known capacity
    config_j.set("device_bytes_limit", 1 << 40)
    warm = [(_prompt(20, seed=40 + i), dict(max_new_tokens=4))
            for i in range(4)]
    probe = _prompt(30, seed=60)
    need = probe.size + 16
    srv_j = serve_j.Server(jm, slots=2, **kw)
    for p, k in warm:
        srv_j.submit(p, **k)
    srv_j.drain()
    gang = _Gang(ports, server_kw=kw)
    try:
        for srv in gang.servers:
            for p, k in warm:
                srv.submit(p, **k)
        _wait(lambda: not any(s.busy() for s in gang.servers),
              what="the warm-up")
        hints = gang.servers[0].admission_hints()
        assert hints["pool_pages_free"] == \
            srv_j.admission_hints()["pool_pages_free"]
        free, tree = hints["pool_pages_free"], hints["pool_pages_reclaimable"]
        assert free < -(-need // 4) <= free + tree
        st = {"admission": hints, "stats": gang.servers[0].stats()}
        jax_view = dict(st, admission={k: v for k, v in hints.items()
                                       if k != "pool_pages_reclaimable"})
        assert fleet_j.Router.predict_429(jax_view, need) is True
        assert fleet.Router.predict_429(jax_view, need) is True
        assert fleet.Router.predict_429(st, need) is False
        gang.router.poll_once()
        r = gang.router.submit(probe, max_new_tokens=16)
        got = r.result(timeout=60)
    finally:
        gang.close()
        srv_j.stop()
    ref = _jax_tokens(jm, [(probe, dict(max_new_tokens=16))])[0]
    assert r.state == serve.DONE and r.verdict == "200 ok" and got == ref
    assert gang.router.counters["skipped_admission"] == 0


def test_fault22_a_burst_spreads_between_health_polls():
    """Fault 22: the router placed each request by the load of the last
    health poll, so a burst that arrives between two polls followed one
    stale reading onto one replica (phase 54 on the card: a replica that
    had just served a pass kept 0.15 cores busy while the other took the
    next 32 requests). The JAX router still does; the port's counts its
    own streams on a replica beyond the polled total as queued."""
    placed = {}
    for mod in (fleet, fleet_j):
        router = mod.Router({0: "http://x0", 1: "http://x1"})
        for rep, running in zip(router._replicas.values(), (2, 0)):
            rep.healthy = True
            rep.stats = {"admission": {"slots": 2},
                         "stats": {"queued": 0, "running": running}}
        placed[mod] = [router._place(10).rid for _ in range(12)]
    assert placed[fleet_j] == [1] * 12          # one stale reading
    port = placed[fleet]
    assert port[0] == 1 and abs(port.count(0) - port.count(1)) <= 2
    router = fleet.Router({0: "http://x0"})
    rep = router._replicas[0]
    rep.healthy, rep.stats = True, {"stats": {"queued": 0, "running": 0}}
    assert router._place(10) is rep and router._streams[0] == 1


# -- the router's decisions against the JAX router ---------------------------

def _statusz_grid(seed, n=300):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        max_len = int(rng.choice([None, 64, 128, 1024]) or 0) or None
        headroom = None if rng.rand() < 0.2 else int(rng.randint(0, 4000))
        if rng.rand() < 0.5:
            hints = {"pages": "on", "page_size": int(rng.choice([4, 16])),
                     "pool_pages_free": None if rng.rand() < 0.1
                     else int(rng.randint(0, 40))}
            stats = {}
        else:
            buckets = None if rng.rand() < 0.5 else sorted(
                int(b) for b in rng.choice([24, 48, 64, 96, 128], 3,
                                           replace=False))
            cands = buckets or [1 << k for k in range(0, 11)]
            hints = {"pages": "off", "buckets": buckets,
                     "bucket_cost": {str(b): int(rng.randint(0, 3000))
                                     for b in cands if rng.rand() < 0.8}}
            stats = {"buckets_allocated": [int(b) for b in cands
                                           if rng.rand() < 0.2]}
        hints.update(max_len=max_len, headroom_bytes=headroom, slots=2)
        out.append(({"admission": hints, "stats": stats},
                    int(rng.randint(1, 200))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_predict_429_equal_jax(seed):
    grid = _statusz_grid(seed)
    got = [fleet.Router.predict_429(st, need) for st, need in grid]
    ref = [fleet_j.Router.predict_429(st, need) for st, need in grid]
    assert got == ref
    assert 0 < sum(got) < len(got)          # both verdicts exercised


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_autoscale_decisions_equal_jax(seed):
    rng = np.random.RandomState(seed)
    routers = []
    for mod in (fleet, fleet_j):
        asked = []
        r = mod.Router({0: "http://x0", 1: "http://x1", 2: "http://x2"},
                       autoscale=True, autoscale_p99_ms=100.0,
                       autoscale_window_s=3.0, on_scale=asked.append,
                       clock=_Clock())
        routers.append((r, asked))
    t, regime, left = 0.0, None, 0
    for _ in range(300):
        t += float(rng.choice([0.5, 1.0, 2.5]))
        if left == 0:      # a load regime lasts a few polls
            regime = rng.choice(["hot", "quiet", "mixed"])
            left = int(rng.randint(1, 9))
        left -= 1
        p99s = {"hot": [400.0, 900.0], "quiet": [1.0, 20.0],
                "mixed": [1.0, 90.0, 900.0]}[regime]
        state = [(bool(rng.rand() < 0.95), bool(rng.rand() < 0.05),
                  float(rng.choice(p99s)),
                  0 if regime == "quiet" else int(rng.choice([0, 1, 4])))
                 for _ in range(3)]
        for r, _ in routers:
            for rep, (healthy, draining, p99, queued) in zip(
                    r._replicas.values(), state):
                rep.healthy, rep.draining = healthy, draining
                rep.stats = {"queue_wait_p99_ms": p99,
                             "stats": {"queued": queued}}
            r.maybe_autoscale(now=t)
    (port, asked_p), (jax, asked_j) = routers
    assert asked_p == asked_j
    assert {e["dir"] for e in port.scale_events} == {"up", "down"}
    assert port.scale_events == jax.scale_events


# -- fault drills --------------------------------------------------------------

def test_wedge_replica_drill_fails_over_on_the_stall_bound(models,
                                                           monkeypatch):
    """wedge_replica parks replica 0's scheduler mid-generation with the
    lock released: its health check still answers, its tokens stop, and
    the router's per-read stall bound moves the request to replica 1,
    which completes it equal to the JAX server's tokens."""
    jm, ports = models
    p = _prompt(6, seed=3)
    ref = _jax_tokens(jm, [(p, dict(max_new_tokens=16))])[0]
    # keep-alives every 0.75 s while a scheduler steps: the parked one
    # must still fall silent
    monkeypatch.setenv("MXNET_TPU_FLEET_STALL_TIMEOUT_MS", "3000")
    gang = _Gang(ports, start=(1,), stall_timeout_s=3.0)
    victim = gang.servers[0]
    try:
        # the survivor's idle ticks are past step 10 before the spec is
        # armed, so only the victim's scheduler can reach it
        _wait(lambda: gang.servers[1]._sched_step > 12, what="idle ticks")
        config.set("fault_inject", "wedge_replica@step:10")
        resilience.enable()
        gang.router.drain(1, remote=False)
        r = gang.router.submit(p, max_new_tokens=16)
        _wait(lambda: victim.stats()["queued"] == 1, what="the submit")
        victim.start()        # steps 1-6 prefill, 7-9 stream 3 tokens
        spec = resilience._injector._specs[0]
        _wait(lambda: spec["fired"], what="the wedge")
        gang.router.undrain(1, remote=False)
        with urllib.request.urlopen(gang.eps[0].url + "/healthz",
                                    timeout=5) as resp:
            assert json.loads(resp.read())["ok"] is True   # alive
        got = r.result(timeout=60)
        assert victim._thread.is_alive()                   # still parked
    finally:
        gang.close()
    assert not victim._thread.is_alive()      # stop() ends the park
    assert got == ref
    assert r.state == serve.DONE and r.failovers == 1
    assert r.replicas_tried == [0, 1]


def test_fault23_a_request_queued_past_the_stall_bound_stays(models,
                                                             monkeypatch):
    """A request that waits in a busy replica's queue longer than the
    router's stall bound streams nothing until its first token; the
    replica's keep-alive lines, sent while its scheduler steps, keep the
    router from taking it for a wedge (which marked a healthy replica
    dead and replayed the request elsewhere). One slot, a scheduler
    slowed to 20 ms a step: the second request waits ~0.5 s behind the
    first, over a 0.25 s bound; both finish on their replica, equal to
    the JAX server's tokens, with no failover."""
    jm, ports = models
    specs = [(_prompt(6, seed=11), dict(max_new_tokens=24)),
             (_prompt(5, seed=12), dict(max_new_tokens=4))]
    ref = _jax_tokens(jm, specs)
    monkeypatch.setenv("MXNET_TPU_FLEET_STALL_TIMEOUT_MS", "250")
    gang = _Gang(ports[:1], start=(), server_kw={"slots": 1},
                 stall_timeout_s=0.25)
    srv = gang.servers[0]
    step = srv.step

    def slow_step():
        time.sleep(0.02)
        return step()
    srv.step = slow_step
    srv.start()
    first = []

    def watch(fr, t0):
        for _ in fr.stream():
            first.append(time.perf_counter() - t0)
            return
    try:
        t0 = time.perf_counter()
        reqs = [gang.router.submit(p, **kw) for p, kw in specs]
        th = threading.Thread(target=watch, args=(reqs[1], t0))
        th.start()
        got = [r.result(timeout=60) for r in reqs]
        th.join(10)
        healthy = gang.router._replicas[0].healthy
    finally:
        gang.close()
    assert got == ref
    assert [r.state for r in reqs] == [serve.DONE] * 2
    assert [r.failovers for r in reqs] == [0, 0]
    assert gang.router.counters["failovers"] == 0 and healthy
    assert first[0] > 0.25             # it did wait past the bound


def test_slow_replica_drill_delays_each_streamed_token(models):
    jm, ports = models
    p = _prompt(5, seed=4)
    ref = _jax_tokens(jm, [(p, dict(max_new_tokens=10))])[0]
    gang = _Gang(ports)
    try:
        config.set("fault_inject", "slow_replica:40")
        resilience.enable()
        gang.router.drain(1, remote=False)
        t0 = time.perf_counter()
        r = gang.router.submit(p, max_new_tokens=10)
        got = r.result(timeout=60)
        slow_s = time.perf_counter() - t0
        gang.router.undrain(1, remote=False)
        gang.router.drain(0, remote=False)
        r2 = gang.router.submit(p, max_new_tokens=10)
        got2 = r2.result(timeout=60)
    finally:
        gang.close()
    assert got == got2 == ref
    assert (gang.eps[0]._slow_ms, gang.eps[1]._slow_ms) == (40.0, None)
    assert slow_s >= 10 * 0.040
    assert (r.replicas_tried, r2.replicas_tried) == ([0], [1])


def test_kill_replica_drill_sigkills_the_replica_process():
    env = dict(os.environ, PYTHONPATH=ROOT,
               MXNET_TPU_FAULT_INJECT="kill_replica@step:40",
               MXNET_TPU_FLEET_REPLICA="0", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.fleet", "--device", "cpu",
         "--port", str(chip_smoke.free_base_port(0))], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL, out.stdout + out.stderr
    assert "fault injection: kill_replica at scheduler step 40" in out.stderr
    assert "serving gpt_tiny on cpu" in out.stdout


def test_fleet_off_is_one_module_bool(models, monkeypatch):
    _, ports = models
    assert fleet.enabled() is False
    calls = []
    monkeypatch.setattr(fleet, "snapshot",
                        lambda: calls.append(1) or {"endpoints": []})
    assert scope._fleet_section() is None
    srv = serve.Server(ports[0], slots=2)
    r = srv.submit(_prompt(4, seed=7), max_new_tokens=4)
    srv.drain()
    srv.stop()
    assert r.state == serve.DONE and calls == []
    fleet.enable()
    assert scope._fleet_section() == {"endpoints": []} and calls == [1]


# -- entry points --------------------------------------------------------------

def test_router_half_and_launcher_load_without_torch():
    code = (
        "import importlib.util, sys\n"
        "for name in ('fleet', 'launch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'mx_' + name, f'mxnet_tpu_torch/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "r = sys.modules.get('mx_fleet') or mod\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'mxnet_tpu', 'mxnet_tpu_torch',\n"
        "              'numpy')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    refused = subprocess.run(
        [sys.executable, "mxnet_tpu_torch/launch.py", "-n", "2", "true"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert refused.returncode == 2 and "Multi-device" in refused.stderr


def test_fleet_ledger_and_serve_knobs_as_jax():
    """The twelve knobs of this slice, declared as the JAX package does
    (name, default, type, environment variable, choices), the fleet's
    from the one table that the router half reads; `serve=on` and
    `fleet=on` in the environment arm each module at import."""
    names = ("serve", "fleet", "fleet_port", "fleet_retry_max",
             "fleet_health_interval_ms", "fleet_stall_timeout_ms",
             "fleet_drain_grace_s", "fleet_autoscale",
             "fleet_autoscale_p99_ms", "fleet_autoscale_window_s",
             "ledger_dir", "ledger_gate")
    for name in names:
        a, b = config.option(name), config_j.option(name)
        assert (a.name, a.default, a.typ, a.env, a.choices) == \
            (b.name, b.default, b.typ, b.env, b.choices), name
    assert len(config.describe()) == 81   # with the dataflow layer's two
    assert {n: config.option(n).default for n in fleet.DEFAULTS} \
        == fleet.DEFAULTS
    out = subprocess.run(
        [sys.executable, "-c", "from mxnet_tpu_torch import fleet, serve; "
         "print(serve.enabled(), fleet.enabled())"], cwd=ROOT,
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=ROOT, MXNET_TPU_SERVE="on",
                 MXNET_TPU_FLEET="on"))
    assert out.stdout.strip() == "True True", out.stderr


def test_replica_runs_on_the_card_unless_given_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.fleet",
         "--port", str(chip_smoke.free_base_port(0))], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=60)
    assert out.returncode != 0
    assert "device cuda requested but CUDA is unavailable" in out.stderr


def _get(port, path):
    return chip_smoke.http_json(port, path, timeout=5)


def _submit(port, prompt, n):
    """One request through the front door: (tokens, final line)."""
    out = []
    chip_smoke.front_stream(port, prompt, {"max_new_tokens": n}, out)
    return out[0]["tokens"], out[0]["final"]


def test_launcher_supervises_cpu_replicas(tmp_path):
    """`python mxnet_tpu_torch/launch.py --serve-replicas 2` with
    `--device cpu` replicas: the launcher maps no torch library, SIGKILL of the replica serving a request mid-stream
    loses nothing (the stream completes equal to its reference, through
    one failover), restarts.jsonl records the replica_exit /
    replica_relaunch pair, the relaunched replica comes back healthy, and
    SIGTERM drains both replicas through the preemption path (rc 143).
    Every token leaves a first-launch replica 50 ms late (`slow_replica`),
    so the kill lands mid-stream."""
    port = chip_smoke.free_base_port(2)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MXNET_TPU_FAULT_INJECT="slow_replica:50")
    proc = subprocess.Popen(
        [sys.executable, "mxnet_tpu_torch/launch.py", "--serve-replicas",
         "2", "--fleet-port", str(port), "--diagnostics-dir", str(tmp_path),
         "--max-restarts", "2", "--restart-backoff", "0.5", "--",
         sys.executable, "-m", "mxnet_tpu_torch.fleet", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    pump = threading.Thread(target=lambda: lines.extend(proc.stdout),
                            daemon=True)
    pump.start()
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    prompt = _prompt(7, seed=9)
    try:
        def healthy():
            try:
                h = _get(port, "/healthz")
            except OSError:
                return False
            return len(h["replicas"]) == 2 and all(
                v["ok"] for v in h["replicas"].values())

        _wait(healthy, timeout=deadline - time.monotonic(),
              what="two healthy replicas")
        # this process maps torch, the launcher nothing of it
        assert chip_smoke.maps_torch(os.getpid())
        assert not chip_smoke.maps_torch(proc.pid)
        ref, fin = _submit(port, prompt, 16)
        assert fin["state"] == "done" and len(ref) == 16
        pids = {rid: _get(port + 1 + rid, "/statusz")["pid"]
                for rid in (0, 1)}
        results = []
        th = threading.Thread(
            target=lambda: results.append(_submit(port, prompt, 16)))
        th.start()

        def running():
            for rid in (0, 1):
                if _get(port + 1 + rid, "/statusz")["stats"]["running"]:
                    return rid
            return None

        _wait(lambda: running() is not None, what="the request to run")
        victim = running()
        time.sleep(0.2)                       # a few tokens out
        os.kill(pids[victim], signal.SIGKILL)
        os.kill(pids[1 - victim], 0)          # the survivor lives
        th.join(timeout=deadline - time.monotonic())
        assert results, "the request under the kill never completed"
        toks, final = results[0]
        assert final["state"] == "done" and toks == ref
        assert final["failovers"] == 1
        assert final["replicas_tried"] == [victim, 1 - victim]

        def relaunched():
            try:
                return _get(port + 1 + victim, "/statusz")["pid"] \
                    != pids[victim]
            except OSError:
                return False

        _wait(relaunched, timeout=deadline - time.monotonic(),
              what="the relaunched replica")
        kinds = [json.loads(ln)["kind"] for ln in
                 (tmp_path / "restarts.jsonl").read_text().splitlines()]
        assert kinds == ["replica_exit", "replica_relaunch"]
        _wait(healthy, timeout=deadline - time.monotonic(),
              what="the fleet healthy again")
        assert _submit(port, prompt, 16)[0] == ref
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=max(10.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        pump.join(timeout=10)
    out = "".join(lines)
    assert proc.returncode == 128 + signal.SIGTERM, out[-3000:]
    for rid in (0, 1):
        assert f"[rank {rid}] mx.fleet: replica {rid} drained" in out
    assert out.count("exiting via preemption path") == 2
    exits = [json.loads(ln) for ln in
             (tmp_path / "restarts.jsonl").read_text().splitlines()]
    assert exits[0]["exit_code"] == -signal.SIGKILL
    assert (tmp_path / "0" / "worker.log").exists()
