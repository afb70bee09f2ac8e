"""PyTorch port, the operations layer (goodput, guard, slo, check,
scope) against the JAX package on the CPU, on the same weights and
numpy inputs through both packages:

  * the same request sequence through `serve.Server` with slo on (dense
    and paged) journals the same event kinds in the same order, with the
    same outcomes, verdicts and SLO classifications;
  * the same `lint_paging` inputs give the same findings;
  * the same fault plan (an injected out-of-memory at a step's dispatch,
    periodic checkpoints, a rollback) gives the same goodput categories
    and step-id high-water mark;
  * guard's digests of the same parameters are equal, and a three-rank
    file exchange in which this rank's parameters carry a flipped bit
    convicts this rank and rolls it back to the last verified checkpoint;
  * with every knob off, no hook site of the trainer, the hybridized
    block or the server (dense, paged, streamed) calls into the five
    modules, and none of them holds state;
  * the port's check rules over recorded calls: a captured constant,
    an upcast in a bf16 block, state replaced instead of updated in
    place, a kernel launch's operand (never a constant), check=error
    forgetting the key; and scope's /statusz listing a live server.
"""
import gc
import json
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import check as check_j
from mxnet_tpu import config as config_j
from mxnet_tpu import goodput as goodput_j
from mxnet_tpu import guard as guard_j
from mxnet_tpu import memsafe as memsafe_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import pages as pages_j
from mxnet_tpu import parallel as parallel_j
from mxnet_tpu import resilience as res_j
from mxnet_tpu import serve as serve_j
from mxnet_tpu import slo as slo_j
from mxnet_tpu.gluon import loss as gloss_j
from mxnet_tpu.gluon import nn as nn_j
from mxnet_tpu.models import gpt as gpt_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import check as check_t
from mxnet_tpu_torch import config as config_t
from mxnet_tpu_torch import goodput as goodput_t
from mxnet_tpu_torch import guard as guard_t
from mxnet_tpu_torch import memsafe as memsafe_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import pages as pages_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import resilience as res_t
from mxnet_tpu_torch import scope as scope_t
from mxnet_tpu_torch import serve as serve_t
from mxnet_tpu_torch import slo as slo_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.gluon import loss as gloss_t
from mxnet_tpu_torch.gluon import nn as nn_t
from mxnet_tpu_torch.models import gpt as gpt_t

_VOCAB = 128
CPU = mxt.cpu()


@pytest.fixture(autouse=True)
def _clean():
    yield
    gc.collect()
    for slo in (slo_j, slo_t):
        slo.disable()
        slo.reset()
    for gp in (goodput_j, goodput_t):
        gp.disable()
        gp.reset()
    for g in (guard_j, guard_t):
        g.disable()
        g.reset()
    for c in (check_j, check_t):
        c.disable()
        c.reset()
    for res in (res_j, res_t):
        res.uninstall()
        res.clear_preempted()
    for ms in (memsafe_j, memsafe_t):
        ms.disable()
        ms.reset()
    scope_t.disable()
    serve_j.disable()
    pages_j.disable()
    pages_t.disable()
    config_j.reset()
    config_t.reset()
    parallel_j.set_mesh(None)


@pytest.fixture(scope="module")
def models():
    """The same 2-layer gpt_tiny weights in both packages (float32)."""
    parallel_j.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config(num_layers=2))
    mx.random.seed(0)
    jm.initialize()
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(num_layers=2),
                              device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    parallel_j.set_mesh(None)
    return jm, tm


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


def _journal(serve, slo, model, path, pages):
    """Serve one request sequence with slo on (every journal written);
    returns [(req, outcome, verdict, good, violations, [events])]."""
    slo.enable(slo_dir=str(path), rank=0, sample_every=1)
    kw = dict(pages="on", page_size=4, prefill_chunk=4) \
        if pages == "on" else {}
    srv = serve.Server(model, slots=2, **kw)
    reqs = [srv.submit(_prompt(5, 1), max_new_tokens=6),
            srv.submit(_prompt(9, 2), max_new_tokens=4),
            srv.submit(_prompt(3, 3), max_new_tokens=5)]
    srv.step()
    srv.cancel(reqs[1])
    too_long = srv.submit(_prompt(8, 4), max_new_tokens=10 ** 6)
    srv.drain()
    for r in reqs[:1]:
        assert list(r.stream())     # a delivered, finished stream
    srv.stop()
    slo.disable()
    assert too_long.state == serve.REJECTED
    out = []
    for line in open(path / "0" / "access.jsonl"):
        rec = json.loads(line)
        if rec["kind"] != "access":
            continue
        out.append((rec["req"], rec["outcome"], rec["verdict"], rec["good"],
                    rec["violations"],
                    [e["event"] for e in rec["timeline"]]))
    return sorted(out)


@pytest.mark.parametrize("pages", ["off", "on"])
def test_slo_journals_the_same_events_and_verdicts(models, tmp_path, pages):
    jm, tm = models
    parallel_j.make_mesh(dp=-1)
    ref = _journal(serve_j, slo_j, jm, tmp_path / "jax", pages)
    with CPU:
        got = _journal(serve_t, slo_t, tm, tmp_path / "port", pages)
    assert [r[1] for r in ref] == ["completed", "cancelled", "completed",
                                   "rejected"]
    assert got == ref


def test_lint_paging_gives_the_same_findings():
    cases = [(64, 32, 128, None), (4, 32, 128, 96), (8, 8, 128, 128),
             (16, 8, 50257, 50000)]
    out = []
    for check in (check_j, check_t):
        check.enable("warn")
        for i, (ps, mb, tv, dv) in enumerate(cases):
            check.lint_paging(f"serve.Server(case={i})", ps, mb, tv, dv)
        out.append([(f["rule"], f["location"], f["message"],
                     f["remediation"], f["details"])
                    for f in check.findings()])
    assert out[0] == out[1]
    assert len(out[0]) == 4


def _goodput_run(pkg, cfg, gp, res, ms, mesh, nd, nn, gloss, ckpt):
    """The same fault plan on `pkg`: goodput on, a checkpoint every 2
    steps, `oom@step:3` walked by the ladder, then a rollback to step 2
    and two steps trained again. Returns the goodput snapshot."""
    cfg.set("oom_recover", "auto")
    cfg.set("fault_inject", "oom@step:3")
    cfg.set("checkpoint_dir", str(ckpt))
    cfg.set("checkpoint_every_n_steps", 2)
    res.enable()
    ms.reset()
    gp.enable()
    if mesh is not None:
        mesh.make_mesh(dp=-1)
    pkg.random.seed(0)
    net = nn.Dense(4, in_units=8)
    net.initialize()
    lfn = gloss.L2Loss()
    tr = pkg.parallel.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                     {"learning_rate": 0.1})
    x = nd.array(np.random.RandomState(0).randn(8, 8).astype(np.float32))
    y = nd.array(np.zeros((8, 4), np.float32))
    for _ in range(4):
        tr.step(x, y)
    assert res.manager_for(tr).restore_latest(max_step=2) == 2
    for _ in range(2):
        tr.step(x, y)
    return gp.snapshot()


def test_goodput_same_categories_under_one_fault_plan(tmp_path):
    ref = _goodput_run(mx, config_j, goodput_j, res_j, memsafe_j, parallel_j,
                       nd_j, nn_j, gloss_j, tmp_path / "j")
    with CPU:
        got = _goodput_run(mxt, config_t, goodput_t, res_t, memsafe_t, None,
                           nd_t, nn_t, gloss_t, tmp_path / "t")
    assert set(got["categories"]) == set(ref["categories"]) == {
        "compile", "step", "checkpoint_save", "checkpoint_restore",
        "oom_recovery", "replay"}
    assert got["hw_step"] == ref["hw_step"] == 4
    assert got["intervals"]["replay"] == ref["intervals"]["replay"] == 2


def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=6), nn.Dense(3, in_units=16))
    return net


def _digest_trainers():
    parallel_j.make_mesh(dp=-1)
    mx.random.seed(3)
    jn = _mlp(nn_j)
    jn.initialize()
    lj = gloss_j.L2Loss()
    tr_j = parallel_j.ShardedTrainer(jn, lambda o, l: lj(o, l), "sgd",
                                     {"learning_rate": 0.1})
    with CPU:
        tn = _mlp(nn_t)
        tn.initialize()
        weights.load_named_arrays(
            tn, {k: p.data().asnumpy()
                 for k, p in jn.collect_params().items()})
        lt = gloss_t.L2Loss()
        tr_t = parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l), "sgd",
                                         {"learning_rate": 0.1})
    return tr_j, tr_t


def test_guard_digests_of_the_same_parameters_are_equal():
    tr_j, tr_t = _digest_trainers()
    ref = guard_j.param_digests(tr_j)
    got = guard_t.param_digests(tr_t)
    assert len(set(ref)) == 1           # every JAX replica agrees
    assert got == ref[:1]


def test_guard_file_vote_convicts_and_rolls_back(tmp_path, monkeypatch):
    """Three launcher ranks, no process group: ranks 1 and 2 publish the
    clean digest, this rank's parameters carry a flipped bit; the vote
    names rank 0 and restores the last verified checkpoint."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    config_t.set("checkpoint_dir", str(tmp_path / "ck"))
    config_t.set("checkpoint_every_n_steps", 1)
    res_t.enable()
    _, tr = _digest_trainers()
    guard_t.enable(guard_dir=str(tmp_path / "g"), rank=0)
    x = nd_t.array(np.ones((8, 6), np.float32), ctx=CPU)
    y = nd_t.array(np.zeros((8, 3), np.float32), ctx=CPU)
    tr.step(x, y)
    clean = guard_t.param_digests(tr)

    def publish(rnd):
        for rank in (1, 2):
            guard_t._write_sdc({"rank": rank, "step": 1, "gen": 0,
                                "round": rnd, "digests": clean})

    publish(1)
    assert guard_t.sdc_check(tr, 1)["ok"]
    res_t.FaultInjector.corrupt_gradient(tr, 1)
    assert guard_t.param_digests(tr) != clean
    publish(2)
    verdict = guard_t.sdc_check(tr, 1)
    assert not verdict["ok"] and verdict["conclusive"]
    assert verdict["corrupt_ranks"] == [0] and verdict["replicas"] == 3
    assert guard_t.param_digests(tr) == clean      # rolled back
    assert guard_t.snapshot()["sdc_restores"] == 1


def _counting(monkeypatch):
    """Patch every hook entry of the five modules to count its calls."""
    calls = []
    names = {
        goodput_t: ("note", "note_step", "note_oom_begin", "note_resume",
                    "note_rollback"),
        guard_t: ("heartbeat", "step_begin", "on_step", "sdc_check"),
        slo_t: ("note_submit", "note_admit", "note_first_dispatch",
                "note_token", "note_event", "note_stream_start",
                "note_delivered", "note_stream_end", "note_finish"),
        check_t: ("check_jit", "check_step", "lint_jaxpr", "lint_paging",
                  "note_signature"),
        scope_t: ("on_step",),
    }
    for mod, fns in names.items():
        for fn in fns:
            real = getattr(mod, fn)
            monkeypatch.setattr(
                mod, fn, (lambda real_, name_: lambda *a, **k: (
                    calls.append(name_), real_(*a, **k))[1])(real, fn))
    return calls


def test_every_hook_site_makes_zero_calls_with_the_knobs_off(models,
                                                            monkeypatch):
    _, tm = models
    calls = _counting(monkeypatch)
    with CPU:
        for opt in ("sgd", "lamb"):
            mxt.random.seed(0)
            net = _mlp(nn_t)
            net.initialize()
            lfn = gloss_t.L2Loss()
            tr = parallel_t.ShardedTrainer(net, lambda o, l: lfn(o, l), opt,
                                           {"learning_rate": 0.1})
            for _ in range(3):
                tr.step(nd_t.array(np.ones((8, 6), np.float32)),
                        nd_t.array(np.zeros((8, 3), np.float32)))
        net.hybridize()
        net(nd_t.array(np.ones((4, 6), np.float32)))
        for pages in ("off", "on"):
            kw = dict(pages="on", page_size=4) if pages == "on" else {}
            srv = serve_t.Server(tm, slots=2, **kw)
            reqs = [srv.submit(_prompt(6, i), max_new_tokens=4)
                    for i in range(3)]
            srv.drain()
            assert list(reqs[0].stream())
            assert all(r._slo_j is None for r in reqs)
            srv.stop()
    assert calls == []
    assert goodput_t._totals is None and guard_t._beat is None
    assert guard_t._deadline is None and scope_t._server is None
    assert check_t.findings() == []


# -- the port's check rules over recorded calls ------------------------------

class _Captured(nn_t.HybridBlock):
    """A user block reading a tensor held as a plain attribute."""

    def __init__(self, big):
        super().__init__()
        self._big = big

    def forward(self, x):
        return nd_t.NDArray(x._t @ self._big)


def test_check_large_constant_names_the_block():
    check_t.enable("warn")
    config_t.set("check_large_const_bytes", 1024)
    big = torch.ones(64, 64)
    net = _Captured(big)
    net.hybridize()
    with CPU:
        net(nd_t.array(np.ones((8, 64), np.float32)))
    found = check_t.findings("large-constant")
    assert len(found) == 1
    assert found[0]["location"] == "_Captured"
    assert "(64, 64)" in found[0]["message"]
    assert found[0]["details"]["nbytes"] == 64 * 64 * 4
    assert "Parameter" in found[0]["remediation"]
    # a clean block and a small capture stay quiet
    check_t.reset()
    net2 = _Captured(torch.ones(4, 4))
    net2.hybridize()
    with CPU:
        net2(nd_t.array(np.ones((8, 4), np.float32)))
        d = nn_t.Dense(4, in_units=64)
        d.initialize()
        d.hybridize()
        d(nd_t.array(np.ones((8, 64), np.float32)))
    assert check_t.findings() == []


def test_check_error_forgets_the_key_and_raises_again():
    check_t.enable("error")
    config_t.set("check_large_const_bytes", 1024)
    net = _Captured(torch.ones(64, 64))
    net.hybridize()
    x = nd_t.array(np.ones((8, 64), np.float32), ctx=CPU)
    for _ in range(2):
        with pytest.raises(check_t.CheckError, match="large-constant"):
            net(x)
    assert len(check_t.findings()) == 1
    with check_t.suppress("large-constant"):
        assert net(x).shape == (8, 64)


def test_check_kernel_operands_are_arguments_not_constants():
    from mxnet_tpu_torch.cuda_ops import _build
    config_t.set("check_large_const_bytes", 1024)
    big = torch.ones(64, 64)
    x = torch.ones(8, 64)

    def call(launch):
        if launch:
            _build.tally(0, big)        # what a kernel wrapper reports
        return x @ big

    rec = check_t.StepRecord(known=[x])
    rec.run(lambda: call(True))
    assert rec.consts == {}
    rec = check_t.StepRecord(known=[x])
    rec.run(lambda: call(False))
    assert [v[0] for v in rec.consts.values()] == [64 * 64 * 4]


def test_check_promotion_only_in_a_lower_precision_block():
    check_t.enable("warn")
    config_t.set("check_promotion_min_bytes", 1024)
    for dtype, expect in (("bfloat16", 1), ("float32", 0)):
        check_t.reset()
        with CPU:
            d = nn_t.Dense(64, in_units=64, dtype=dtype)
            d.initialize()

        class _Up(nn_t.HybridBlock):
            def __init__(self):
                super().__init__()
                self.d = d

            def forward(self, x):
                h = self.d(x.astype("bfloat16"))
                return h.astype("float32") * 2.0

        net = _Up()
        net.hybridize()
        with CPU:
            net(nd_t.array(np.ones((32, 64), np.float32)))
        found = check_t.findings("dtype-promotion")
        assert len(found) == expect, found
        if expect:
            assert found[0]["details"]["src"] == "bfloat16"
            assert found[0]["details"]["dst"] == "float32"


def test_check_donation_miss_on_replaced_state():
    check_t.enable("warn")
    config_t.set("check_donation_min_bytes", 1024)
    state = torch.zeros(64, 64)
    rec = check_t.StepRecord(known=[state], state=[state])
    rec.run(lambda: state.add_(1.0))                # in place: quiet
    check_t.lint_jaxpr("step", rec.finish(), can_donate=True)
    assert check_t.findings("donation-miss") == []
    rec = check_t.StepRecord(known=[state], state=[state])
    rec.run(lambda: state.set_(state + 1.0))        # a new allocation
    check_t.lint_jaxpr("step", rec.finish(), can_donate=True)
    found = check_t.findings("donation-miss")
    assert len(found) == 1 and found[0]["details"]["n_buffers"] == 1


def test_check_trainer_and_server_first_calls_lint_clean(models):
    """The port's own step and decode update in place and capture no
    constant: recorded first calls give no finding."""
    _, tm = models
    check_t.enable("warn")
    config_t.set("check_large_const_bytes", 1024)
    config_t.set("check_donation_min_bytes", 1024)
    with CPU:
        for opt in ("sgd", "adam", "lamb"):
            mxt.random.seed(0)
            net = _mlp(nn_t)
            net.initialize()
            lfn = gloss_t.L2Loss()
            tr = parallel_t.ShardedTrainer(net, lambda o, l: lfn(o, l), opt,
                                           {"learning_rate": 0.1})
            for _ in range(2):
                tr.step(nd_t.array(np.ones((8, 6), np.float32)),
                        nd_t.array(np.zeros((8, 3), np.float32)))
        for pages in ("off", "on"):
            kw = dict(pages="on", page_size=4, prefill_chunk=4) \
                if pages == "on" else {}
            srv = serve_t.Server(tm, slots=2, **kw)
            srv.submit(_prompt(6, 1), max_new_tokens=4)
            srv.drain()
            srv.stop()
            assert srv._checked
    assert check_t.findings() == []


def test_scope_statusz_lists_the_live_server(models):
    _, tm = models
    port = scope_t.enable(port=0)
    with CPU:
        srv = serve_t.Server(tm, slots=2)
        srv.submit(_prompt(5, 0), max_new_tokens=3)
        srv.drain()
    base = f"http://127.0.0.1:{port}"
    st = json.load(urllib.request.urlopen(base + "/statusz", timeout=10))
    assert any(s == srv.stats() for s in st["serve"]["servers"])
    text = urllib.request.urlopen(base + "/metrics",
                                  timeout=10).read().decode()
    assert isinstance(text, str)
    assert json.load(urllib.request.urlopen(base + "/healthz",
                                            timeout=10))["ok"]
    srv.stop()


def test_a_forked_child_inherits_no_deadline_thread_or_scope_server(
        tmp_path):
    import os
    guard_t.enable(guard_dir=str(tmp_path), rank=0,
                   collective_timeout_s=30.0)
    scope_t.enable(port=0)
    assert guard_t._deadline is not None and scope_t._server is not None
    pid = os.fork()
    if pid == 0:        # the child: slots cleared, nothing to stop
        ok = guard_t._deadline is None and scope_t._server is None \
            and not scope_t.enabled()
        os._exit(0 if ok else 1)
    _, status = os.waitpid(pid, 0)
    assert os.WEXITSTATUS(status) == 0
    assert guard_t._deadline is not None and scope_t.enabled()
