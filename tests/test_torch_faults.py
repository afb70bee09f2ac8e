"""PyTorch port, ROADMAP.md queue 3 faults 10-12 and 14-16, each call
made the same way on both packages (JAX keywords and positions) on the
CPU.

Fault 10: `ShardedTrainer(net, loss)` trains with SGD, the JAX default,
and takes the JAX package's keywords at their defaults (`donate=True`,
`data_specs` / `label_specs` None or all None); two default steps from
the same weights give weights within 1e-6 (absolute, float32) of the
JAX package's. Fault 11: `hasattr` / `getattr(..., None)` of an unknown
name on an NDArray and on `nd` are False / None, as in the JAX package,
and the not-ported error is still a NotImplementedError naming its
queue item. Fault 12: `Block.initialize(init, ctx, verbose,
force_reinit)` and `GPTForCausalLM.generate(..., seed, on_device,
num_beams)` in the JAX order: the same parameters, the same greedy
tokens.

Fault 14: `NDArray.context` (and `ctx`) is the port's `Context`, as the
JAX package's is, and `as_in_ctx` exists. Fault 15: `collect_params()`
lists a block added twice under both paths and `Monitor` reports both,
as the JAX package does; the port's `gluon.Trainer` updates the shared
parameter once a step, the JAX package's twice (the test writes both
down; ROADMAP.md "The oracle is red"). Fault 16: the optimizers'
`create_state` returns NDArrays and `update` takes NDArrays, updating
the weight and the state in place: three steps equal the JAX package's
within 1e-6; `Module._opt_states` holds NDArrays.

Fault 17: ops by name take numpy arrays as array arguments, as the JAX
package's do (`jnp.asarray`): eight ops on a (4, 3, 2) float32 array
with numpy indices, lengths, operands and conditions, and `nd.RNN` with
numpy `sequence_length`, equal the JAX package's within 1e-6 and in
its dtypes (int32 stays int32, float64 becomes float32). Fault 18:
`config.describe()` and `config.option(name)` exist with the JAX
package's shapes; for every knob the port declares, the JAX package
declares it with the same default and environment variable, and
`source` reads "default", "env" and "set" alike in both; the operations
layer's knobs (goodput, guard, slo, check, scope) are among them.

Fault 19: a user's `HybridBlock` whose `forward` is written for NDArrays
(`.astype`, `.reshape`, `nd.arange`, `h.sum(axis=1)`; the masked
sequence net of `tests/unittest/test_dataflow.py`) gets NDArrays in an
eager call and inside `ShardedTrainer`'s step: on the same weights its
forward sums to the JAX package's 0.12768534 and its first SGD loss is
the JAX package's 0.44101596, each within 1e-6, and the gradient
reaches its Dense layer. `io.LibSVMIter`'s refusal names what is
missing and the ROADMAP.md list that carries it.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import parallel as parallel_j
from mxnet_tpu.models import gpt as gpt_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import gpt as gpt_t

CPU = mxt.cpu()


def _mlp(gluon, **kw):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=6),
            gluon.nn.Dense(3, in_units=16))
    return net


def _batch():
    x = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, 8).astype(np.float32)
    return x, y


@pytest.fixture
def mesh():
    parallel_j.make_mesh(dp=-1)
    yield
    parallel_j.set_mesh(None)


def _start():
    with mxt.cpu():
        tn = _mlp(gluon_t)
        tn.initialize()
    return tn, {k: p.detach().numpy().copy()
                for k, p in tn.collect_params().items()}


def _jax_from(arrays):
    jn = _mlp(gluon_j)
    for k, p in jn.collect_params().items():
        p.initialize()
        p.set_data(nd_j.array(arrays[k]))
    return jn


def test_fault10_default_optimizer_is_sgd_like_jax(mesh):
    tn, arrays = _start()
    jn = _jax_from(arrays)
    lj = gluon_j.loss.SoftmaxCrossEntropyLoss()
    lt = gluon_t.loss.SoftmaxCrossEntropyLoss()
    jt = parallel_j.ShardedTrainer(jn, lambda o, l: lj(o, l))
    tt = parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l), device="cpu")
    assert type(tt._opt).__name__ == type(jt._opt).__name__ == "SGD"
    x, y = _batch()
    for _ in range(2):
        lj_ = float(jt.step([nd_j.array(x)], [nd_j.array(y)]).asscalar())
        lt_ = float(tt.step([x], [y]).asscalar())
        assert abs(lj_ - lt_) <= 1e-6
    assert tt._names == jt._names
    for name, w_j, w_t in zip(jt._names, jt.params, tt.params):
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-6, err_msg=name)
        assert not np.array_equal(w_t.numpy(), arrays[name])


@pytest.mark.parametrize("kw", [
    {"donate": True}, {"donate": False},
    {"data_specs": None, "label_specs": None},
    {"data_specs": [None, None], "label_specs": [None]},
    {"param_mode": "replicate", "mesh": None}])
def test_fault10_jax_keywords_at_their_defaults(mesh, kw):
    for pkg, gluon, extra in ((parallel_j, gluon_j, {}),
                              (parallel_t, gluon_t, {"device": "cpu"})):
        with mxt.cpu():
            net = _mlp(gluon)
            net.initialize()
        lfn = gluon.loss.SoftmaxCrossEntropyLoss()
        pkg.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd", None,
                           **kw, **extra)


def test_fault10_positional_order_and_multi_device_specs():
    tn, _ = _start()
    lt = gluon_t.loss.SoftmaxCrossEntropyLoss()
    tr = parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l), "sgd", None,
                                   None, "replicate", True, None, None,
                                   "cpu")
    assert tr.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l),
                                  data_specs=[("dp", "fsdp"), None],
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l),
                                  label_specs=[("dp",)], device="cpu")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fault11_hasattr_of_unknown_names(pkg):
    nd = nd_j if pkg == "jax" else nd_t
    x = nd.array([1.0, 2.0]) if pkg == "jax" else nd.array([1.0, 2.0],
                                                           ctx=CPU)
    assert hasattr(x, "no_such_name") is False
    assert hasattr(nd, "no_such_name") is False
    assert getattr(nd, "no_such_name", None) is None
    assert getattr(x, "no_such_name", None) is None
    assert hasattr(x, "transpose") and hasattr(nd, "transpose")


def test_fault11_not_ported_still_names_the_item():
    x = nd_t.array([1.0, 2.0], ctx=CPU)
    for obj, name in ((x, "Custom"), (nd_t, "Custom")):
        with pytest.raises(NotImplementedError,
                           match="The eager MXNet surface"):
            getattr(obj, name)
        with pytest.raises(AttributeError):
            getattr(obj, name)


def _bn_net(gluon):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=3), gluon.nn.BatchNorm(in_channels=4))
    return net


def test_fault12_initialize_in_the_jax_order():
    """init, ctx, verbose, force_reinit by position on both packages:
    the same parameters (the name rule of "zeros": gammas and running
    variances 1, the rest 0), a second call without force_reinit leaves
    them, and force_reinit (4th) redraws."""
    jn, tn = _bn_net(gluon_j), _bn_net(gluon_t)
    jn.initialize("zeros", mx.cpu(), False, False)
    tn.initialize("zeros", mxt.cpu(), False, False)
    jp, tp = jn.collect_params(), tn.collect_params()
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k].data()._data))
    for net in (jn, tn):
        net.initialize("ones", ctx=None, verbose=True)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k].data()._data))
    jn.initialize("ones", None, False, True)
    tn.initialize("ones", None, False, True)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k].data()._data))
    assert float(tp["0.weight"].sum()) == 12.0
    assert all(p.device.type == "cpu" for p in tn.parameters())
    with pytest.raises(TypeError, match="ctx or device"):
        tn.initialize(ctx=mxt.cpu(), device="cpu")


def test_fault12_generate_on_device_in_the_jax_position():
    parallel_j.make_mesh(dp=-1)
    try:
        jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
        mx.random.seed(0)
        jm.initialize()
        arrays = {k: np.asarray(p.data()._data)
                  for k, p in jm.collect_params().items()}
        tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
        weights.load_named_arrays(tm, arrays)
        prompt = np.random.RandomState(3).randint(0, 128, (2, 7)) \
            .astype(np.int32)
        # prompt, max_new_tokens, eos, temperature, top_k, seed, on_device
        ref = np.asarray(jm.generate(prompt, 6, None, 0.0, 0, 0, True))
        for on_device in (True, False):
            got = tm.generate(prompt, 6, None, 0.0, 0, 0, on_device)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                tm.generate(prompt, max_new_tokens=6, on_device=on_device,
                            num_beams=1), ref)
        np.testing.assert_array_equal(
            np.asarray(jm.generate(prompt, 6, None, 0.0, 0, 0, False)), ref)
    finally:
        parallel_j.set_mesh(None)


# -- fault 14: NDArray.context is a Context ----------------------------------

def test_fault14_context_is_a_context_like_jax():
    j = nd_j.ones((2, 2)).as_in_context(mx.cpu(0))
    t = nd_t.ones((2, 2), ctx=CPU).as_in_context(mxt.cpu(0))
    for x, pkg in ((j, mx), (t, mxt)):
        assert x.context.device_type == "cpu"
        assert x.ctx == x.context == pkg.cpu(0)
        assert isinstance(x.context, pkg.Context)
        y = x.as_in_ctx(pkg.cpu(0))
        assert y.context == pkg.cpu(0)
        np.testing.assert_array_equal(y.asnumpy(), np.ones((2, 2)))
    assert repr(t.context) == repr(j.context) == "cpu(0)"


def test_fault14_contexts_compare_as_in_jax():
    for pkg in (mx, mxt):
        assert pkg.Context("cpu", 0) == pkg.cpu(0)
        assert pkg.Context("gpu", 0) == pkg.gpu(0)
        assert pkg.Context("cpu", 0) != pkg.gpu(0)
        assert hash(pkg.Context("cpu", 0)) == hash(pkg.cpu(0))
    assert mxt.Context.of(torch.device("cpu")) == mxt.cpu(0)
    assert mxt.Context.of(torch.device("cuda", 1)) == mxt.gpu(1)


# -- fault 15: a block added twice ---------------------------------------------

def _shared_net(gluon):
    shared = gluon.nn.Dense(3, in_units=3)
    net = gluon.nn.HybridSequential()
    net.add(shared, shared)
    return net


def _shared_pair():
    w = np.random.RandomState(5).randn(3, 3).astype(np.float32) * 0.3
    b = np.random.RandomState(6).randn(3).astype(np.float32) * 0.1
    jn = _shared_net(gluon_j)
    jn.initialize()
    with mxt.cpu():
        tn = _shared_net(gluon_t)
        tn.initialize()
    for net, setter in ((jn, lambda p, v: p.set_data(nd_j.array(v))),
                        (tn, lambda p, v: gluon_t.parameter.set_data(
                            p, torch.from_numpy(v)))):
        params = net.collect_params()
        setter(params["0.weight"], w)
        setter(params["0.bias"], b)
    return jn, tn, w, b


def test_fault15_collect_params_lists_every_path():
    jn, tn, _, _ = _shared_pair()
    keys = ["0.weight", "0.bias", "1.weight", "1.bias"]
    assert list(jn.collect_params()) == list(tn.collect_params()) == keys
    tp = tn.collect_params()
    assert tp["0.weight"] is tp["1.weight"]
    assert list(tn.collect_params(".*bias")) == ["0.bias", "1.bias"]


def test_fault15_monitor_reports_both_names_as_jax():
    jn, tn, _, _ = _shared_pair()
    x = np.random.RandomState(7).rand(2, 3).astype(np.float32)
    rows = {}
    for pkg, net, nd, ctx in (("jax", jn, nd_j, None),
                              ("port", tn, nd_t, CPU)):
        mod = mx if pkg == "jax" else mxt
        mon = mod.monitor.Monitor(interval=1, monitor_gradient=False)
        mon.install(net)
        mon.tic()
        net(nd.array(x) if ctx is None else nd.array(x, ctx=ctx))
        rows[pkg] = [(name, float(stat)) for _, name, stat in mon.toc()]
    assert [n for n, _ in rows["port"]] == [n for n, _ in rows["jax"]]
    assert len(rows["port"]) == 9
    np.testing.assert_allclose([v for _, v in rows["port"]],
                               [v for _, v in rows["jax"]], rtol=1e-5)


def test_fault15_trainer_updates_a_shared_parameter_once():
    """The port's Trainer: one SGD update of the shared weight a step
    (upstream MXNet keys parameters by name). The JAX package's Trainer
    takes `list(params.values())` as is and applies two: this test
    writes both down (ROADMAP.md, "The oracle is red")."""
    jn, tn, w, b = _shared_pair()
    x = np.random.RandomState(8).rand(2, 3).astype(np.float32)
    grads, after = {}, {}
    for pkg, net, nd, ctx in (("jax", jn, nd_j, None),
                              ("port", tn, nd_t, CPU)):
        gl = gluon_j if pkg == "jax" else gluon_t
        ag = mx.autograd if pkg == "jax" else mxt.autograd
        tr = gl.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        xa = nd.array(x) if ctx is None else nd.array(x, ctx=ctx)
        with ag.record():
            loss = net(xa).sum()
        loss.backward()
        p = net.collect_params()["0.bias"]
        grads[pkg] = (p.grad().asnumpy() if pkg == "jax"
                      else p.grad.numpy().copy())
        tr.step(1)
        after[pkg] = (p.data().asnumpy() if pkg == "jax"
                      else p.detach().numpy().copy())
        n_params = len(tr._params)
        assert n_params == (4 if pkg == "jax" else 2)
    np.testing.assert_allclose(grads["port"], grads["jax"], rtol=1e-5,
                               atol=1e-6)
    g = grads["port"]
    np.testing.assert_allclose(after["port"], b - 0.1 * g, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(after["jax"], b - 2 * 0.1 * g, rtol=1e-6,
                               atol=1e-7)


# -- fault 16: the optimizer's NDArray boundary ---------------------------------

@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "wd": 0.01})])
def test_fault16_update_takes_ndarrays_like_jax(name, kw):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    gs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    out = {}
    for pkg, optm, nd, ctx in (("jax", mx.optimizer, nd_j, None),
                               ("port", mxt.optimizer, nd_t, CPU)):
        arr = (lambda v: nd.array(v)) if ctx is None else \
            (lambda v: nd.array(v, ctx=ctx))
        o = optm.create(name, **kw)
        weight = arr(w)
        state = o.create_state(0, weight)
        parts = state if isinstance(state, tuple) else (state,)
        for s in parts:
            assert s is None or isinstance(s, nd.NDArray)
        for g in gs:
            o.update(0, weight, arr(g), state)
        out[pkg] = (weight.asnumpy(), [s.asnumpy() for s in parts
                                       if s is not None])
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(out["port"][1], out["jax"][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_fault16_module_holds_ndarray_states():
    from mxnet_tpu_torch import io as io_t
    from mxnet_tpu_torch import module as mod_t
    from mxnet_tpu_torch import symbol as sym_t
    data = sym_t.var("data")
    out = sym_t.SoftmaxOutput(sym_t.FullyConnected(data, num_hidden=3,
                                                   name="fc"), name="softmax")
    x = np.random.RandomState(1).rand(8, 4).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 3, 8).astype(np.float32)
    it = io_t.NDArrayIter(x, y, batch_size=4)
    m = mod_t.Module(out, context=CPU)
    m.fit(it, num_epoch=1, optimizer="adam",
          optimizer_params={"learning_rate": 0.01})
    assert m._opt_states
    for st in m._opt_states.values():
        assert isinstance(st, tuple) and all(
            isinstance(s, nd_t.NDArray) for s in st)


# -- fault 17: numpy arrays as array arguments of ops by name ----------------

_X17 = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
_LENS17 = np.array([1, 2, 3], np.int32)


def _fault17_calls(nd):
    x = nd.array(_X17)
    return {
        "take": nd.take(x, np.array([0, 2], np.int32)),
        "SequenceMask": nd.SequenceMask(x, sequence_length=_LENS17,
                                        use_sequence_length=True),
        "SequenceLast": nd.SequenceLast(x, sequence_length=_LENS17,
                                        use_sequence_length=True),
        "SequenceReverse": nd.SequenceReverse(x, sequence_length=_LENS17,
                                              use_sequence_length=True),
        "broadcast_add": nd.broadcast_add(x, np.ones((1, 3, 2))),
        "where": nd.where((_X17 > 10).astype(np.float32), x, x * 0),
        "pick": nd.pick(x, np.array([[0, 1, 1], [1, 0, 1], [0, 0, 1],
                                     [1, 1, 0]], np.int32), axis=2),
        "one_hot": nd.one_hot(np.array([0, 1], np.int32), depth=3),
    }


def test_fault17_numpy_arguments_of_ops_by_name_as_jax():
    jax_out = {k: v.asnumpy() for k, v in _fault17_calls(nd_j).items()}
    with mxt.cpu():
        port_out = {k: v.asnumpy() for k, v in _fault17_calls(nd_t).items()}
    assert sorted(port_out) == sorted(jax_out)
    for name, want in jax_out.items():
        got = port_out[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    # the sums the JAX package gives (broadcast_add: float64 ones)
    assert {k: float(v.sum()) for k, v in port_out.items()} == {
        "take": 102.0, "SequenceMask": 86.0, "SequenceLast": 51.0,
        "SequenceReverse": 276.0, "broadcast_add": 300.0, "where": 221.0,
        "pick": 139.0, "one_hot": 2.0}


def _rnn17(nd, rnn_ops, mode):
    T, N, I, H = 6, 3, 4, 5
    rs = np.random.RandomState(3)
    x = np.random.RandomState(0).randn(T, N, I).astype(np.float32)
    n = rnn_ops.rnn_param_size(mode, 1, I, H, True)
    params = rs.uniform(-0.2, 0.2, n).astype(np.float32)
    args = [nd.array(x), nd.array(params), nd.zeros((2, N, H))]
    if mode == "lstm":
        args.append(nd.zeros((2, N, H)))
    out = nd.RNN(*args, state_size=H, num_layers=1, mode=mode,
                 bidirectional=True, state_outputs=True,
                 use_sequence_length=True,
                 sequence_length=np.array([4, 6, 2], np.int32))
    return [o.asnumpy() for o in out]


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_fault17_rnn_numpy_sequence_length_as_jax(mode):
    from mxnet_tpu.ops import rnn_ops as rnn_j
    from mxnet_tpu_torch.ops import rnn_ops as rnn_t
    want = _rnn17(nd_j, rnn_j, mode)
    with mxt.cpu():
        got = _rnn17(nd_t, rnn_t, mode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


# -- fault 18: config.describe / config.option -------------------------------

_LAYER_KNOBS = (
    "goodput", "goodput_dir", "guard", "heartbeat_timeout_s",
    "collective_timeout_s", "sdc_check_every", "slo", "slo_dir",
    "slo_ttft_ms", "slo_tbt_ms", "slo_availability", "slo_burn_alert",
    "slo_window_fast_s", "slo_window_slow_s", "slo_sample_every", "check",
    "check_dir", "check_large_const_bytes", "check_promotion_min_bytes",
    "check_replicated_min_bytes", "check_donation_min_bytes",
    "check_retrace_limit", "scope", "scope_port")


def test_fault18_describe_and_option_as_jax(monkeypatch):
    from mxnet_tpu import config as cfg_j
    from mxnet_tpu_torch import config as cfg_t
    port, jax = cfg_t.describe(), cfg_j.describe()
    assert port and set(port) <= set(jax), set(port) - set(jax)
    assert set(_LAYER_KNOBS) <= set(port), set(_LAYER_KNOBS) - set(port)
    for name, row in port.items():
        assert set(row) == set(jax[name]) == {"value", "default", "env",
                                              "doc", "source"}
        assert (row["default"], row["env"]) == \
            (jax[name]["default"], jax[name]["env"]), name
        assert row["source"] == jax[name]["source"] == "default", name
        opt_t, opt_j = cfg_t.option(name), cfg_j.option(name)
        assert (opt_t.name, opt_t.default, opt_t.typ, opt_t.env,
                opt_t.choices) == (opt_j.name, opt_j.default, opt_j.typ,
                                   opt_j.env, opt_j.choices), name
    for cfg in (cfg_t, cfg_j):
        cfg.set("trace_sample_every", 4)
    monkeypatch.setenv("MXNET_TPU_TELEMETRY_FLUSH_INTERVAL", "2.5")
    try:
        port, jax = cfg_t.describe(), cfg_j.describe()
        for name, source, value in (
                ("trace_sample_every", "set", 4),
                ("telemetry_flush_interval", "env", 2.5),
                ("diagnostics_ring_size", "default", 256)):
            assert port[name]["source"] == jax[name]["source"] == source
            assert port[name]["value"] == jax[name]["value"] == value
    finally:
        for cfg in (cfg_t, cfg_j):
            cfg.reset("trace_sample_every")


# -- fault 19: a user block's forward gets NDArrays --------------------------

def _masked_seq_net(mx_pkg):
    """The masked sequence net of tests/unittest/test_dataflow.py, on
    `mx_pkg`'s gluon and nd."""
    nd, nn = mx_pkg.nd, mx_pkg.gluon.nn

    class MaskedSeqNet(nn.HybridBlock):
        def __init__(self, features):
            super().__init__()
            self.proj = nn.Dense(1, in_units=features, flatten=False)

        def forward(self, x, valid_len):
            h = self.proj(x)
            b, length = x.shape[0], x.shape[1]
            pos = nd.arange(length).reshape((1, length))
            mask = (pos < valid_len.reshape((-1, 1)).astype("float32")) \
                .astype("float32")
            h = h.reshape((b, length)) * mask
            return h.sum(axis=1) / valid_len.astype("float32")

    return MaskedSeqNet(6)


def _fault19_nets():
    mx.random.seed(5)
    jn = _masked_seq_net(mx)
    jn.initialize()
    arrays = {k: p.data().asnumpy() for k, p in jn.collect_params().items()}
    with CPU:
        tn = _masked_seq_net(mxt)
        tn.initialize()
    weights.load_named_arrays(tn, arrays)
    rng = np.random.RandomState(2)
    x = rng.randn(8, 5, 6).astype(np.float32)
    y = rng.randn(8).astype(np.float32)
    return jn, tn, x, y, np.full(8, 5, np.int32)


def test_fault19_user_forward_gets_ndarrays_in_an_eager_call():
    jn, tn, x, _, valid = _fault19_nets()
    sj = float(jn(nd_j.array(x), nd_j.array(valid)).sum().asscalar())
    with CPU:
        out = tn(nd_t.array(x), nd_t.array(valid))
    assert isinstance(out, nd_t.NDArray)
    st = float(out.sum().asscalar())
    assert abs(sj - 0.12768534) < 1e-6
    assert abs(st - sj) < 1e-6, (st, sj)


def test_fault19_user_forward_gets_ndarrays_in_the_trainer_step(mesh):
    jn, tn, x, y, valid = _fault19_nets()
    lj, lt = gluon_j.loss.L2Loss(), gluon_t.loss.L2Loss()
    tr_j = parallel_j.ShardedTrainer(jn, lambda o, l: lj(o, l), "sgd",
                                     {"learning_rate": 0.05})
    loss_j = float(tr_j.step([nd_j.array(x), nd_j.array(valid)],
                             [nd_j.array(y)]).asscalar())
    with CPU:
        tr_t = parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l), "sgd",
                                         {"learning_rate": 0.05})
        before = tr_t.params[0].clone()
        loss_t = float(tr_t.step([nd_t.array(x), nd_t.array(valid)],
                                 [nd_t.array(y)]).asscalar())
    assert abs(loss_j - 0.44101596) < 1e-6
    assert abs(loss_t - loss_j) < 1e-6, (loss_t, loss_j)
    # the gradient flowed through the NDArrays into the Dense weight
    assert not torch.equal(tr_t.params[0], before)
    tr_j.sync_to_block()
    tr_t.sync_to_block()
    np.testing.assert_allclose(
        tn.proj.weight.detach().numpy(),
        np.asarray(jn.proj.weight.data()._data), rtol=0, atol=1e-6)


def test_fault19_port_layers_keep_their_tensor_forward():
    from mxnet_tpu_torch.gluon import block as block_t
    assert not block_t._user_forward(gluon_t.nn.Dense)
    assert not block_t._user_forward(gpt_t.GPTForCausalLM)
    assert block_t._user_forward(type(_masked_seq_net(mxt)))


def test_libsvmiter_message_names_its_queue_item():
    import os
    import re
    from mxnet_tpu_torch import io as io_t
    from mxnet_tpu_torch.ndarray.ndarray import NotPortedError
    with pytest.raises(NotPortedError) as ei:
        io_t.LibSVMIter(data_libsvm="x", data_shape=(4,), batch_size=2)
    msg = str(ei.value)
    assert "sparse NDArrays are" in msg
    title = re.search(r'"([^"]+)"', msg).group(1)
    assert title == "Left for later PRs"
    roadmap = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "ROADMAP.md")).read()
    section = roadmap[roadmap.index(title + ", in this order"):]
    section = section[:section.index("\n\n1. ")]
    assert "io.LibSVMIter" in section


# -- fault 20: the models' loss and target helpers take numpy arrays ------

_BOXES20 = np.asarray([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]],
                       [[0.2, 0.2, 0.6, 0.6], [-1, -1, -1, -1]]], np.float32)
_LABELS20 = np.asarray([[0, 2], [1, -1]], np.int32)


def _fault20_call(name, pkg):
    """`name` of the package `pkg` ("jax" or "port") on numpy inputs from
    RandomState(0): a list of numpy arrays."""
    import importlib
    root = "mxnet_tpu" if pkg == "jax" else "mxnet_tpu_torch"
    mod = lambda m: importlib.import_module(f"{root}.models.{m}")  # noqa
    rs = np.random.RandomState(0)
    if name == "gpt_lm_loss":
        out = mod("gpt").gpt_lm_loss(
            rs.randn(2, 4, 11).astype(np.float32),
            rs.randint(0, 11, (2, 4)).astype(np.int32),
            (rs.rand(2, 4) > 0.3).astype(np.float32))
    elif name == "bert_pretrain_loss":
        out = mod("bert").bert_pretrain_loss(
            rs.randn(2, 3, 13).astype(np.float32),
            rs.randn(2, 2).astype(np.float32),
            rs.randint(0, 13, (2, 3)).astype(np.int32),
            np.asarray([[1, 1, 0], [1, 0, 0]], np.float32),
            np.asarray([0, 1], np.int32))
    elif name == "label_smoothing_loss":
        out = mod("transformer").label_smoothing_loss(
            rs.randn(2, 5, 9).astype(np.float32),
            np.asarray([[3, 1, 4, 0, 0], [2, 7, 1, 8, 0]], np.int32))
    elif name == "multibox_target":
        ssd = mod("ssd")
        anchors = ssd.generate_anchors([(4, 4), (2, 2)],
                                       sizes=((0.2, 0.3), (0.4, 0.5)),
                                       ratios=((1, 2, 0.5),) * 2)
        out = ssd.multibox_target(anchors, _BOXES20, _LABELS20)
    elif name == "non_max_suppression":
        out = mod("ssd").non_max_suppression(
            np.asarray([[0, 0, 1, 1], [0.02, 0, 1.02, 1],
                        [0.5, 0.5, 1.5, 1.5], [2, 2, 3, 3]], np.float32),
            np.asarray([0.9, 0.85, 0.6, 0.7], np.float32),
            iou_thresh=0.5, topk=4)
    else:
        yolo = mod("yolo")
        model = yolo.YOLOv3Tiny(3, 64) if pkg == "jax" \
            else yolo.YOLOv3Tiny(3, 64, device="cpu")
        out = [t for scale in yolo.yolo_targets(model, _BOXES20 * 64,
                                                _LABELS20)
               for t in (scale["obj"], scale["xy"], scale["wh"],
                         scale["cls"])]
    return [np.asarray(getattr(o, "asnumpy", lambda o=o: o)())
            for o in (out if isinstance(out, (list, tuple)) else [out])]


@pytest.mark.parametrize("name", [
    "gpt_lm_loss", "bert_pretrain_loss", "label_smoothing_loss",
    "multibox_target", "non_max_suppression", "yolo_targets"])
def test_fault20_helpers_take_numpy_as_jax(name):
    """Each model helper on numpy arrays equals the JAX package's on the
    same arrays: float outputs within 1e-6, selections, class ids and
    masks equal, in the same dtypes."""
    want = _fault20_call(name, "jax")
    with mxt.cpu():
        got = _fault20_call(name, "port")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g, w)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def test_fault20_port_anchors_feed_its_own_multibox_target():
    """`generate_anchors` returns numpy, as the JAX one does; the port's
    `multibox_target` takes it beside NDArray boxes, on their device."""
    from mxnet_tpu_torch.models import ssd as ssd_t
    anchors = ssd_t.generate_anchors([(4, 4), (2, 2)],
                                     sizes=((0.2, 0.3), (0.4, 0.5)),
                                     ratios=((1, 2, 0.5),) * 2)
    assert isinstance(anchors, np.ndarray)
    cls_t, box_t, mask = ssd_t.multibox_target(
        anchors, nd_t.array(_BOXES20, ctx=mxt.cpu()),
        nd_t.array(_LABELS20, ctx=mxt.cpu()))
    assert cls_t.context == mxt.cpu()
    assert int((cls_t.asnumpy() > 0).sum()) >= 3
    assert mask.shape == (2, anchors.shape[0], 1)


class _DiesHoldingResultLock:
    """A dataset whose worker, at index 3 of the first pass, takes the
    result queue's cross-process writer lock and dies: what a worker
    killed while its queue's feeder thread writes a batch leaves
    behind."""

    def __init__(self, marker):
        self.marker = marker

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 3 and not os.path.exists(self.marker):
            open(self.marker, "w").close()
            frame = sys._getframe()
            while "data_q" not in frame.f_locals:
                frame = frame.f_back
            frame.f_locals["data_q"]._wlock.acquire()
            os._exit(9)
        return np.full((2,), i, np.float32)


def test_fault24_respawned_worker_gets_a_fresh_result_queue(tmp_path):
    """Fault 24: a worker that dies holding the result queue's writer
    lock. The JAX DataLoader forks the replacement onto the same queue,
    whose feeder blocks on that lock, so no batch comes until
    `dataloader_timeout` (here 3 s) raises; the port's replaces the pool
    with its queues and gives every batch, in order."""
    from mxnet_tpu import config as config_j
    from mxnet_tpu import resilience as resilience_j
    from mxnet_tpu_torch import config as config_t
    from mxnet_tpu_torch import resilience as resilience_t
    for config, resilience in ((config_j, resilience_j),
                               (config_t, resilience_t)):
        config.set("retry_backoff_s", 0.01)
        resilience.enable()
    # only the JAX side needs a short watchdog to show its hang; the
    # port's fresh pool keeps the default bound (a loaded machine can take
    # seconds to fork it)
    config_j.set("dataloader_timeout", 3)
    try:
        with pytest.raises(RuntimeError, match="produced no batch"):
            list(gluon_j.data.DataLoader(
                _DiesHoldingResultLock(str(tmp_path / "jax")),
                batch_size=2, num_workers=1))
        with mxt.cpu():
            got = list(gluon_t.data.DataLoader(
                _DiesHoldingResultLock(str(tmp_path / "port")),
                batch_size=2, num_workers=1))
    finally:
        for config, resilience in ((config_j, resilience_j),
                                   (config_t, resilience_t)):
            resilience.disable()
            config.reset("retry_backoff_s")
            config.reset("dataloader_timeout")
    assert os.path.exists(tmp_path / "port")
    assert [float(b[0, 0].asscalar()) for b in got] == [0, 2, 4, 6]
