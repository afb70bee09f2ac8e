"""PyTorch port, control flow against the JAX package on the CPU:
`nd.contrib.foreach` / `while_loop` / `cond` (the eager loops, with
gradients), `isinf` / `isnan` / `isfinite`, and `sym.contrib`'s forms
through the symbolic executor and `Module.fit`, from the same seeded
numpy inputs. Values and gradients within 1e-5 (float32).

Cases beyond the JAX package's own unit tests: a `foreach` body that
captures a `gluon.Parameter` (its gradient read through `p.grad()`), a
`while_loop` that never runs (its zero rows' shapes come from a probe on
meta tensors that leaves the random streams where they were), a JSON
round trip of a `_foreach` node whose body captures a free variable,
and graphs saved by the JAX package loaded and run by the port (and the
port's by the JAX package).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import io as io_j
from mxnet_tpu import module as mod_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import symbol as sym_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import io as io_t
from mxnet_tpu_torch import module as mod_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import random as random_t
from mxnet_tpu_torch import symbol as sym_t

CPU = mxt.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": (nd_j, ag_j, gluon_j), "port": (nd_t, ag_t, gluon_t)}
RS = np.random.RandomState(0)
XS = RS.randn(5, 3).astype(np.float32)
WV = RS.randn(3).astype(np.float32)


def _arr(pkg, v):
    nd = PKGS[pkg][0]
    return nd.array(v, ctx=CPU) if pkg == "port" else nd.array(v)


def _both(fn):
    """fn(pkg) on both packages (the port's inside `with mx.cpu()`)."""
    want = fn("jax")
    with CPU:
        got = fn("port")
    return got, want


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


# -- nd.contrib ---------------------------------------------------------------

def _foreach_run(pkg):
    nd, ag, _ = PKGS[pkg]
    data, w = _arr(pkg, XS), _arr(pkg, WV)
    w.attach_grad()

    def body(x, states):
        s, = states
        new = nd.tanh(s + x * w)
        return [new * 2, new.sum()], [new]

    with ag.record():
        (outs, total), states = nd.contrib.foreach(body, [data],
                                                   [_arr(pkg, np.zeros(3))])
        loss = (outs * outs).sum() + total.sum()
    loss.backward()
    return [outs.asnumpy(), total.asnumpy(), states[0].asnumpy(),
            w.grad.asnumpy()]


def test_foreach_values_and_gradient_as_jax():
    _close(*_both(_foreach_run))


def _foreach_param_run(pkg):
    nd, ag, gluon = PKGS[pkg]
    p = gluon.Parameter("w", shape=(3, 3))
    p.initialize()
    p.set_data(RS.__class__(1).randn(3, 3).astype(np.float32) * 0.5)

    def body(x, s):
        h = nd.tanh(nd.dot(x + s, p.data()))
        return h, h

    with ag.record():
        outs, final = nd.contrib.foreach(body, _arr(pkg, XS),
                                         _arr(pkg, np.zeros(3)))
        loss = outs.sum() + (final * final).sum()
    loss.backward()
    return [outs.asnumpy(), final.asnumpy(), p.grad().asnumpy()]


def test_foreach_body_captures_a_parameter_as_jax():
    got, want = _both(_foreach_param_run)
    _close(got, want)
    assert np.abs(got[2]).sum() > 0


def _while_run(pkg):
    nd, ag, _ = PKGS[pkg]
    x = _arr(pkg, np.asarray([1.5], np.float32))
    x.attach_grad()

    def cond(v, acc):
        return acc.sum() < 20

    def func(v, acc):
        return [v * acc, acc + 1], [v * 1.5, acc + v]

    with ag.record():
        (o1, o2), (v_fin, acc_fin) = nd.contrib.while_loop(
            cond, func, [x, _arr(pkg, np.asarray([1.0], np.float32))],
            max_iterations=10)
        loss = o1.sum() + v_fin.sum() * 2 + acc_fin.sum()
    loss.backward()
    return [o1.asnumpy(), o2.asnumpy(), v_fin.asnumpy(), acc_fin.asnumpy(),
            x.grad.asnumpy()]


def test_while_loop_values_padding_and_gradient_as_jax():
    got, want = _both(_while_run)
    _close(got, want)
    assert got[0].shape == (10, 1) and not got[0][-1].any()


def _never_run(pkg):
    nd, _, _ = PKGS[pkg]

    def cond(v, m):
        return v.sum() > 100

    def func(v, m):
        return nd.dot(m, v), [v + 1, m]

    outs, fin = nd.contrib.while_loop(
        cond, func, [_arr(pkg, np.ones(3, np.float32)),
                     _arr(pkg, np.ones((2, 3), np.float32))],
        max_iterations=4)
    assert not isinstance(outs, list)
    return [outs.asnumpy(), fin[0].asnumpy(), fin[1].asnumpy()]


def test_while_loop_that_never_runs_as_jax():
    got, want = _both(_never_run)
    assert got[0].shape == want[0].shape == (4, 2)
    _close(got, want)


def test_never_run_probe_reads_no_data_and_draws_nothing():
    calls = []

    def func(v):
        calls.append(v._t.device.type)
        nd_t.random.uniform(shape=(3,), ctx=CPU)      # a draw in the probe
        return v * 2, [v]

    random_t.seed(5, "cpu")
    before = random_t.get_state()
    with CPU:
        outs, _ = nd_t.contrib.while_loop(
            lambda v: v.sum() < 0, func, [nd_t.ones((3,))],
            max_iterations=2)
    after = random_t.get_state()
    assert calls == ["meta"]
    assert outs.shape == (2, 3) and not outs.asnumpy().any()
    assert before[0] == after[0] and torch.equal(before[1], after[1])
    assert before[2].keys() == after[2].keys()
    for k in before[2]:
        assert torch.equal(before[2][k], after[2][k])


def _cond_run(pkg):
    nd, ag, _ = PKGS[pkg]
    a, b = _arr(pkg, np.asarray([3.0], np.float32)), _arr(
        pkg, np.asarray([4.0, 1.0], np.float32))
    a.attach_grad()
    b.attach_grad()
    out = []
    for flip in (1.0, -1.0):
        with ag.record():
            y = nd.contrib.cond(a.sum() * flip > 0,
                                lambda x, z: x * z * z,
                                lambda x, z: -x + z,
                                inputs=[a, b])
            y2 = nd.contrib.cond(lambda: (a * flip).sum() > 0,
                                 lambda: a * 2, lambda: a * 3)
            loss = y.sum() + y2.sum()
        loss.backward()
        out += [y.asnumpy(), y2.asnumpy(), a.grad.asnumpy(),
                b.grad.asnumpy()]
    return out


def test_cond_both_branches_and_gradients_as_jax():
    _close(*_both(_cond_run))


def _finite_run(pkg):
    nd = PKGS[pkg][0]
    x = _arr(pkg, np.asarray([np.nan, np.inf, -np.inf, 1.0], np.float32))
    return [np.asarray(f(x).asnumpy()) for f in (
        nd.contrib.isinf, nd.contrib.isnan, nd.contrib.isfinite)]


def test_isinf_isnan_isfinite_as_jax():
    got, want = _both(_finite_run)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.bool_
        np.testing.assert_array_equal(g, w)


# -- sym.contrib --------------------------------------------------------------

T, N, H = 4, 2, 3
SX = RS.randn(T, N, H).astype(np.float32)
SW = (RS.randn(H, H) * 0.4).astype(np.float32)


def _graphs(sym):
    """{name: (grouped symbol, {var: shape})} of the three forms."""
    data, s0, w = sym.var("data"), sym.var("s0"), sym.var("w")

    def body(x, s):
        s2 = sym.tanh(sym.dot(x + s, w))
        return s2 * 2.0, s2

    outs, fin = sym.contrib.foreach(body, data, s0, name="fe")
    i0, acc0 = sym.var("i0"), sym.var("acc0")
    wl_outs, wl_fin = sym.contrib.while_loop(
        lambda i, acc: sym.sum(acc) < 5.0,
        lambda i, acc: ([i * w], [i + 1.0, acc + i]),
        [i0, acc0], max_iterations=6, name="wl")
    p, x = sym.var("p"), sym.var("x")
    cd = sym.contrib.cond(sym.sum(p) > 0.0, lambda v: sym.dot(v, w),
                          lambda v: v - 1.0, x, name="cd")
    return {"foreach": (sym.Group([outs, fin]),
                        {"data": (T, N, H), "s0": (N, H), "w": (H, H)}),
            "while_loop": (sym.Group([wl_outs[0], wl_fin[1]]),
                           {"i0": (H,), "acc0": (H,), "w": (H, H)}),
            "cond": (cd, {"p": (1,), "x": (N, H), "w": (H, H)})}


VALUES = {"data": SX, "s0": np.zeros((N, H), np.float32), "w": SW,
          "i0": np.asarray([0.5, 1.0, -0.5], np.float32),
          "acc0": np.zeros((H,), np.float32),
          "x": SX[0], "p": np.asarray([1.0], np.float32)}


def _bind(pkg, graph, shapes, p=1.0):
    m = mx if pkg == "jax" else mxt
    ex = graph.simple_bind(ctx=m.cpu(), grad_req="write", **shapes)
    for k in shapes:
        v = VALUES[k] if k != "p" else np.asarray([p], np.float32)
        ex.arg_dict[k][:] = v
    outs = ex.forward(is_train=True)
    ex.backward()                 # head gradients of ones
    return [o.asnumpy() for o in outs] + [
        ex.grad_dict[k].asnumpy() for k in sorted(shapes)]


@pytest.mark.parametrize("form", ["foreach", "while_loop", "cond"])
def test_sym_forms_values_and_gradients_as_jax(form):
    for p in ((1.0, -1.0) if form == "cond" else (1.0,)):
        want = _bind("jax", *_graphs(sym_j)[form], p=p)
        got = _bind("port", *_graphs(sym_t)[form], p=p)
        _close(got, want)


def test_sym_foreach_json_roundtrip(tmp_path):
    graph, shapes = _graphs(sym_t)["foreach"]
    f = str(tmp_path / "cf.json")
    graph.save(f)
    loaded = sym_t.load(f)
    assert sorted(loaded.list_arguments()) == ["data", "s0", "w"]
    assert not any("slice" in a for a in loaded.list_arguments())
    assert loaded.tojson() == graph.tojson()
    _close(_bind("port", loaded, shapes), _bind("port", graph, shapes))


@pytest.mark.parametrize("form", ["foreach", "while_loop", "cond"])
def test_graphs_saved_by_one_package_run_in_the_other(form):
    jg, shapes = _graphs(sym_j)[form]
    tg, _ = _graphs(sym_t)[form]
    want = _bind("jax", jg, shapes)
    got = _bind("port", sym_t.load_json(jg.tojson()), shapes)
    _close(got, want)
    back = _bind("jax", sym_j.load_json(tg.tojson()), shapes)
    _close(back, want)


def _scan_net(sym):
    # batch-major data, scanned over time; the weight's shape is given,
    # as nothing outside the subgraph reads it
    data = sym.transpose(sym.var("data"), axes=(1, 0, 2))
    w = sym.var("rnn_w", shape=(H, H))

    def body(x, s):
        s2 = sym.tanh(sym.dot(x, w) + s)
        return s2, s2

    outs, fin = sym.contrib.foreach(body, data, sym.var("s0"), name="scan")
    h = sym.FullyConnected(fin, num_hidden=2, name="fc")
    return sym.SoftmaxOutput(h, name="softmax", normalization="batch")


def _fit(pkg):
    m, io, mod, sym = ((mx, io_j, mod_j, sym_j) if pkg == "jax"
                       else (mxt, io_t, mod_t, sym_t))
    rs = np.random.RandomState(4)
    x = rs.randn(16, T, H).astype(np.float32)
    y = rs.randint(0, 2, 16).astype(np.float32)
    it = io.NDArrayIter({"data": x, "s0": np.zeros((16, H), np.float32)},
                        {"softmax_label": y}, batch_size=8)
    module = mod.Module(_scan_net(sym), data_names=("data", "s0"),
                        label_names=("softmax_label",), context=m.cpu())
    arg = {"rnn_w": SW, "fc_weight": rs.randn(2, H).astype(np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    nd = nd_j if pkg == "jax" else nd_t
    kw = {} if pkg == "jax" else {"ctx": CPU}
    module.fit(it, num_epoch=3, optimizer="sgd",
               optimizer_params={"learning_rate": 0.1},
               arg_params={k: nd.array(v, **kw) for k, v in arg.items()})
    arg, _ = module.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def test_module_fit_over_a_foreach_graph_as_jax():
    got, want = _fit("port"), _fit("jax")
    assert sorted(got) == sorted(want) == ["fc_bias", "fc_weight", "rnn_w"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    assert not np.allclose(got["rnn_w"], SW)
