"""PyTorch port, `mx.sym` and its executor against the JAX package on the
CPU (the cases of `tests/unittest/test_symbol.py` that apply, each held
against the JAX package, and more).

Symbols built with the same names give the same `list_arguments`,
`list_outputs`, `list_auxiliary_states`, `infer_shape` and the same
`tojson` text byte for byte; each package loads the other's JSON (and
files). Executors bound to the same carried arrays give forward outputs
and gradients within 1e-5, with grad_req "write", "null" and "add",
BatchNorm's moving statistics written back only in training, every
SoftmaxOutput normalization with `use_ignore`, and a backward after
`forward(is_train=False)` (which the JAX executor replays in training
mode; the port replays it from the random streams the forward started
from, so a dropout mask is the one a training forward draws).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as nd_j
from mxnet_tpu import symbol as sym_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import symbol as sym_t

PKGS = {"jax": (mx, sym_j, nd_j), "port": (mxt, sym_t, nd_t)}
TOL = 1e-5


def _mlp(sym, norm="null"):
    data = sym.Variable("data")
    h = sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = sym.Activation(h, act_type="relu", name="relu1")
    h = sym.FullyConnected(h, num_hidden=10, name="fc2")
    return sym.SoftmaxOutput(h, name="softmax", normalization=norm)


def _conv_bn(sym):
    data = sym.Variable("data")
    c = sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                        name="conv1")
    b = sym.BatchNorm(c, name="bn1", momentum=0.8)
    a = sym.Activation(b, act_type="tanh", name="act")
    p = sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool")
    f = sym.FullyConnected(p, num_hidden=5, name="fc")
    return sym.SoftmaxOutput(f, name="softmax", normalization="batch")


def _arith(sym):
    a, b = sym.Variable("a"), sym.Variable("b", shape=(2, 3))
    c = 2.0 * a + b / 4.0 - 3.0
    d = sym.Group([c * a, (1.0 - c) ** 2, -c, sym.relu(c, name="r")])
    return d


def _generic(sym):
    a = sym.var("a")
    r = sym.reshape(a, shape=(2, 3), name="rs")
    return sym.concat(r, sym.transpose(r, name="tr").reshape(shape=(2, 3),
                                                             name="rs2"),
                      dim=0, name="cat")


def _attrs(sym):
    with mx.AttrScope(ctx_group="dev1") if sym is sym_j else \
            mxt.AttrScope(ctx_group="dev1"):
        a = sym.var("a")
        h = sym.FullyConnected(a, num_hidden=3, name="fc")
    return sym.LayerNorm(h, name="ln")


def _named(pkg, build):
    """The graph built inside a fresh NameManager, so auto names agree."""
    m, sym, _ = PKGS[pkg]
    with m.name.NameManager():
        return build(sym)


GRAPHS = {"mlp": _mlp, "conv_bn": _conv_bn, "arith": _arith,
          "generic": _generic, "attrs": _attrs}
SHAPES = {"mlp": {"data": (6, 20)}, "conv_bn": {"data": (4, 3, 8, 8)},
          "arith": {"a": (2, 3)}, "generic": {"a": (6,)},
          "attrs": {"a": (4, 7)}}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_introspection_and_json_equal_jax(graph):
    sj, st = (_named(p, GRAPHS[graph]) for p in ("jax", "port"))
    assert st.list_arguments() == sj.list_arguments()
    assert st.list_outputs() == sj.list_outputs()
    assert st.list_auxiliary_states() == sj.list_auxiliary_states()
    assert st.list_inputs() == sj.list_inputs()
    assert st.attr_dict() == sj.attr_dict()
    assert st.infer_shape(**SHAPES[graph]) == sj.infer_shape(**SHAPES[graph])
    assert st.infer_type() == sj.infer_type()
    assert st.tojson() == sj.tojson()
    # each package loads the other's JSON and writes it back unchanged
    assert sym_t.load_json(sj.tojson()).tojson() == sj.tojson()
    assert sym_j.load_json(st.tojson()).tojson() == st.tojson()
    ints = st.get_internals()
    assert ints.list_outputs() == sj.get_internals().list_outputs()


def test_symbol_files_load_both_ways(tmp_path):
    sj, st = _named("jax", _conv_bn), _named("port", _conv_bn)
    sj.save(str(tmp_path / "j-symbol.json"))
    st.save(str(tmp_path / "t-symbol.json"))
    assert (tmp_path / "j-symbol.json").read_bytes() == \
        (tmp_path / "t-symbol.json").read_bytes()
    assert sym_t.load(str(tmp_path / "j-symbol.json")).tojson() == \
        st.tojson()
    assert sym_j.load(str(tmp_path / "t-symbol.json")).tojson() == \
        sj.tojson()


def test_list_arguments_auto_vars():
    net = _mlp(sym_t)
    assert net.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]
    assert net.list_outputs() == ["softmax_output"]
    assert net.list_auxiliary_states() == []
    args, outs, _ = net.infer_shape(data=(32, 100))
    d = dict(zip(net.list_arguments(), args))
    assert d["fc1_weight"] == (16, 100) and d["fc2_weight"] == (10, 16)
    assert outs == [(32, 10)]


def test_kernel_ops_infer_shapes_by_rule():
    """Ops that reach a kernel wrapper infer by their shape rule (the
    wrappers take CPU and CUDA tensors only, never meta)."""
    qkv, m = sym_t.var("qkv"), sym_t.var("mask")
    att = sym_t.fused_self_attention(qkv, mask=m, num_heads=4, name="att")
    q = sym_t.var("q")
    fl = sym_t.flash_attention(q, q, q, causal=True, name="fl")
    x, w, s = sym_t.var("x"), sym_t.var("w"), sym_t.var("s")
    qd = sym_t.contrib.quantized_dense(x, w, s, flatten=True, name="qd")
    nms = sym_t.contrib.box_nms(sym_t.var("rows"), name="nms")
    g = sym_t.Group([att, fl, qd, nms, sym_t.zeros((2, 5))])
    _, outs, _ = g.infer_shape(qkv=(2, 8, 96), mask=(2, 8),
                               q=(2, 4, 8, 16), x=(3, 2, 4), w=(5, 8),
                               s=(5,), rows=(2, 10, 6))
    assert outs == [(2, 8, 32), (2, 4, 8, 16), (3, 5), (2, 10, 6), (2, 5)]


def _carried(shapes, names, seed=0):
    rs = np.random.RandomState(seed)
    return {n: rs.normal(0, 0.3, shapes[n]).astype(np.float32)
            for n in names}


def _bind_both(build, shapes, grad_req="write", extra=None):
    """The graph bound in both packages to the same carried arrays."""
    exs = {}
    for pkg in ("jax", "port"):
        m, sym, _ = PKGS[pkg]
        s = _named(pkg, build)
        ctx = m.cpu()
        ex = s.simple_bind(ctx=ctx, grad_req=grad_req, **shapes)
        exs[pkg] = ex
    names = [n for n in exs["jax"].arg_dict]
    arg_shapes = {n: exs["jax"].arg_dict[n].shape for n in names}
    vals = _carried(arg_shapes, names)
    vals.update(extra or {})
    aux = {n: np.abs(_carried({n: a.shape}, [n], 1)[n]) + 0.5
           for n, a in exs["jax"].aux_dict.items()}
    for ex in exs.values():
        ex.copy_params_from(vals, aux)
    return exs, vals


def _equal(a, b, tol=TOL):
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("graph,train", [("mlp", True), ("conv_bn", True),
                                         ("conv_bn", False),
                                         ("arith", True)])
def test_forward_backward_equal_jax(graph, train):
    shapes = dict(SHAPES[graph])
    extra = {}
    if graph in ("mlp", "conv_bn"):
        n = shapes["data"][0]
        classes = 10 if graph == "mlp" else 5
        extra["softmax_label"] = np.random.RandomState(3).randint(
            0, classes, n).astype(np.float32)
    if graph == "arith":
        shapes["b"] = (2, 3)
    exs, _ = _bind_both(GRAPHS[graph], shapes, extra=extra)
    outs = {p: ex.forward(is_train=train) for p, ex in exs.items()}
    for oj, ot in zip(outs["jax"], outs["port"]):
        _equal(ot, oj)
    heads = [np.random.RandomState(4).normal(size=o.shape).astype(np.float32)
             for o in outs["jax"]]
    exs["jax"].backward([nd_j.array(h) for h in heads])
    exs["port"].backward([nd_t.array(h, ctx=mxt.cpu()) for h in heads])
    for n, g in exs["jax"].grad_dict.items():
        if g is not None:
            _equal(exs["port"].grad_dict[n], g)
    for n, a in exs["jax"].aux_dict.items():
        _equal(exs["port"].aux_dict[n], a)


def test_batchnorm_aux_written_back_only_in_training():
    """Mirror of the JAX test: moving_mean moves toward the batch mean by
    the momentum in training, and not in evaluation; as in the JAX
    package."""
    def build(sym):
        return sym.BatchNorm(sym.Variable("data"), name="bn", momentum=0.5)
    x = np.random.RandomState(0).normal(2.0, 3.0, (8, 4)).astype(np.float32)
    exs, _ = _bind_both(build, {"data": (8, 4)},
                        extra={"data": x, "bn_gamma": np.ones(4, np.float32)})
    for ex in exs.values():
        ex.copy_params_from({}, {"bn_moving_mean": np.zeros(4, np.float32),
                                 "bn_moving_var": np.ones(4, np.float32)})
        ex.forward(is_train=True)
    want = 0.5 * x.mean(axis=0)
    for ex in exs.values():
        np.testing.assert_allclose(ex.aux_dict["bn_moving_mean"].asnumpy(),
                                   want, rtol=1e-4)
    _equal(exs["port"].aux_dict["bn_moving_var"],
           exs["jax"].aux_dict["bn_moving_var"])
    before = exs["port"].aux_dict["bn_moving_mean"].asnumpy()
    exs["port"].forward(is_train=False)
    np.testing.assert_array_equal(
        exs["port"].aux_dict["bn_moving_mean"].asnumpy(), before)


def test_grad_req_null_and_add():
    def build(sym):
        return sym.Variable("a") * sym.Variable("b")
    outs = {}
    for pkg in ("jax", "port"):
        m, sym, nd = PKGS[pkg]
        c = _named(pkg, build)
        ex = c.simple_bind(ctx=m.cpu(), grad_req={"a": "add", "b": "null"},
                           a=(3,), b=(3,))
        ex.copy_params_from({"a": np.array([1.0, 2.0, 3.0], np.float32),
                             "b": np.array([4.0, 5.0, 6.0], np.float32)})
        ex.forward(is_train=True)
        ex.backward()
        ex.backward()                   # "add" accumulates
        assert ex.grad_dict["b"] is None
        outs[pkg] = ex.grad_dict["a"].asnumpy()
    np.testing.assert_allclose(outs["port"], [8.0, 10.0, 12.0])
    np.testing.assert_array_equal(outs["port"], outs["jax"])


@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
@pytest.mark.parametrize("use_ignore", [False, True])
def test_softmax_output_normalizations(norm, use_ignore):
    def build(sym):
        data = sym.Variable("data")
        h = sym.FullyConnected(data, num_hidden=6, name="fc")
        return sym.SoftmaxOutput(h, name="sm", normalization=norm,
                                 use_ignore=use_ignore, ignore_label=2,
                                 grad_scale=0.5)
    label = np.array([0, 2, 5, 2, 1], np.float32)
    exs, _ = _bind_both(build, {"data": (5, 7)},
                        extra={"sm_label": label})
    for ex in exs.values():
        ex.forward(is_train=True)
        ex.backward()
    for n in ("fc_weight", "fc_bias", "data"):
        _equal(exs["port"].grad_dict[n], exs["jax"].grad_dict[n])


def test_backward_after_an_evaluation_forward_equals_jax():
    exs, _ = _bind_both(_conv_bn, {"data": (4, 3, 8, 8)},
                        extra={"softmax_label": np.array([0, 1, 4, 2],
                                                         np.float32)})
    for ex in exs.values():
        ex.forward(is_train=False)
        ex.backward()
    for n, g in exs["jax"].grad_dict.items():
        if g is not None:
            _equal(exs["port"].grad_dict[n], g)
    # the replay writes no moving statistics back
    for n, a in exs["jax"].aux_dict.items():
        _equal(exs["port"].aux_dict[n], a)


def test_backward_after_an_evaluation_forward_replays_the_dropout_mask():
    """A dropout graph: forward(is_train=False) then backward gives the
    gradients of forward(is_train=True) then backward from the same
    streams (the mask repeats), and leaves the streams where the
    evaluation forward left them."""
    data = sym_t.var("data")
    h = sym_t.FullyConnected(data, num_hidden=32, name="fc")
    out = sym_t.sum(sym_t.Dropout(h, p=0.5, name="drop"), name="s")
    x = np.random.RandomState(0).normal(size=(4, 8)).astype(np.float32)
    grads = []
    for train in (True, False):
        mxt.random.seed(11, "cpu")
        ex = out.simple_bind(ctx=mxt.cpu(), data=(4, 8))
        ex.copy_params_from(_carried({"fc_weight": (32, 8),
                                      "fc_bias": (32,)},
                                     ["fc_weight", "fc_bias"]))
        ex.forward(is_train=train, data=x)
        state = mxt.random.get_state()
        ex.backward()
        grads.append(ex.grad_dict["fc_bias"].asnumpy())
        after = mxt.random.get_state()
        assert torch.equal(after[2]["cpu"], state[2]["cpu"])
    np.testing.assert_array_equal(grads[0], grads[1])
    # each bias gradient counts its unit's kept rows, times 1 / (1 - p)
    assert set(np.unique(grads[0])) <= {0.0, 2.0, 4.0, 6.0, 8.0}
    assert (grads[0] < 8).any()


def test_symbol_arithmetic_eval_and_group():
    a, b = sym_t.Variable("a"), sym_t.Variable("b")
    c = 2.0 * a + b / 4.0 - 3.0
    out = c.eval(ctx=mxt.cpu(), a=nd_t.array([1.0, 2.0], ctx=mxt.cpu()),
                 b=nd_t.array([4.0, 8.0], ctx=mxt.cpu()))[0]
    np.testing.assert_allclose(out.asnumpy(), [0.0, 3.0])
    g = sym_t.Group([a * 2.0, a + 1.0])
    assert len(g.list_outputs()) == 2
    o = g.bind(args={"a": nd_t.array([3.0], ctx=mxt.cpu())}).forward()
    np.testing.assert_allclose(o[0].asnumpy(), [6.0])
    np.testing.assert_allclose(o[1].asnumpy(), [4.0])
    assert g[1].list_outputs() == g.list_outputs()[1:2]


def test_generic_ops_variable_heads_and_internals():
    a = sym_t.Variable("a")
    assert sym_t.reshape(a, shape=(2, 3)).infer_shape(a=(6,))[1] == [(2, 3)]
    assert sym_t.concat(a, a, dim=0).infer_shape(a=(6,))[1] == [(12,)]
    assert sym_t.Variable("x").infer_shape(x=(2, 3))[1] == [(2, 3)]
    o = sym_t.FullyConnected(a, num_hidden=4, name="convout")
    assert o.get_internals()["convout"].list_outputs()[0] \
        .startswith("convout")
    assert a.relu().list_arguments() == ["a"]          # ops as methods
    with pytest.raises(mxt.MXNetError):
        sym_t.FullyConnected(num_hidden=3)             # 'data' required
    with pytest.raises(mxt.MXNetError):
        sym_t._invoke("no_such_op", [a], {})


def test_simple_bind_places_arrays_on_the_context():
    ex = _mlp(sym_t).simple_bind(ctx=mxt.cpu(), data=(2, 5))
    assert all(a.context.type == "cpu" for a in ex.arg_dict.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):   # the card, and there is none
            _mlp(sym_t).simple_bind(data=(2, 5))
