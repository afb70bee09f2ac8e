"""PyTorch port, gluon's classic Block surface and the rest of `gluon.nn`
and `gluon.loss` against the JAX package on the CPU, from the same
seeded numpy inputs and the same weights (carried by `collect_params`
name):

* a user `HybridBlock` written with `hybrid_forward(F, x, weight)` inside
  `name_scope()` and a `register_child`: the same outputs and gradients
  (within 1e-6), `F` the port's `nd`;
* `Sequential`, `_children`, `params`, `summary` (the JAX table, line for
  line) and its refusal once hybridized, the hybridize cache keys;
* `export` -> `gluon.SymbolBlock.imports`: the imported block gives the
  exported block's output (within 1e-6);
* `functional_call` with substituted parameters;
* each new layer (`Conv2DTranspose`, `MaxPool3D`, `AvgPool3D`,
  `GroupNorm`, `InstanceNorm`, `ELU`, `SELU`, `GELU`, `Swish`,
  `Lambda`, `HybridLambda`, `LayerNorm(axis)`, `Dropout(axes)`) and
  each new loss (with weight and sample weight): outputs within 1e-6,
  input gradients within 1e-5. `PReLU` is held to its formula: the JAX
  package's raises in an eager call.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import weights

CPU = mxt.cpu()


def _carry(jnet, tnet):
    """Initialise the JAX net, then give the port's net its weights."""
    arrays = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    weights.load_named_arrays(tnet, arrays)
    return arrays


def _scaled_dense(gluon):
    class ScaledDense(gluon.HybridBlock):
        """A user block: Dense, then a learned per-unit scale and tanh."""

        def __init__(self, units, in_units, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.dense = gluon.nn.Dense(units, in_units=in_units)
                self.scale = gluon.Parameter("scale", shape=(units,))
            self.register_child(gluon.nn.Activation("relu"), "act")

        def hybrid_forward(self, F, x, scale):
            return F.tanh(self._children["act"](self.dense(x))) * scale

    return ScaledDense


def _user_nets():
    jn = _scaled_dense(gluon_j)(4, 3, prefix="sd_")
    jn.initialize(mx.init.Uniform(0.5))
    with mxt.cpu():
        tn = _scaled_dense(gluon_t)(4, 3, prefix="sd_")
        tn.initialize()
    _carry(jn, tn)
    return jn, tn


def test_hybrid_forward_user_block_like_jax():
    jn, tn = _user_nets()
    assert list(tn.collect_params()) == list(jn.collect_params()) == [
        "scale", "dense.weight", "dense.bias"]
    assert list(tn._children) == list(jn._children) == ["dense", "act"]
    assert list(tn.params) == list(jn.params) == ["scale"]
    assert tn.prefix == jn.prefix == "sd_"
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    xj, xt = nd_j.array(x), nd_t.array(x, ctx=CPU)
    for a in (xj, xt):
        a.attach_grad()
    with ag_j.record():
        yj = jn(xj)
    yj.backward()
    with ag_t.record():
        yt = tn(xt)
    yt.backward()
    assert isinstance(yt, nd_t.NDArray)
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.asnumpy(), xj.grad.asnumpy(),
                               rtol=1e-6, atol=1e-6)
    for k, p in tn.collect_params().items():
        np.testing.assert_allclose(
            p.grad.numpy(), jn.collect_params()[k].grad().asnumpy(),
            rtol=1e-6, atol=1e-6, err_msg=k)


def _summary_net(gluon):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu"), gluon.nn.Dropout(0.5),
            gluon.nn.Dense(2))
    return net


def test_summary_is_the_jax_table(capsys):
    jn = _summary_net(gluon_j)
    jn.initialize()
    with mxt.cpu():
        tn = _summary_net(gluon_t)
        tn.initialize()
    tj = jn.summary(nd_j.ones((4, 3)))
    tt = tn.summary(nd_t.ones((4, 3), ctx=CPU))
    assert tt == tj
    assert "Total params: 50" in tt
    assert not tn._forward_hooks and not tn._children["0"]._forward_hooks
    tn.hybridize()
    with pytest.raises(ValueError, match="hybridize"):
        tn.summary(nd_t.ones((4, 3), ctx=CPU))


def test_hybridize_cache_keys_like_jax():
    jn, tn = _summary_net(gluon_j), _summary_net(gluon_t)
    jn.initialize()
    with mxt.cpu():
        tn.initialize()
    for net, nd, kw in ((jn, nd_j, {}), (tn, nd_t, {"ctx": CPU})):
        net(nd.ones((2, 3), **kw))
        net.hybridize()
        for shape in ((2, 3), (2, 3), (5, 3)):
            net(nd.ones(shape, **kw))
    assert list(tn._cache) == list(jn._cache)
    assert list(tn._cache.values()) == [2, 1]


def test_sequential_and_lambdas():
    x = np.random.RandomState(1).randn(2, 6).astype(np.float32)
    outs = []
    for gluon, nd, kw in ((gluon_j, nd_j, {}), (gluon_t, nd_t, {"ctx": CPU})):
        net = gluon.nn.Sequential()
        net.add(gluon.nn.Lambda(lambda a: a * 2),
                gluon.nn.HybridLambda("relu"),
                gluon.nn.HybridLambda(lambda F, a: F.exp(-a)))
        assert len(net) == 3 and list(net._children) == ["0", "1", "2"]
        outs.append(net(nd.array(x, **kw)).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)


def test_export_then_symbolblock_imports(tmp_path):
    with mxt.cpu():
        net = gluon_t.nn.HybridSequential()
        net.add(_scaled_dense(gluon_t)(6, 4), gluon_t.nn.Dropout(0.3),
                gluon_t.nn.Flatten(), gluon_t.nn.Dense(3, in_units=6))
        net.initialize()
        x = nd_t.array(np.random.RandomState(2).randn(5, 4)
                       .astype(np.float32))
        want = net(x).asnumpy()
        prefix = str(tmp_path / "net")
        net.export(prefix, epoch=3)
        blk = gluon_t.SymbolBlock.imports(f"{prefix}-symbol.json", ["data"],
                                          f"{prefix}-0003.params", ctx=CPU)
        got = blk(x).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the params file is the JAX package's save_parameters file
    loaded = nd_j.load(f"{prefix}-0003.params")
    assert sorted(loaded) == sorted(net.collect_params())
    with pytest.raises(NotImplementedError, match="symbolic form"):
        gluon_t.nn.BatchNorm(in_channels=2).export(str(tmp_path / "bn"))


def test_functional_call_and_deferred_error():
    with mxt.cpu():
        net = gluon_t.nn.Dense(2, in_units=3)
        net.initialize()
        fn, gp, aux = gluon_t.functional_call(net)
        assert [n for n, _ in gp] == ["weight", "bias"] and aux == []
        w = torch.ones(2, 3)
        out, new_aux = fn([w, torch.zeros(2)], [], None, torch.ones(1, 3))
        np.testing.assert_array_equal(out.numpy(), [[3.0, 3.0]])
        d = gluon_t.nn.Dense(2)
        with pytest.raises(gluon_t.DeferredInitializationError):
            d(nd_t.ones((1, 3)))
    assert issubclass(gluon_t.DeferredInitializationError, RuntimeError)


# -- the new layers ------------------------------------------------------------

LAYERS = [
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, strides=2, padding=1,
                             output_padding=1, in_channels=3), (2, 3, 4, 4)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=2, groups=2,
                             activation="relu"), (2, 2, 3, 3)),
    ("MaxPool3D", dict(pool_size=2), (2, 3, 4, 4, 4)),
    ("AvgPool3D", dict(pool_size=(2, 2, 1), strides=1, padding=1),
     (1, 2, 3, 4, 4)),
    ("GroupNorm", dict(num_groups=2), (2, 4, 3, 3)),
    ("InstanceNorm", dict(), (2, 3, 5)),
    ("ELU", dict(alpha=0.7), (3, 4)),
    ("SELU", dict(), (3, 4)),
    ("GELU", dict(), (3, 4)),
    ("Swish", dict(beta=1.5), (3, 4)),
    ("LayerNorm", dict(axis=1), (3, 4)),
    ("LayerNorm", dict(center=False, scale=False), (2, 3, 4)),
]


def _make(gluon, name, kw):
    return getattr(gluon.nn, name)(**kw)


@pytest.mark.parametrize("name,kw,shape", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LAYERS)])
def test_new_layer_like_jax(name, kw, shape):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jl = _make(gluon_j, name, kw)
    jl.initialize(mx.init.Uniform(0.5))
    with mxt.cpu():
        tl = _make(gluon_t, name, kw)
        tl.initialize()
    xj, xt = nd_j.array(x), nd_t.array(x, ctx=CPU)
    jl(xj)                                  # deferred shapes
    tl(xt)
    _carry(jl, tl)
    for a in (xj, xt):
        a.attach_grad()
    with ag_j.record():
        yj = jl(xj)
    yj.backward()
    with ag_t.record():
        yt = tl(xt)
    yt.backward()
    np.testing.assert_allclose(yt.asnumpy(), yj.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.asnumpy(), xj.grad.asnumpy(),
                               rtol=1e-5, atol=1e-5)


def test_prelu_against_its_formula():
    """The JAX package's PReLU raises in an eager call (its LeakyReLU op
    gets alpha as an NDArray keyword it does not unwrap), so the port's
    is held to the formula: x where x >= 0, else alpha * x."""
    x = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    with mxt.cpu():
        pl = gluon_t.nn.PReLU(alpha_initializer=mxt.init.Constant(0.25))
        pl.initialize()
        xt = nd_t.array(x)
        xt.attach_grad()
        with ag_t.record():
            y = pl(xt)
        y.backward()
    np.testing.assert_allclose(y.asnumpy(), np.where(x >= 0, x, 0.25 * x),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.asnumpy(), np.where(x >= 0, 1.0, 0.25),
                               rtol=1e-6)
    jl = gluon_j.nn.PReLU()
    jl.initialize()
    with pytest.raises(TypeError):
        jl(nd_j.array(x))


def test_dropout_axes_shares_the_draw():
    with mxt.cpu():
        do = gluon_t.nn.Dropout(0.5, axes=(1,))
        with ag_t.record():
            y = do(nd_t.ones((64, 8))).asnumpy()
    assert ((y == 0) | (y == 2)).all()
    assert (y == y[:, :1]).all() and 0 < (y[:, 0] == 0).mean() < 1


# -- the new losses ------------------------------------------------------------

LOSSES = [
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBCELoss", dict(from_sigmoid=True), "prob"),
    ("KLDivLoss", dict(from_logits=False), "dist"),
    ("HuberLoss", dict(rho=0.5), "real"),
    ("HingeLoss", dict(margin=1.5), "signed"),
    ("SquaredHingeLoss", {}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", dict(label_format="binary"), "binary"),
]


def _labels(kind, shape, rng):
    if kind == "binary":
        return (rng.rand(*shape) > 0.5).astype(np.float32)
    if kind == "signed":
        return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)
    if kind == "dist":
        e = np.exp(rng.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _loss_pair(name, kw, ins):
    out = {}
    for pkg, gluon, nd, ag, arr in (
            ("jax", gluon_j, nd_j, ag_j, nd_j.array),
            ("port", gluon_t, nd_t, ag_t, lambda v: nd_t.array(v, ctx=CPU))):
        loss = getattr(gluon.loss, name)(weight=0.7, **kw)
        xs = [arr(a) for a in ins]
        xs[0].attach_grad()
        sw = arr(np.linspace(0.5, 1.5, ins[0].shape[0], dtype=np.float32)
                 .reshape(-1, *([1] * (len(ins[0].shape) - 1))))
        with ag.record():
            y = loss(*xs, sample_weight=sw) if len(xs) == 2 else loss(*xs)
        y.backward()
        out[pkg] = (y.asnumpy(), xs[0].grad.asnumpy())
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,kw,kind", LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(LOSSES)])
def test_new_loss_like_jax(name, kw, kind):
    rng = np.random.RandomState(4)
    pred = rng.randn(4, 5).astype(np.float32)
    if kind == "prob":
        pred = 1 / (1 + np.exp(-pred))
    _loss_pair(name, kw, [pred, _labels(kind, (4, 5), rng)])


def test_triplet_and_cosine_embedding_losses():
    rng = np.random.RandomState(5)
    a, p, n = (rng.randn(4, 6).astype(np.float32) for _ in range(3))
    _loss_pair("TripletLoss", dict(margin=0.5), [a, p, n])
    lab = np.array([1, -1, 1, -1], np.float32)
    _loss_pair("CosineEmbeddingLoss", dict(margin=0.1), [a, p, lab])
