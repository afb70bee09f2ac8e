"""PyTorch port, the ResNet slice: `models.resnet`, the gluon layers it
builds (convolutions, BatchNorm, pooling, Activation, Flatten, deferred
Dense), `gluon.loss`, deferred shapes, `weights.load_named_arrays` into a
deferred model and `Block.cast`, against the JAX package on the CPU.

The same weights (the JAX model's, after the forward that resolves its
deferred shapes, carried by name) and the same seeded numpy batch go
through `mxnet_tpu.models.resnet` and `mxnet_tpu_torch.models.resnet`,
float32. Tolerances: logits, losses and running statistics atol 1e-5 +
rtol 1e-5 (float32; convolutions and batch statistics reduce in other
orders); the op-level checks (convolution, pooling, BatchNorm, losses)
atol 1e-5 + rtol 1e-5, max pooling exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon import loss as loss_j
from mxnet_tpu.gluon import nn as nn_j
from mxnet_tpu.models import resnet as resnet_j
from mxnet_tpu.ops import nn_ops as ops_j

from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.gluon import loss as loss_t
from mxnet_tpu_torch.gluon import nn as nn_t
from mxnet_tpu_torch.models import resnet as resnet_t
from mxnet_tpu_torch.ops import nn_ops as ops_t

_TOL = dict(atol=1e-5, rtol=1e-5)
_NETS = {
    "v1_bottleneck": ("ResNetV1", "BottleneckV1", [1, 1], [8, 16, 32]),
    "v2_basic": ("ResNetV2", "BasicBlockV2", [1, 1], [8, 8, 16]),
}


def _x(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, 3, 32, 32).astype(np.float32)


def _labels(n=2, seed=1):
    return np.random.RandomState(seed).randint(0, 10, n).astype(np.float32)


def _build(mod, name, **kw):
    net_cls, block, layers, channels = _NETS[name]
    return getattr(mod, net_cls)(getattr(mod, block), layers, channels,
                                 classes=10, **kw)


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x)


@pytest.fixture(scope="module", params=sorted(_NETS))
def pair(request):
    """(name, JAX net, its arrays after the resolving forward, a port net
    loaded from them while still deferred)."""
    jm = _build(resnet_j, request.param)
    mx.random.seed(0)
    jm.initialize()
    jm(nd.array(_x()))
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    tm = _build(resnet_t, request.param, device="cpu")
    assert any(0 in p.shape for p in tm.parameters())
    weights.load_named_arrays(tm, arrays)
    return request.param, jm, arrays, tm


def _reload(jm, tm, arrays):
    """Both nets back to `arrays` (a train forward moved the statistics)."""
    for k, p in jm.collect_params().items():
        p.set_data(nd.array(arrays[k]))
    weights.load_named_arrays(tm, arrays)


def test_parameter_paths_are_the_jax_paths(pair):
    name, jm, arrays, tm = pair
    params = tm.collect_params()
    assert set(params) == set(arrays)
    for k, p in params.items():
        assert tuple(p.shape) == arrays[k].shape, k
        assert p.grad_req == jm.collect_params()[k].grad_req, k
    if name == "v1_bottleneck":
        for k in ("features.4.0.body.1.gamma", "features.4.0.ds.0.weight",
                  "features.1.running_var", "output.weight"):
            assert k in params


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_logits_and_loss_match(pair, mode):
    _, jm, arrays, tm = pair
    _reload(jm, tm, arrays)
    x, y = _x(), _labels()
    lj = loss_j.SoftmaxCrossEntropyLoss()
    lt = loss_t.SoftmaxCrossEntropyLoss()
    if mode == "train":
        with autograd.record():
            out_j = jm(nd.array(x))
            l_j = lj(out_j, nd.array(y))
        tm.train()
    else:
        out_j = jm(nd.array(x))
        l_j = lj(out_j, nd.array(y))
    try:
        with torch.no_grad():
            out_t = tm(torch.from_numpy(x))
            l_t = lt(out_t, torch.from_numpy(y))
    finally:
        tm.eval()
    assert out_t.shape == (2, 10) and l_t.shape == (2,)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), **_TOL)
    np.testing.assert_allclose(l_t.numpy(), _np(l_j), **_TOL)
    # the train forward moved every running statistic as the JAX one did
    jp = jm.collect_params()
    for k, p in tm.collect_params().items():
        if "running" in k:
            np.testing.assert_allclose(p.detach().numpy(),
                                       _np(jp[k].data()), err_msg=k, **_TOL)
            moved = not np.array_equal(p.detach().numpy(), arrays[k])
            assert moved == (mode == "train"), k


def test_batch_norm_running_variance_is_biased_at_batch_two():
    """At batch 2 the biased variance is half the unbiased one: MXNet's
    running update new = 0.9 old + 0.1 batch (torch's momentum 0.1 would
    give the same weights, but its unbiased variance would not)."""
    x = np.array([[1.0, -2.0, 0.5], [3.0, 2.0, 0.25]], np.float32)
    bj = nn_j.BatchNorm(in_channels=3)
    bj.initialize()
    with autograd.record():
        out_j = bj(nd.array(x))
    bt = nn_t.BatchNorm(in_channels=3)
    bt.initialize()
    bt.train()
    out_t = bt(torch.from_numpy(x))
    var_b = x.var(0)
    np.testing.assert_allclose(bt.running_var.detach().numpy(),
                               0.9 + 0.1 * var_b, **_TOL)
    np.testing.assert_allclose(bt.running_mean.detach().numpy(),
                               0.1 * x.mean(0), **_TOL)
    np.testing.assert_allclose(bt.running_var.detach().numpy(),
                               _np(bj.running_var.data()), **_TOL)
    np.testing.assert_allclose(out_t.detach().numpy(), _np(out_j), **_TOL)
    assert not np.allclose(0.9 + 0.1 * x.var(0, ddof=1), 0.9 + 0.1 * var_b)


@pytest.mark.parametrize("case", [
    dict(fix_gamma=True), dict(use_global_stats=True), dict(axis=-1),
    dict(training=False)])
def test_batch_norm_op_matches(case):
    rng = np.random.RandomState(2)
    axis = case.get("axis", 1)
    x = rng.randn(4, 5, 3, 6).astype(np.float32)
    C = x.shape[axis]
    gamma, beta = rng.rand(C).astype(np.float32) + 0.5, rng.randn(C) \
        .astype(np.float32)
    mean, var = rng.randn(C).astype(np.float32), \
        rng.rand(C).astype(np.float32) + 0.5
    kw = {k: v for k, v in case.items() if k != "training"}
    training = case.get("training", True)
    ref = ops_j.batch_norm(*map(jnp.asarray, (x, gamma, beta, mean, var)),
                           momentum=0.8, _training=training, **kw)
    got = ops_t.batch_norm(*map(torch.from_numpy, (x, gamma, beta, mean,
                                                    var)),
                           momentum=0.8, training=training, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **_TOL)


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="max", stride=(2, 2), pad=(0, 0),
         pooling_convention="full"),
    dict(kernel=(2, 3), pool_type="max", stride=(1, 2), pad=(1, 2)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(kernel=(3, 3), pool_type="avg", stride=(2, 2), pad=(1, 1),
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(2,), pool_type="avg", stride=(2,), pad=(0,)),
    dict(pool_type="avg", global_pool=True),
    dict(pool_type="max", global_pool=True),
])
def test_pooling_op_matches(case):
    one_d = case.get("kernel") == (2,)
    shape = (2, 3, 9) if one_d else (2, 3, 9, 8)
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    ref = np.asarray(ops_j.pooling(jnp.asarray(x), **case))
    got = ops_t.pooling(torch.from_numpy(x), **case).numpy()
    assert got.shape == ref.shape
    if case["pool_type"] == "max":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, **_TOL)


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(kernel=(3, 3), stride=(1, 1), pad=(2, 2), dilate=(2, 2),
         num_group=2),
    dict(kernel=(3,), stride=(2,), pad=(1,)),
    dict(kernel=(1, 3, 3), stride=(1, 2, 2), pad=(0, 1, 1)),
])
def test_convolution_op_matches(case):
    n = len(case["kernel"])
    groups = case.get("num_group", 1)
    rng = np.random.RandomState(4)
    x = rng.randn(*((2, 4) + (7,) * n)).astype(np.float32)
    w = rng.randn(*((6, 4 // groups) + case["kernel"])).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    ref = np.asarray(ops_j.convolution(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), **case))
    got = ops_t.convolution(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), **case).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name, kw, args", [
    ("SoftmaxCrossEntropyLoss", {}, "sparse"),
    ("SoftmaxCrossEntropyLoss", dict(sparse_label=False), "dense"),
    ("SoftmaxCrossEntropyLoss", dict(from_logits=True, weight=0.5),
     "sparse_weighted"),
    ("L2Loss", {}, "regression"),
    ("L1Loss", dict(weight=2.0), "regression_weighted"),
])
def test_losses_match(name, kw, args):
    rng = np.random.RandomState(5)
    pred = rng.randn(4, 6).astype(np.float32)
    inputs = {
        "sparse": [rng.randint(0, 6, 4).astype(np.float32)],
        "dense": [np.abs(rng.rand(4, 6)).astype(np.float32)],
        "sparse_weighted": [rng.randint(0, 6, 4).astype(np.float32),
                            rng.rand(4).astype(np.float32)],
        "regression": [rng.randn(4, 6).astype(np.float32)],
        "regression_weighted": [rng.randn(4, 6).astype(np.float32),
                                rng.rand(4, 1).astype(np.float32)],
    }[args]
    ref = getattr(loss_j, name)(**kw)(*[nd.array(a) for a in [pred] + inputs])
    got = getattr(loss_t, name)(**kw)(*[torch.from_numpy(a)
                                        for a in [pred] + inputs])
    np.testing.assert_allclose(got.numpy(), _np(ref), **_TOL)
    assert loss_t.SoftmaxCELoss is loss_t.SoftmaxCrossEntropyLoss


def test_deferred_shapes_resolve_at_the_first_forward():
    tm = _build(resnet_t, "v1_bottleneck", device="cpu")
    conv = tm.features[0]
    assert tuple(conv.weight.shape) == (8, 0, 7, 7)
    assert tuple(tm.features[1].gamma.shape) == (0,)
    tm.initialize(generator=mxrandom.seed(3, "cpu"))
    # initialize drew nothing for a deferred parameter, and marked it so
    assert conv.weight.mx_init_requested is not None
    assert not conv.weight.mx_initialized
    assert tm.output.weight.mx_initialized              # in_units given
    with torch.no_grad():
        tm(torch.from_numpy(_x()))
    jm = _build(resnet_j, "v1_bottleneck")
    mx.random.seed(0)
    jm.initialize()
    jm(nd.array(_x()))
    shapes = {k: tuple(p.shape) for k, p in jm.collect_params().items()}
    assert {k: tuple(p.shape) for k, p in tm.collect_params().items()} \
        == shapes
    for k, p in tm.collect_params().items():
        assert p.mx_initialized and not p.mx_deferred, k
        if k.endswith(("gamma", "running_var")):
            assert torch.equal(p, torch.ones_like(p)), k
        elif k.endswith(("beta", "running_mean", "bias")):
            assert torch.equal(p, torch.zeros_like(p)), k
        else:
            assert float(p.abs().max()) > 0, k
    # the same seed gives the same weights
    again = _build(resnet_t, "v1_bottleneck", device="cpu")
    again.initialize(generator=mxrandom.seed(3, "cpu"))
    with torch.no_grad():
        again(torch.from_numpy(_x()))
    for k, p in again.collect_params().items():
        assert torch.equal(p, tm.collect_params()[k]), k


def test_deferred_dense_and_an_uninitialized_forward():
    d = nn_t.Dense(5)
    assert tuple(d.weight.shape) == (5, 0)
    with pytest.raises(RuntimeError, match="not initialized"):
        d(torch.zeros(2, 3, 4))
    # the failed forward left the parameter deferred: a retry raises again
    assert tuple(d.weight.shape) == (5, 0) and d.weight.mx_deferred
    assert not d.weight.mx_initialized
    with pytest.raises(RuntimeError, match="not initialized"):
        d(torch.zeros(2, 3, 4))
    d = nn_t.Dense(5, flatten=False)
    d.initialize(generator=mxrandom.seed(0, "cpu"))
    assert d(torch.zeros(2, 3, 4)).shape == (2, 3, 5)
    assert tuple(d.weight.shape) == (5, 4)


def test_load_named_arrays_into_a_deferred_model(pair):
    name, _, arrays, _ = pair
    tm = _build(resnet_t, name, device="cpu")
    weights.load_named_arrays(tm, arrays)
    for k, p in tm.collect_params().items():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[k])
        assert p.mx_initialized and not p.mx_deferred
    bad = dict(arrays)
    k = "features.0.weight" if name == "v1_bottleneck" else \
        "features.1.weight"
    bad[k] = np.zeros((arrays[k].shape[0] + 1,) + arrays[k].shape[1:],
                      np.float32)
    with pytest.raises(ValueError, match=k):
        weights.load_named_arrays(_build(resnet_t, name, device="cpu"), bad)
    missing = {n: a for n, a in arrays.items() if n != k}
    with pytest.raises(KeyError, match="missing"):
        weights.load_named_arrays(_build(resnet_t, name, device="cpu"),
                                  missing)


def test_cast_bfloat16_casts_running_statistics():
    """As the JAX package's `Block.cast`: every parameter, running
    statistics included; a deferred one materialises in the new dtype."""
    jm = _build(resnet_j, "v1_bottleneck")
    jm.initialize()
    jm.cast("bfloat16")
    jm(nd.array(_x()))
    tm = _build(resnet_t, "v1_bottleneck", device="cpu")
    tm.initialize(generator=mxrandom.seed(0, "cpu"))
    tm.cast("bfloat16")
    with torch.no_grad():
        tm(torch.from_numpy(_x()))
    for k, p in jm.collect_params().items():
        assert str(p.data()._data.dtype) == "bfloat16", k
        assert tm.collect_params()[k].dtype == torch.bfloat16, k
    assert tm.features[1].running_var.dtype == torch.bfloat16
