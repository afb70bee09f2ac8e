"""PyTorch port, YOLOv3-tiny (`models/yolo.py`) against the JAX
package's on the CPU at 64^2 with 3 classes: the same seeded numpy
weights set into `mxnet_tpu.models.yolo.YOLOv3Tiny` and carried from it
by name (`weights.load_named_arrays`), the same seeded images and boxes.

Tolerances (float32): heads 1e-4 (a stack of ten convolutions summed in
other orders); `yolo_targets` equal, also where two gts collide on one
(cell, anchor), but the log-scales within 1e-6 (XLA:CPU's log and
torch's differ by an ulp); `yolo_loss` 1e-5 and its parameter gradients
1e-4; three eager Adam steps (`autograd.record()`, `loss.backward()`,
`gluon.Trainer(..., "adam").step(1)`) against the JAX package's Adam on
its own gradients, at epsilon 1e-6: losses 1e-5, parameters and
BatchNorm running statistics 1e-4 (some weights' gradients are float32
noise, |g| near 1e-9 from sums that cancel, which Adam at epsilon 1e-8
turns into steps of about a tenth of lr that differ between the
packages: the second loss then parts by 1.1e-5); `decode_predictions`:
class ids and the suppressed rows equal, scores and boxes within 1e-6
relative (XLA:CPU's sigmoid and exp differ from torch's by float32
ulps). The JAX side runs under `jax.jit` through `functional_call`, as
the JAX package's trainer runs it."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mxj
from mxnet_tpu import nd as ndj
from mxnet_tpu import optimizer as optj
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.models import yolo as yj
from mxnet_tpu.ndarray import NDArray as NDj
from mxnet_tpu.parallel.trainer import call_loss

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import gluon as gt
from mxnet_tpu_torch import metric, nd, weights
from mxnet_tpu_torch.gluon import nn as nnt
from mxnet_tpu_torch.models import yolo as yt

IMG, C, G = 64, 3, 4
CPU = mxt.cpu()


def _numpy_weights(rng):
    """Seeded weights for every parameter path, shapes from a port model
    whose deferred shapes one forward completed."""
    probe = yt.YOLOv3Tiny(C, IMG, device="cpu")
    probe.initialize()
    probe(torch.zeros(1, 3, IMG, IMG))
    out = {}
    for k, p in probe.collect_params().items():
        shape = tuple(p.shape)
        if k.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            a = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif k.endswith(("gamma", "running_var")):
            a = 1.0 + 0.2 * rng.rand(*shape)
        else:                                   # beta, bias, running_mean
            a = 0.1 * rng.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def arrays():
    """The JAX model holding the seeded weights (set_data), and its
    parameters as numpy: what the port model loads by name."""
    jm = yj.YOLOv3Tiny(num_classes=C, image_size=IMG)
    seeded = _numpy_weights(np.random.RandomState(0))
    for k, p in jm.collect_params().items():
        p.set_data(ndj.array(seeded[k]))
    return jm, {k: np.asarray(p.data()._data)
                for k, p in jm.collect_params().items()}


def _port(arrs):
    return weights.load_named_arrays(yt.YOLOv3Tiny(C, IMG, device="cpu"),
                                     arrs)


def _synthetic(rng, batch, collide=False):
    """The example's bright squares, 1-3 boxes an image; with `collide`
    image 0 holds two same-size boxes centred in one cell."""
    imgs = (0.1 * rng.rand(batch, 3, IMG, IMG)).astype(np.float32)
    boxes = np.zeros((batch, G, 4), np.float32)
    labels = np.full((batch, G), -1.0, np.float32)
    for b in range(batch):
        for g in range(rng.randint(1, G)):
            size = rng.randint(6, 30)
            x, y = rng.randint(0, IMG - size, 2)
            cls = rng.randint(0, C)
            imgs[b, cls, y:y + size, x:x + size] = 1.0
            boxes[b, g] = (x, y, x + size, y + size)
            labels[b, g] = cls
    if collide:
        boxes[0, :2] = [(20, 20, 30, 32), (21, 21, 31, 33)]
        labels[0] = [0, 2] + [-1] * (G - 2)
    return imgs, boxes, labels


def _jax_targets(jm, boxes, labels):
    def f(b, l):
        return [{k: v._data for k, v in t.items()}
                for t in yj.yolo_targets(jm, NDj(b), NDj(l))]
    return [{k: np.asarray(v) for k, v in t.items()}
            for t in jax.jit(f)(jnp.asarray(boxes), jnp.asarray(labels))]


@pytest.fixture(scope="module")
def jax_step(arrays):
    """The JAX package's pure train step under one jit: (params, aux,
    images, targets) -> ((loss, new aux), gradients), and the parameter
    and aux lists it takes."""
    jm, _ = arrays
    fn, gps, aux = functional_call(jm, train=True)
    key = mxj.random.next_key()

    def loss_of(ps, av, x, targets):
        outs, new_aux = fn(ps, av, key, x)
        tj = [{k: NDj(v) for k, v in t.items()} for t in targets]
        loss = call_loss(lambda a, b: yj.yolo_loss([a, b], tj, C), key,
                         outs, [])
        return loss, new_aux
    return jax.jit(jax.value_and_grad(loss_of, has_aux=True)), gps, aux


def test_parameter_paths_are_the_jax_paths(arrays):
    jm, arrs = arrays
    tm = _port(arrs)
    assert set(tm.collect_params()) == set(jm.collect_params()) == set(arrs)
    stats = [k for k in arrs if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 10                  # 10 BatchNorms
    assert sum(p.grad_req != "null" for p in tm.collect_params().values()) \
        == len(arrs) - len(stats) == 34


def test_heads_match(arrays):
    jm, arrs = arrays
    imgs, _, _ = _synthetic(np.random.RandomState(1), 2)
    fn, gps, aux = functional_call(jm, train=False)
    want, _ = jax.jit(fn)([p.data()._data for _, p in gps],
                          [p.data()._data for _, p in aux],
                          mxj.random.next_key(), jnp.asarray(imgs))
    got = _port(arrs)(nd.array(imgs, ctx=CPU))
    assert [g.shape for g in got] == [(2, 2, 2, 3, 8), (2, 4, 4, 3, 8)]
    for g, w in zip(got, want):
        assert isinstance(g, nd.NDArray)
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("collide", [False, True])
def test_targets_equal(arrays, collide):
    jm, arrs = arrays
    _, boxes, labels = _synthetic(np.random.RandomState(2), 4, collide)
    want = _jax_targets(jm, boxes, labels)
    got = yt.yolo_targets(_port(arrs), nd.array(boxes, ctx=CPU),
                          nd.array(labels, ctx=CPU))
    for g, w in zip(got, want):
        for k in ("obj", "xy", "wh", "cls"):
            assert isinstance(g[k], nd.NDArray)
            assert g[k].dtype == w[k].dtype, k
            if k == "wh":                   # log: XLA's and torch's differ
                np.testing.assert_allclose(g[k].asnumpy(), w[k], rtol=1e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g[k].asnumpy(), w[k],
                                              err_msg=k)
    if collide:
        # image 0's two boxes claim one cell and anchor; the later gt
        # (class 2) wins, as XLA:CPU applies the scatter's updates in order
        obj = [g["obj"].asnumpy()[0] for g in got]
        cls = [g["cls"].asnumpy()[0] for g in got]
        assert sum(o.sum() for o in obj) == 1
        assert [c[o > 0].tolist() for c, o in zip(cls, obj)] in (
            [[2], []], [[], [2]])


def test_loss_and_gradients_match(arrays, jax_step):
    jm, arrs = arrays
    vg, gps, aux = jax_step
    imgs, boxes, labels = _synthetic(np.random.RandomState(3), 2)
    (lj, _), gj = vg([p.data()._data for _, p in gps],
                     [p.data()._data for _, p in aux], jnp.asarray(imgs),
                     _jax_targets(jm, boxes, labels))
    tm = _port(arrs)
    tt = yt.yolo_targets(tm, nd.array(boxes, ctx=CPU),
                         nd.array(labels, ctx=CPU))
    with agt.record():
        loss = yt.yolo_loss(tm(nd.array(imgs, ctx=CPU)), tt, C)
    loss.backward()
    assert isinstance(loss, nd.NDArray) and loss.shape == ()
    np.testing.assert_allclose(loss.asscalar(), float(lj), rtol=1e-5)
    params = tm.collect_params()
    for (k, _), g in zip(gps, gj):
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_eager_adam_steps_match_jax(arrays, jax_step):
    jm, arrs = arrays
    vg, gps, aux = jax_step
    imgs, boxes, labels = _synthetic(np.random.RandomState(4), 2)
    # the JAX side: its Adam on its own gradients, the running
    # statistics of each train step written back
    targets = _jax_targets(jm, boxes, labels)
    opt = optj.create("adam", learning_rate=1e-3, epsilon=1e-6)
    opt.rescale_grad = 1.0
    states = [opt.create_state(i, p.data()) for i, (_, p) in enumerate(gps)]
    ps = [jnp.asarray(p.data()._data) for _, p in gps]
    av = [p.data()._data for _, p in aux]
    lj = []
    for _ in range(3):
        (loss, av), grads = vg(ps, av, jnp.asarray(imgs), targets)
        wts = [ndj.array(p) for p in ps]
        for i, (w, g) in enumerate(zip(wts, grads)):
            opt.update(i, w, ndj.array(g), states[i])
        ps = [w._data for w in wts]
        lj.append(float(loss))
    # the port: the example's loop
    tm = _port(arrs)
    trainer = gt.Trainer(tm.collect_params(), "adam",
                         {"learning_rate": 1e-3, "epsilon": 1e-6})
    lt = []
    for _ in range(3):
        tt = yt.yolo_targets(tm, nd.array(boxes, ctx=CPU),
                             nd.array(labels, ctx=CPU))
        with agt.record():
            loss = yt.yolo_loss(tm(nd.array(imgs, ctx=CPU)), tt, C)
        loss.backward()
        trainer.step(1)
        lt.append(float(loss.asscalar()))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert len(trainer._params) == 34
    want = dict(zip([k for k, _ in gps], ps))
    want.update(zip([k for k, _ in aux], av))      # running statistics
    params = tm.collect_params()
    assert set(want) == set(params)
    for k, w in want.items():
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_decode_matches(arrays):
    jm, arrs = arrays
    rng = np.random.RandomState(5)
    heads = [(rng.randn(2, s, s, 3, 5 + C) * 1.5).astype(np.float32)
             for s in (2, 4)]

    def f(a, b, **kw):
        return yj.decode_predictions(jm, [NDj(a), NDj(b)], **kw)._data
    tm = _port(arrs)
    for kw in ({}, {"conf_thresh": 0.0, "topk": 5}):
        want = np.asarray(jax.jit(functools.partial(f, **kw))(*heads))
        got = yt.decode_predictions(tm, [nd.array(h, ctx=CPU)
                                         for h in heads], **kw)
        assert isinstance(got, nd.NDArray) and got.shape == (2, 60, 6)
        got = got.asnumpy()
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_array_equal(got[..., 1] < 0, want[..., 1] < 0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert (got[..., 1] > 0).sum(1).max() <= kw.get("topk", 100)


def test_leaky_relu_and_nd_ops_match_jax():
    """LeakyReLU rounds its slope to the data's dtype and has gradient 1
    at 0 (jax.nn.leaky_relu's `where`); nd.concat and NDArray.repeat as
    jnp's."""
    x = np.array([-2.0, -0.5, 0.0, 0.7, 3.0], np.float32)
    layer = nnt.LeakyReLU(0.1)
    for dt in ("float32", "bfloat16"):
        xt = torch.tensor(x).to(getattr(torch, dt)).requires_grad_(True)
        y = layer(xt)
        y.sum().backward()
        xj = jnp.asarray(x).astype(dt)
        yj_, gj = jax.value_and_grad(
            lambda a: jax.nn.leaky_relu(a, 0.1).astype(jnp.float32).sum())(
                xj)
        np.testing.assert_array_equal(
            y.float().detach().numpy(),
            np.asarray(jax.nn.leaky_relu(xj, 0.1).astype(jnp.float32)))
        np.testing.assert_array_equal(xt.grad.float().numpy(),
                                      np.asarray(gj.astype(jnp.float32)))
    a = np.arange(12, dtype=np.float32).reshape(2, 3, 2)
    b = np.ones((2, 1, 2), np.float32)
    np.testing.assert_array_equal(
        nd.concat(nd.array(a, ctx=CPU), nd.array(b, ctx=CPU)).asnumpy(),
        ndj.concat(ndj.array(a), ndj.array(b), dim=1).asnumpy())
    for axis in (None, 0, 2):
        np.testing.assert_array_equal(
            nd.array(a, ctx=CPU).repeat(2, axis=axis).asnumpy(),
            np.asarray(jnp.repeat(jnp.asarray(a), 2, axis=axis)))


def test_example_loop_trains_and_scores():
    """examples/detection/train_yolo.py on the port at 64^2: the loss
    falls over a few eager Adam steps on one batch, decode gives static
    (B, N, 6) rows and VOC07 mAP lies in [0, 1]."""
    mxt.random.seed(0, "cpu")
    model = yt.YOLOv3Tiny(num_classes=C, image_size=IMG, device="cpu")
    model.initialize()
    trainer = gt.Trainer(model.collect_params(), "adam",
                         {"learning_rate": 1e-3})
    rng = np.random.RandomState(0)
    imgs, boxes, labels = _synthetic(rng, 8)
    losses = []
    for _ in range(6):
        targets = yt.yolo_targets(model, nd.array(boxes, ctx=CPU),
                                  nd.array(labels, ctx=CPU))
        with agt.record():
            preds = model(nd.array(imgs, ctx=CPU))
            loss = yt.yolo_loss(preds, targets, C)
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    imgs, boxes, labels = _synthetic(rng, 8)
    det = yt.decode_predictions(model, model(nd.array(imgs, ctx=CPU)))
    assert det.shape == (8, 3 * (2 * 2 + 4 * 4), 6)
    m = metric.VOC07MApMetric(iou_thresh=0.5)
    m.update(np.concatenate([labels[:, :, None], boxes], 2), det)
    assert 0.0 <= m.get()[1] <= 1.0
