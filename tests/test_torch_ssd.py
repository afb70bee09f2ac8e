"""PyTorch port, SSD (`models/ssd.py`) against the JAX package's on the
CPU: a small SSD (channels (8, 16), 3 classes, 64^2 images) with the same
seeded numpy weights set into `mxnet_tpu.models.ssd.SSD` and carried
from it by name, the same seeded images and boxes.

Tolerances (float32): `generate_anchors` equal (the same numpy);
forward 1e-4 (convolutions summed in other orders); `multibox_target`:
classes and masks equal, offsets within 1e-6 (XLA:CPU's log differs
from torch's by an ulp), also where a padding row's claim collides with
a real gt's on anchor 0; `MultiBoxLoss` 1e-5 and the gradients of the
whole step in every parameter 1e-4; `non_max_suppression` indices equal
and scores equal. The JAX side runs under `jax.jit`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mxj
from mxnet_tpu import nd as ndj
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.models import ssd as sj
from mxnet_tpu.ndarray import NDArray as NDj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import nd, weights
from mxnet_tpu_torch.models import ssd as st

IMG, C, CH = 64, 3, (8, 16)
SIZES = ((0.2, 0.3), (0.4, 0.5))
CPU = mxt.cpu()


def _seeded_weights(rng):
    probe = st.SSD(num_classes=C, channels=CH, device="cpu")
    probe.initialize()
    probe(torch.zeros(1, 3, IMG, IMG))
    out = {}
    for k, p in probe.collect_params().items():
        shape = tuple(p.shape)
        if k.endswith("weight"):
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith(("gamma", "running_var")):
            a = 1.0 + 0.2 * rng.rand(*shape)
        else:
            a = 0.1 * rng.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def arrays():
    jm = sj.SSD(num_classes=C, channels=CH)
    seeded = _seeded_weights(np.random.RandomState(0))
    for k, p in jm.collect_params().items():
        p.set_data(ndj.array(seeded[k]))
    return jm, {k: np.asarray(p.data()._data)
                for k, p in jm.collect_params().items()}


def _port(arrs):
    return weights.load_named_arrays(
        st.SSD(num_classes=C, channels=CH, device="cpu"), arrs)


def _gts(rng, B=3, M=4, collide=False):
    boxes = np.full((B, M, 4), -1.0, np.float32)
    labels = np.full((B, M), -1, np.int32)
    for b in range(B):
        for m in range(rng.randint(1, M)):
            xy = rng.rand(2) * 0.6
            wh = rng.rand(2) * 0.35 + 0.05
            boxes[b, m] = [*xy, *(xy + wh)]
            labels[b, m] = rng.randint(0, C)
    if collide:      # image 0: one small gt on anchor 0, padding after it
        boxes[0] = -1.0
        labels[0] = -1
        boxes[0, 0] = [0.0, 0.0, 0.2, 0.2]
        labels[0, 0] = 1
    return boxes, labels


def _jax_forward(jm, imgs, train):
    fn, gps, aux = functional_call(jm, train=train)
    outs, _ = jax.jit(fn)([p.data()._data for _, p in gps],
                          [p.data()._data for _, p in aux],
                          mxj.random.next_key(), jnp.asarray(imgs))
    return outs


def test_parameter_paths_anchors_and_forward(arrays):
    jm, arrs = arrays
    tm = _port(arrs)
    assert set(tm.collect_params()) == set(jm.collect_params()) == set(arrs)
    imgs = np.random.RandomState(1).rand(2, 3, IMG, IMG).astype(np.float32)
    cls_p, box_p, feat = tm(nd.array(imgs, ctx=CPU))
    assert feat == [(16, 16), (8, 8)]
    want = _jax_forward(jm, imgs, train=False)
    for g, w in zip((cls_p, box_p), want[:2]):
        assert isinstance(g, nd.NDArray)
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(
        st.generate_anchors(feat, sizes=SIZES),
        sj.generate_anchors(feat, sizes=SIZES))
    assert st.generate_anchors([(75, 75), (38, 38), (19, 19), (10, 10)]) \
        .shape == (30120, 4)                     # SSD(20)'s default at 300^2


@pytest.mark.parametrize("collide", [False, True])
def test_multibox_target(collide):
    anchors = sj.generate_anchors([(16, 16), (8, 8)], sizes=SIZES)
    boxes, labels = _gts(np.random.RandomState(2), collide=collide)
    want = jax.jit(sj.multibox_target)(jnp.asarray(anchors),
                                       jnp.asarray(boxes),
                                       jnp.asarray(labels))
    got = st.multibox_target(nd.array(anchors, ctx=CPU),
                             nd.array(boxes, ctx=CPU),
                             nd.array(labels, ctx=CPU))
    assert all(isinstance(g, nd.NDArray) for g in got)
    lbl, box_t, mask = (g.asnumpy() for g in got)
    np.testing.assert_array_equal(lbl, np.asarray(want[0]))
    np.testing.assert_array_equal(mask, np.asarray(want[2]))
    np.testing.assert_allclose(box_t, np.asarray(want[1]), rtol=1e-6,
                               atol=1e-6)
    assert (lbl > 0).any()
    if collide:
        # the padding rows' claim (False) on anchor 0 comes after the
        # real gt's and wins, as XLA:CPU applies the scatter in order;
        # the gt still matches the anchors above the threshold
        assert lbl[0, 0] == 0 and (lbl[0] == 2).any()


def test_loss_and_gradients_match(arrays):
    jm, arrs = arrays
    rng = np.random.RandomState(3)
    imgs = rng.rand(3, 3, IMG, IMG).astype(np.float32)
    anchors = sj.generate_anchors([(16, 16), (8, 8)], sizes=SIZES)
    boxes, labels = _gts(rng)
    cls_t, box_t, mask = (np.asarray(a) for a in jax.jit(sj.multibox_target)(
        jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels)))
    fn, gps, aux = functional_call(jm, train=True)
    key = mxj.random.next_key()

    def loss_of(ps):
        outs, _ = fn(ps, [p.data()._data for _, p in aux], key,
                     jnp.asarray(imgs))
        return sj.MultiBoxLoss()(*[NDj(a) for a in (outs[0], outs[1], cls_t,
                                                    box_t, mask)])._data
    lj, gj = jax.jit(jax.value_and_grad(loss_of))(
        [p.data()._data for _, p in gps])
    tm = _port(arrs)
    with agt.record():
        cp, bp, _ = tm(nd.array(imgs, ctx=CPU))
        loss = st.MultiBoxLoss()(cp, bp, *[nd.array(a, ctx=CPU)
                                           for a in (cls_t, box_t, mask)])
    loss.backward()
    assert isinstance(loss, nd.NDArray)
    np.testing.assert_allclose(loss.asscalar(), float(lj), rtol=1e-5)
    params = tm.collect_params()
    for (k, _), g in zip(gps, gj):
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("topk", [5, 100])
def test_non_max_suppression(topk):
    rng = np.random.RandomState(4)
    N = 40
    xy = rng.rand(N, 2) * 3
    boxes = np.concatenate([xy, xy + rng.rand(N, 2) + 0.3], 1) \
        .astype(np.float32)
    scores = (np.round(rng.rand(N) * 6) / 6).astype(np.float32)   # ties
    ij, sj_ = jax.jit(sj.non_max_suppression, static_argnums=(2, 3))(
        jnp.asarray(boxes), jnp.asarray(scores), 0.3, topk)
    it, s_t = st.non_max_suppression(nd.array(boxes, ctx=CPU),
                                     nd.array(scores, ctx=CPU), 0.3, topk)
    assert isinstance(it, nd.NDArray)
    np.testing.assert_array_equal(it.asnumpy(), np.asarray(ij))
    np.testing.assert_array_equal(s_t.asnumpy(), np.asarray(sj_))
    assert (s_t.asnumpy() < 0).any() == (topk > N / 2)
