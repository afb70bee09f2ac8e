"""PyTorch port, the rest of `ops/misc_ops.py` by MXNet name (27 names
with the aliases) against the JAX package on the CPU: each op called as
`nd.<name>` on both packages from the same seeded numpy inputs, the
forward within 1e-5 and, where the op has inputs to differentiate, the
gradient of `backward(head)` (a seeded head gradient; the loss layers
ignore it, as their JAX custom gradients do) within 1e-5. The creation
ops `_arange`, `_eye`, `_linspace` are held by value; `Crop`'s
refusals by their messages.
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as ag_j
from mxnet_tpu import nd as nd_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import nd as nd_t

CPU = mxt.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)
R = np.random.RandomState(0)


def _f(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def _grid(b, h, w):
    ys, xs = np.meshgrid(np.linspace(-0.9, 0.8, h), np.linspace(-0.7, 0.9, w),
                         indexing="ij")
    return np.tile(np.stack([xs, ys])[None], (b, 1, 1, 1)).astype(np.float32)


# name -> (inputs, number of differentiated inputs (leading), kwargs)
CASES = {
    "BlockGrad": ([_f(3, 4)], 1, {}),
    "stop_gradient": ([_f(3, 4)], 1, {}),
    "MakeLoss": ([_f(4, 3)], 1, dict(grad_scale=2.0,
                                     normalization="batch")),
    "make_loss": ([_f(4, 3)], 1, dict(normalization="valid",
                                      valid_thresh=0.1)),
    "LinearRegressionOutput": ([_f(5, 3), _f(5, 3)], 1,
                               dict(grad_scale=0.5)),
    "LogisticRegressionOutput": ([_f(4, 2), (R.rand(4, 2) > 0.5)
                                  .astype(np.float32)], 1, {}),
    "MAERegressionOutput": ([_f(3, 4), _f(3, 4)], 1, {}),
    "SVMOutput": ([_f(4, 5), np.array([0, 3, 1, 4], np.float32)], 1,
                  dict(margin=0.5, regularization_coefficient=2.0)),
    "smooth_l1": ([_f(6, lo=-3, hi=3)], 1, dict(scalar=1.5)),
    "SoftmaxActivation": ([_f(2, 3, 4)], 1, dict(mode="channel")),
    "LRN": ([_f(2, 7, 3, 3, lo=0.0)], 1, dict(alpha=1e-3, beta=0.75,
                                              knorm=2.0, nsize=3)),
    "BilinearSampler": ([_f(2, 3, 5, 5), _grid(2, 4, 6)], 1, {}),
    "GridGenerator": ([_f(2, 6)], 1, dict(transform_type="affine",
                                          target_shape=(4, 5))),
    "SpatialTransformer": ([_f(2, 2, 5, 5), np.tile(np.array(
        [0.9, 0.1, 0.05, -0.1, 0.8, 0.0], np.float32), (2, 1))], 2,
        dict(target_shape=(4, 4))),
    "Correlation": ([_f(1, 3, 6, 6), _f(1, 3, 6, 6)], 2,
                    dict(kernel_size=3, max_displacement=2, stride1=1,
                         stride2=2, pad_size=2)),
    "depth_to_space": ([_f(2, 8, 3, 3)], 1, dict(block_size=2)),
    "space_to_depth": ([_f(2, 2, 4, 6)], 1, dict(block_size=2)),
    "batch_take": ([_f(4, 3), np.array([0, 2, 1, 0], np.float32)], 1, {}),
    "ravel_multi_index": ([np.array([[0, 2], [3, 1], [4, 0]], np.int32)], 0,
                          dict(shape=(3, 4, 5))),
    "unravel_index": ([np.array([0, 7, 59, 23], np.int32)], 0,
                      dict(shape=(3, 4, 5))),
    "khatri_rao": ([_f(2, 3), _f(3, 3), _f(2, 3)], 3, {}),
    "_contrib_fft": ([_f(2, 8)], 1, {}),
    "_contrib_ifft": ([_f(2, 16)], 1, {}),
    "Crop": ([_f(1, 2, 5, 5), _f(1, 2, 3, 2)], 1, dict(offset=(1, 2))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_misc_op_forward_and_gradient(name):
    ins, n_diff, kw = CASES[name]
    outs, grads = {}, {}
    for pkg, nd, ag, arr in (
            ("jax", nd_j, ag_j, nd_j.array),
            ("port", nd_t, ag_t, lambda v: nd_t.array(v, ctx=CPU))):
        xs = [arr(a) for a in ins]
        for x in xs[:n_diff]:
            x.attach_grad()
        with ag.record():
            y = getattr(nd, name)(*xs, **kw)
        outs[pkg] = y.asnumpy()
        if n_diff:
            head = np.random.RandomState(1).rand(*y.shape).astype(np.float32)
            y.backward(arr(head))
            grads[pkg] = [x.grad.asnumpy() for x in xs[:n_diff]]
    assert outs["port"].shape == outs["jax"].shape
    assert outs["port"].dtype == outs["jax"].dtype
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)
    for g, r in zip(grads.get("port", []), grads.get("jax", [])):
        np.testing.assert_allclose(g, r, **TOL)


def test_grid_generator_warp_and_instance_softmax():
    flow = _f(1, 2, 3, 4)
    x = _f(2, 3, 4)
    for got, ref in (
            (nd_t.GridGenerator(nd_t.array(flow, ctx=CPU),
                                transform_type="warp"),
             nd_j.GridGenerator(nd_j.array(flow), transform_type="warp")),
            (nd_t.SoftmaxActivation(nd_t.array(x, ctx=CPU)),
             nd_j.SoftmaxActivation(nd_j.array(x))),
            (nd_t.Correlation(nd_t.array(x[None], ctx=CPU),
                              nd_t.array(x[None] * 2, ctx=CPU),
                              is_multiply=False, max_displacement=1),
             nd_j.Correlation(nd_j.array(x[None]), nd_j.array(x[None] * 2),
                              is_multiply=False, max_displacement=1))):
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **TOL)


def test_creation_ops_by_name():
    with mxt.cpu():
        for name, kw in (("_arange", dict(start=1, stop=7, step=2)),
                         ("_arange", dict(start=0, stop=3, repeat=2)),
                         ("_arange", dict(start=4)),
                         ("_linspace", dict(start=0, stop=1, num=5)),
                         ("_linspace", dict(start=-2, stop=3, num=4,
                                            endpoint=False)),
                         ("_eye", dict(N=3, M=4, k=1)),
                         ("_eye", dict(N=4, k=-2, dtype="int32"))):
            got, ref = getattr(nd_t, name)(**kw), getattr(nd_j, name)(**kw)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **TOL)


def test_crop_forms_and_refusals():
    x = np.arange(32, dtype=np.float32).reshape(1, 2, 4, 4)
    for nd, arr in ((nd_j, nd_j.array),
                    (nd_t, lambda v: nd_t.array(v, ctx=CPU))):
        out = nd.Crop(arr(x), h_w=(2, 2), center_crop=True).asnumpy()
        np.testing.assert_array_equal(out, x[:, :, 1:3, 1:3])
        with pytest.raises(ValueError, match="does not fit"):
            nd.Crop(arr(x), h_w=(2, 2), offset=(3, 3))
        with pytest.raises(ValueError, match="positive"):
            nd.Crop(arr(x))
    assert nd_t.Cast(nd_t.array(x, ctx=CPU), dtype="int32").dtype == np.int32
