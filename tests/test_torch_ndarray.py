"""PyTorch port, NDArray: the constructors, properties, methods and
MXNet keywords of `mxnet_tpu_torch.nd` against the JAX package's
`mxnet_tpu.nd` on the CPU (`ctx=mx.cpu()`), from the same numpy inputs.

Values are compared exactly (the same float32 elementwise ops and
reductions of a few elements), dtypes as numpy dtypes. Without `ctx` an
NDArray goes to the card: with none it raises, and with one (faked by
patching `torch.cuda.is_available`) it heads there. Ops the port does
not have raise NotImplementedError naming ROADMAP.md queue 1's "The
eager MXNet surface".
"""
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as ndj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.ndarray import ndarray as nd_module

CPU = mxt.cpu()


def _pair(a, dtype=None):
    return ndj.array(a, dtype=dtype), nd.array(a, ctx=CPU, dtype=dtype)


def _same(j, t):
    assert isinstance(t, nd.NDArray)
    assert t.shape == j.shape and t.dtype == j.dtype, \
        (t.shape, t.dtype, j.shape, j.dtype)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("src", [
    np.arange(6, dtype=np.float64).reshape(2, 3),
    np.arange(6, dtype=np.int64).reshape(3, 2),
    [[1.5, 2.0], [3.0, -4.0]], [1, 2, 3], np.array([True, False]),
    np.float32(2.5)])
def test_array_keeps_mxnet_default_dtypes(src):
    j, t = _pair(src)
    _same(j, t)
    assert (t.size, t.ndim) == (j.size, j.ndim)
    _same(*_pair(src, dtype="float32"))
    _same(*_pair(src, dtype=np.int32))


def test_constructors_match():
    _same(ndj.zeros((2, 3)), nd.zeros((2, 3), ctx=CPU))
    _same(ndj.ones((4,), dtype="int32"), nd.ones((4,), ctx=CPU,
                                                 dtype="int32"))
    _same(ndj.full((2, 2), 7.5), nd.full((2, 2), 7.5, ctx=CPU))
    _same(ndj.arange(5), nd.arange(5, ctx=CPU))
    _same(ndj.arange(1, 7, 2, repeat=2), nd.arange(1, 7, 2, repeat=2,
                                                   ctx=CPU))
    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    b = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    _same(ndj.concatenate([ndj.array(a), ndj.array(b)]),
          nd.concatenate([nd.array(a, ctx=CPU), nd.array(b, ctx=CPU)]))
    nd.waitall()


def test_methods_and_keywords_match():
    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    j, t = _pair(x)
    for fj, ft in (
            (j.reshape(shape=(6, 4)), t.reshape(shape=(6, 4))),
            (j.reshape((0, -1)), t.reshape((0, -1))),
            (j.reshape((4, 6)), t.reshape(4, 6)),
            (j.transpose(axes=(2, 0, 1)), t.transpose(axes=(2, 0, 1))),
            (j.transpose(), t.transpose()),
            (j.astype("int32"), t.astype("int32")),
            (j.argmax(axis=2), t.argmax(axis=2)),
            (j.argmax(axis=1, keepdims=True),
             t.argmax(axis=1, keepdims=True)),
            (j.sum(), t.sum()), (j.sum(axis=1), t.sum(axis=1)),
            (j.astype("int32").sum(axis=0), t.astype("int32").sum(axis=0)),
            ((j > 0).sum(), (t > 0).sum()),
            (j.sum(axis=(0, 2), keepdims=True),
             t.sum(axis=(0, 2), keepdims=True)),
            (j.mean(axis=1, exclude=True), t.mean(axis=1, exclude=True)),
            (j.copy(), t.copy()), (j.detach(), t.detach()),
            (j.as_in_context(ndj.array(0).context),
             t.as_in_context(CPU))):
        np.testing.assert_allclose(ft.asnumpy(), fj.asnumpy(), rtol=1e-6,
                                   atol=1e-6)
        assert ft.shape == fj.shape and ft.dtype == fj.dtype
    assert t.context == torch.device("cpu")
    s = t.sum()
    assert s.asscalar() == pytest.approx(j.sum().asscalar(), rel=1e-6)
    assert s.item() == s.asscalar() and float(s) == s.asscalar()


def test_arithmetic_and_comparisons_match():
    a = np.array([[1.0, -2.0, 3.5], [0.0, 4.0, -1.5]], np.float32)
    b = np.array([[2.0, 2.0, 0.5], [1.0, -4.0, 3.0]], np.float32)
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    for op in (lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
               lambda x, y: x / y, lambda x, y: x ** 2, lambda x, y: 2 ** x,
               lambda x, y: 1.5 - x, lambda x, y: 3 / y, lambda x, y: -x,
               lambda x, y: abs(x), lambda x, y: x + 1, lambda x, y: 2 * x,
               lambda x, y: x % 2, lambda x, y: x == y, lambda x, y: x != 0,
               lambda x, y: x > y, lambda x, y: x >= 1, lambda x, y: x < y,
               lambda x, y: x <= 0, lambda x, y: x + b):
        _same(op(ja, jb), op(ta, tb))
    # accuracy-style: argmax against integer labels, then the mean
    lbl = np.array([2, 1])
    _same((ja.argmax(axis=1) == ndj.array(lbl)).mean(),
          (ta.argmax(axis=1) == nd.array(lbl, ctx=CPU)).mean())


def test_attach_grad_backward_and_out_grad_match():
    from mxnet_tpu import autograd as agj
    from mxnet_tpu_torch import autograd as agt
    x = np.array([[1.0, 2.0], [3.0, -1.0]], np.float32)
    (jx, tx) = _pair(x)
    jx.attach_grad()
    tx.attach_grad()
    np.testing.assert_array_equal(tx.grad.asnumpy(), np.zeros_like(x))
    with agj.record():
        jy = jx * jx * 3 + jx
    with agt.record():
        ty = tx * tx * 3 + tx
    og = np.array([[1.0, 0.5], [2.0, -1.0]], np.float32)
    jy.backward(ndj.array(og))
    ty.backward(nd.array(og, ctx=CPU))
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-6)
    with agt.record():
        tz = (tx * 2).sum()
    tz.backward()                     # 'write': one backward's gradient
    np.testing.assert_array_equal(tx.grad.asnumpy(), np.full_like(x, 2.0))


def test_default_device_is_the_card(monkeypatch):
    """No ctx: the card. Without one the constructors raise; with one
    they head there (torch for the CPU alone then fails to reach it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nd.array([1.0]), lambda: nd.zeros((2,)),
                 lambda: nd.ones((2,)), lambda: nd.full((2,), 1.0),
                 lambda: nd.arange(3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    seen = []
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        seen.append(args[0] if args else kwargs.get("device"))
        return real_to(self, "cpu")

    monkeypatch.setattr(torch.Tensor, "to", to)
    nd.array([1.0, 2.0])
    assert torch.device("cuda", 0) in seen


def test_ops_not_ported_raise_naming_the_roadmap():
    t = nd.array([1.0, 2.0], ctx=CPU)
    # registry ops of the JAX package's random, optimizer and misc modules
    # (math_ops and nn_ops are in the registry since the symbolic slice)
    for name in ("LRN", "smooth_l1", "sgd_update", "shuffle"):
        with pytest.raises(NotImplementedError, match="The eager MXNet surface"):
            getattr(t, name)
        with pytest.raises(NotImplementedError, match="The eager MXNet surface"):
            getattr(nd, name)
    with pytest.raises(NotImplementedError, match="The eager MXNet surface"):
        t.reshape((2, 1), reverse=True)


def _accepts_back(dtype):
    """astype, nd.array and Block.cast take what `NDArray.dtype` gave."""
    assert nd.zeros((2,), ctx=CPU).astype(dtype)._t.dtype == torch.bfloat16
    assert nd.array([3.0], ctx=CPU, dtype=dtype)._t.dtype == torch.bfloat16
    dense = gluon.nn.Dense(2, in_units=3)
    dense.initialize()
    dense.cast(dtype)
    assert {p.dtype for p in dense.parameters()} == {torch.bfloat16}


def test_bfloat16_dtype_matches_jax():
    """ROADMAP queue 3 fault 7: a bf16 array's dtype is the numpy dtype
    the JAX package gives (ml_dtypes' bfloat16), not a torch dtype; its
    host copy stays float32, which holds it exactly."""
    j = ndj.array([1.5, 2.0], dtype="bfloat16")
    t = nd.array([1.5, 2.0], ctx=CPU, dtype="bfloat16")
    for row in (lambda x: x.dtype == "bfloat16", lambda x: str(x.dtype),
                lambda x: np.dtype(x.dtype).itemsize):
        assert row(t) == row(j)
    assert (t.dtype == "bfloat16", str(t.dtype),
            np.dtype(t.dtype).itemsize) == (True, "bfloat16", 2)
    assert t.dtype == j.dtype
    _accepts_back(t.dtype)
    np.testing.assert_array_equal(t.asnumpy(), np.float32([1.5, 2.0]))


def test_bfloat16_dtype_without_ml_dtypes(monkeypatch):
    """Where ml_dtypes cannot be imported, a bf16 array's dtype is a name
    that equals and prints as "bfloat16", 2 bytes wide, and the
    constructors and `Block.cast` accept it."""
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    nd_module._bfloat16.cache_clear()
    try:
        dtype = nd.array([1.0], ctx=CPU, dtype="bfloat16").dtype
        assert not isinstance(dtype, np.dtype)
        assert (dtype == "bfloat16", str(dtype), dtype.itemsize) == \
            (True, "bfloat16", 2)
        _accepts_back(dtype)
    finally:
        nd_module._bfloat16.cache_clear()
