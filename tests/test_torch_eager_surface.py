"""PyTorch port, MXNet's eager NDArray surface against the JAX package on
the CPU, from the same seeded numpy inputs: indexing (basic, advanced
and NDArray keys; forward and gradient), `__setitem__`, the in-place
operators with the mutation guard, the methods the JAX class has (`T`,
`tolist`, `copyto`, `__matmul__`, `__int__`, `__len__`), the
constructors `empty`, `eye`, `linspace`, and `nd.random`. Values are
compared exactly (indexing and assignment move numbers; tolerance 0)
or within 1e-6 (arithmetic). Random draws come from different streams
in the two packages, so `nd.random` is held in distribution: shapes,
dtypes, ranges, and moments within a bound stated per case.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu import nd as nd_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import nd as nd_t

CPU = mxt.cpu()


def _pair(a):
    return nd_j.array(a), nd_t.array(a, ctx=CPU)


X = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

KEYS = [0, (1, 2), (slice(None), slice(1, 3)), (Ellipsis, 1),
        (0, slice(None, None, 2)), -1, ([0, 1], [2, 0]),
        (slice(None), [2, 0, 1])]


@pytest.mark.parametrize("key", KEYS, ids=[repr(k) for k in KEYS])
def test_getitem_forward_and_gradient(key):
    j, t = _pair(X)
    np.testing.assert_array_equal(t[key].asnumpy(), j[key].asnumpy())
    for x in (j, t):
        x.attach_grad()
    with ag_j.record():
        yj = (j[key] * j[key]).sum()
    yj.backward()
    with ag_t.record():
        yt = (t[key] * t[key]).sum()
    yt.backward()
    np.testing.assert_array_equal(t.grad.asnumpy(), j.grad.asnumpy())


def test_getitem_with_ndarray_keys():
    j, t = _pair(X)
    kj, kt = _pair(np.array([1.0, 0.0, 1.0], np.float32))
    np.testing.assert_array_equal(t[kt].asnumpy(), j[kj].asnumpy())
    mj, mt = _pair(np.array([2, 0], np.int32))
    np.testing.assert_array_equal(t[:, mt].asnumpy(), j[:, mj].asnumpy())
    assert len(t) == len(j) == 2


SET_CASES = [
    ((0, 0, 0), 100.0), (1, 0.0), ((slice(None), 1), -1.0),
    ((0, slice(1, 3)), np.ones((2, 4), np.float32) * 7),
    (([0, 1], [1, 2]), np.array([[5.0], [6.0]], np.float32)),
    (slice(None), 3.5)]


@pytest.mark.parametrize("key,value", SET_CASES,
                         ids=[repr(k) for k, _ in SET_CASES])
def test_setitem_keys(key, value):
    j, t = _pair(X)
    vj = nd_j.array(value) if isinstance(value, np.ndarray) else value
    vt = nd_t.array(value, ctx=CPU) if isinstance(value, np.ndarray) \
        else value
    j[key] = vj
    t[key] = vt
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_setitem_ndarray_key_and_aliasing_as_jax():
    """An NDArray key; an array that shared the old value keeps it (the
    JAX package's buffers are immutable); an attached leaf keeps its
    gradient buffer."""
    j, t = _pair(X)
    dj, dt = j.detach(), t.detach()
    kj, kt = _pair(np.array([1], np.int32))
    j[kj] = 0.0
    t[kt] = 0.0
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(dt.asnumpy(), dj.asnumpy())
    np.testing.assert_array_equal(dt.asnumpy(), X)
    w = nd_t.array(np.ones(3, np.float32), ctx=CPU)
    w.attach_grad()
    w[1] = 5.0
    with ag_t.record():
        (w * w).sum().backward()
    np.testing.assert_array_equal(w.grad.asnumpy(), [2.0, 10.0, 2.0])


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_inplace_operators(op):
    a = np.random.RandomState(0).rand(3, 4).astype(np.float32) + 0.5
    b = np.random.RandomState(1).rand(3, 4).astype(np.float32) + 0.5
    out = {}
    for name, nd, arr in (("jax", nd_j, nd_j.array),
                          ("port", nd_t, lambda v: nd_t.array(v, ctx=CPU))):
        x, y = arr(a), arr(b)
        before = x
        scope = {"x": x, "y": y}
        exec(f"x {op} y\nx {op} 2.0", scope)
        assert scope["x"] is before
        out[name] = scope["x"].asnumpy()
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mutation_guard(pkg):
    nd, ag = (nd_j, ag_j) if pkg == "jax" else (nd_t, ag_t)
    x = nd.array([1.0, 2.0]) if pkg == "jax" else nd.array([1.0, 2.0],
                                                           ctx=CPU)
    x.attach_grad()
    with ag.record():
        y = x * 2
    for mutate in (lambda: y.__iadd__(1), lambda: y.__isub__(1),
                   lambda: y.__imul__(2), lambda: y.__itruediv__(2),
                   lambda: y.__setitem__(0, 5.0)):
        with pytest.raises(RuntimeError, match="recorded graph"):
            mutate()
    z = nd.array([1.0]) if pkg == "jax" else nd.array([1.0], ctx=CPU)
    z += 1
    assert z.asscalar() == 2.0


def test_methods_like_jax():
    a = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    b = np.random.RandomState(3).rand(4, 2).astype(np.float32)
    (j, t), (jb, tb) = _pair(a), _pair(b)
    np.testing.assert_array_equal(t.T.asnumpy(), j.T.asnumpy())
    assert t.tolist() == j.tolist()
    np.testing.assert_allclose((t @ tb).asnumpy(), (j @ jb).asnumpy(),
                               rtol=1e-6)
    assert int(nd_t.array([7.0], ctx=CPU)) == int(nd_j.array([7.0])) == 7
    assert t.wait_to_read() is t
    dj, dt = nd_j.zeros((3, 4)), nd_t.zeros((3, 4), ctx=CPU)
    assert j.copyto(dj) is dj and t.copyto(dt) is dt
    np.testing.assert_array_equal(dt.asnumpy(), dj.asnumpy())
    c = t.copyto(CPU)
    assert c is not t and c.context == CPU


def test_constructors_like_jax():
    with mxt.cpu():
        for fj, ft in ((nd_j.empty((2, 3)), nd_t.empty((2, 3))),
                       (nd_j.eye(3, 4, 1), nd_t.eye(3, 4, 1)),
                       (nd_j.eye(3), nd_t.eye(3)),
                       (nd_j.linspace(0, 1, 5), nd_t.linspace(0, 1, 5)),
                       (nd_j.linspace(0, 1, 4, endpoint=False),
                        nd_t.linspace(0, 1, 4, endpoint=False))):
            assert ft.shape == fj.shape and ft.dtype == fj.dtype
            np.testing.assert_allclose(ft.asnumpy(), fj.asnumpy(),
                                       rtol=1e-6)


# -- nd.random ------------------------------------------------------------------

N = 20000


def _draw(pkg, fn, **kw):
    if pkg == "jax":
        return getattr(nd_j.random, fn)(**kw)
    with mxt.cpu():
        return getattr(nd_t.random, fn)(**kw)


# (function, kwargs, expected mean, expected variance, support check)
RANDOM = [
    ("uniform", dict(low=-1.0, high=3.0, shape=(N,)), 1.0, 16 / 12,
     lambda v: (v >= -1).all() and (v < 3).all()),
    ("normal", dict(loc=2.0, scale=0.5, shape=(N,)), 2.0, 0.25, None),
    ("gamma", dict(alpha=2.0, beta=1.5, shape=(N,)), 3.0, 4.5,
     lambda v: (v > 0).all()),
    ("gamma", dict(alpha=0.5, beta=1.0, shape=(N,)), 0.5, 0.5,
     lambda v: (v >= 0).all()),
    ("exponential", dict(scale=2.0, shape=(N,)), 2.0, 4.0,
     lambda v: (v >= 0).all()),
    ("poisson", dict(lam=3.0, shape=(N,)), 3.0, 3.0,
     lambda v: (v == np.round(v)).all()),
    ("negative_binomial", dict(k=3, p=0.4, shape=(N,)), 4.5, 11.25,
     lambda v: (v >= 0).all() and (v == np.round(v)).all()),
    ("randint", dict(low=2, high=9, shape=(N,)), 5.0, 48 / 12,
     lambda v: (v >= 2).all() and (v < 9).all()),
]


@pytest.mark.parametrize("fn,kw,mean,var,support", RANDOM,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(RANDOM)])
def test_random_in_distribution(fn, kw, mean, var, support):
    """Both packages' draws: the same shape and dtype, the support, and
    mean and variance within 5 standard errors of the distribution's."""
    mxt.random.seed(0, "cpu")
    mx.random.seed(0)
    dj, dt = _draw("jax", fn, **kw), _draw("port", fn, **kw)
    assert dt.shape == dj.shape and dt.dtype == dj.dtype
    for d in (dj, dt):
        v = d.asnumpy().astype(np.float64)
        if support is not None:
            assert support(v)
        assert abs(v.mean() - mean) < 5 * np.sqrt(var / N)
        assert abs(v.var() - var) < 0.1 * var


def test_random_shapes_seed_and_device():
    with mxt.cpu():
        assert nd_t.random.randn(2, 3).shape == nd_j.random.randn(2, 3).shape
        assert nd_t.random.uniform().shape == nd_j.random.uniform().shape
        mxt.random.seed(5, "cpu")
        a = nd_t.random.normal(shape=(4,)).asnumpy()
        mxt.random.seed(5, "cpu")
        np.testing.assert_array_equal(nd_t.random.normal(shape=(4,))
                                      .asnumpy(), a)
        out = nd_t.zeros((3,))
        assert nd_t.random.uniform(shape=(3,), out=out) is out
    assert nd_t.random.uniform(shape=(2,), ctx=CPU).context == CPU


def test_multinomial_and_shuffle():
    probs = np.array([[0.1, 0.6, 0.3], [0.7, 0.2, 0.1]], np.float32)
    with mxt.cpu():
        s = nd_t.random.multinomial(nd_t.array(probs), shape=(N,))
        s1, logp = nd_t.random.multinomial(nd_t.array(probs), get_prob=True)
        x = nd_t.array(np.arange(10, dtype=np.float32))
        perm = nd_t.random.shuffle(x).asnumpy()
    sj = nd_j.random.multinomial(nd_j.array(probs), shape=(N,))
    assert s.shape == sj.shape and s.dtype == sj.dtype
    freq = np.stack([(s.asnumpy() == k).mean(1) for k in range(3)], 1)
    np.testing.assert_allclose(freq, probs, atol=0.02)
    assert s1.shape == (2,)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(probs[np.arange(2), s1.asnumpy()]),
        rtol=1e-5)
    assert sorted(perm) == list(range(10))


def test_random_op_records_one_draw():
    """The draw made in the forward is the one the backward sees
    (`test_autograd_modes.py`'s check on the port)."""
    mxt.random.seed(7, "cpu")
    x = nd_t.ones((64,), ctx=CPU)
    x.attach_grad()
    with ag_t.record():
        noise = nd_t.random.uniform(shape=(64,), ctx=CPU)
        y = (x * (noise > 0.5)).sum()
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(),
                                  (noise.asnumpy() > 0.5).astype(np.float32))
    assert isinstance(noise._t, torch.Tensor)


# -- sparse storage -----------------------------------------------------------

DENSE = np.asarray([[0, 1, 0], [0, 0, 0], [2, 3, 0], [0, 0, 4]], np.float32)


def test_cast_storage_like_jax():
    """row_sparse and csr from a dense array and back: the same
    compressed arrays (values, indices, indptr) as the JAX package's."""
    dj, dt = _pair(DENSE)
    for stype in ("row_sparse", "csr"):
        sj, st = nd_j.cast_storage(dj, stype), nd_t.cast_storage(dt, stype)
        assert type(st).__name__ == type(sj).__name__
        assert st.stype == sj.stype == stype and st.shape == sj.shape
        np.testing.assert_array_equal(st.data.asnumpy(), sj.data.asnumpy())
        np.testing.assert_array_equal(st.indices.asnumpy(),
                                      sj.indices.asnumpy())
        if stype == "csr":
            np.testing.assert_array_equal(st.indptr.asnumpy(),
                                          sj.indptr.asnumpy())
            np.testing.assert_array_equal(st[2].asnumpy(), DENSE[2])
            np.testing.assert_array_equal(st[1:3].asnumpy(), DENSE[1:3])
        np.testing.assert_array_equal(st.tostype("default").asnumpy(), DENSE)
        assert st.context == CPU
    assert dt.stype == "default"
    with pytest.raises(ValueError, match="row_sparse -> csr"):
        nd_t.cast_storage(dt, "row_sparse").tostype("csr")


def test_sparse_dot_add_retain_like_jax():
    rhs = np.random.RandomState(0).randn(3, 2).astype(np.float32)
    rhs_t = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    dj, dt = _pair(DENSE)
    cj, ct = nd_j.cast_storage(dj, "csr"), nd_t.cast_storage(dt, "csr")
    np.testing.assert_allclose(
        nd_t.sparse.dot(ct, nd_t.array(rhs, ctx=CPU)).asnumpy(),
        nd_j.sparse.dot(cj, nd_j.array(rhs)).asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(
        nd_t.sparse.dot(ct, nd_t.array(rhs_t, ctx=CPU),
                        transpose_a=True).asnumpy(),
        nd_j.sparse.dot(cj, nd_j.array(rhs_t), transpose_a=True).asnumpy(),
        rtol=1e-6)
    other = DENSE[::-1].copy()
    rj = nd_j.cast_storage(dj, "row_sparse") + nd_j.cast_storage(
        nd_j.array(other), "row_sparse")
    rt = nd_t.cast_storage(dt, "row_sparse") + nd_t.cast_storage(
        nd_t.array(other, ctx=CPU), "row_sparse")
    assert type(rt).__name__ == "RowSparseNDArray"
    np.testing.assert_array_equal(rt.indices.asnumpy(), rj.indices.asnumpy())
    np.testing.assert_array_equal(rt.asnumpy(), rj.asnumpy())
    kept = nd_t.sparse.retain(rt, nd_t.array([0, 3], ctx=CPU))
    np.testing.assert_array_equal(
        kept.asnumpy(), nd_j.sparse.retain(rj, nd_j.array([0, 3])).asnumpy())
    built = nd_t.sparse.row_sparse_array(
        (np.ones((2, 3), np.float32), [3, 1]), shape=(5, 3), ctx=CPU)
    np.testing.assert_array_equal(built.indices.asnumpy(), [1, 3])
    z = nd_t.sparse.zeros("csr", (3, 4), ctx=CPU)
    assert z.nnz == 0 and z.asnumpy().sum() == 0
