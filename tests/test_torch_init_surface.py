"""PyTorch port, fault 13: the initializer's surface, `mx.init` and
`mx.MXNetError`, held against the JAX package on the CPU.

In both packages `init(shape, dtype)` returns a new array,
`init_array(name, shape, dtype)` returns one by the name rule,
`create(None)` is `Uniform()`, `create(name, **kwargs)` passes the
keyword arguments on, and Constant, Normal, Orthogonal, MSRAPrelu and
Bilinear exist. Shapes, dtypes and the name rule must be equal. The two
packages' random streams differ by design (ROADMAP.md "Not faults"), so
after `random.seed` the draws are held to the same distribution: the
same bounds, the mean within 3 standard errors of 0, the variance within
3% of the distribution's. Bilinear draws nothing and is equal; the
orthogonal factor of the same matrix is equal within 1e-5 (both take
Q · sign(diag R)).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import initializer as init_j
from mxnet_tpu.base import MXNetError as MXNetError_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import initializer as init_t

SHAPE = (200, 300)


def _draw(package, make, shape=SHAPE, dtype="float32", seed=0):
    if package == "jax":
        mx.random.seed(seed)
        out = make(init_j)(shape, dtype)
        return np.asarray(out.astype(jnp.float32)), str(out.dtype)
    mxt.random.seed(seed, "cpu")
    with mxt.cpu():
        out = make(init_t)(shape, dtype)
    return out.float().numpy(), str(out.dtype).removeprefix("torch.")


def _stats_agree(x, lo, hi, var):
    assert x.min() >= lo and x.max() <= hi
    n = x.size
    assert abs(x.mean()) < 3 * math.sqrt(var / n)
    assert abs(x.var() / var - 1) < 0.03


@pytest.mark.parametrize("package", ["jax", "port"])
def test_mx_init_xavier_call_returns_an_array(package):
    """`mx.init.Xavier()((64, 32))`, the call train_mnist_module.py's
    initializer makes for each weight."""
    m = mx if package == "jax" else mxt
    if package == "jax":
        out = m.init.Xavier()((64, 32))
        x = np.asarray(out)
    else:
        with mxt.cpu():
            out = m.init.Xavier()((64, 32))
        x = out.numpy()
    assert x.shape == (64, 32) and x.dtype == np.float32
    s = math.sqrt(3 / 48)
    assert np.abs(x).max() <= s and x.std() > 0


@pytest.mark.parametrize("make,lo,hi,var", [
    (lambda m: m.Xavier(), -math.sqrt(3 / 250), math.sqrt(3 / 250),
     3 / 250 / 3),
    (lambda m: m.create("xavier", magnitude=2), -math.sqrt(2 / 250),
     math.sqrt(2 / 250), 2 / 250 / 3),
    (lambda m: m.Xavier("gaussian", "in", 2), -1, 1, 2 / 300),
    (lambda m: m.create(None), -0.07, 0.07, 0.07 ** 2 / 3),
    (lambda m: m.Uniform(0.3), -0.3, 0.3, 0.09 / 3),
    (lambda m: m.Normal(0.2), -2, 2, 0.04),
    (lambda m: m.create("normal", sigma=0.5), -3, 3, 0.25),
    (lambda m: m.MSRAPrelu(), -1, 1, 2 / (1 + 0.0625) / 250),
    (lambda m: m.create("msraprelu", factor_type="out", slope=0.5), -1, 1,
     2 / 1.25 / 200)],
    ids=["xavier", "create-xavier-magnitude", "xavier-gaussian-in",
         "create-none", "uniform", "normal", "create-normal", "msraprelu",
         "create-msraprelu"])
def test_draws_follow_the_jax_distribution(make, lo, hi, var):
    for package in ("jax", "port"):
        x, dtype = _draw(package, make)
        assert x.shape == SHAPE and dtype == "float32"
        _stats_agree(x, lo, hi, var)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dtype_and_seed_repeat_as_in_jax(dtype):
    for package in ("jax", "port"):
        a, da = _draw(package, lambda m: m.Xavier(), (8, 6), dtype, seed=3)
        b, _ = _draw(package, lambda m: m.Xavier(), (8, 6), dtype, seed=3)
        c, _ = _draw(package, lambda m: m.Xavier(), (8, 6), dtype, seed=4)
        assert da == dtype
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


@pytest.mark.parametrize("name,want", [
    ("fc1_bias", 0.0), ("bn_beta", 0.0), ("bn_running_mean", 0.0),
    ("bn_moving_mean", 0.0), ("bn_gamma", 1.0), ("bn_running_var", 1.0),
    ("bn_moving_var", 1.0), ("fc1_weight", None)])
def test_init_array_name_rule(name, want):
    outs = []
    for package in ("jax", "port"):
        if package == "jax":
            mx.random.seed(0)
            x = np.asarray(init_j.Xavier().init_array(name, (8,)))
        else:
            mxt.random.seed(0, "cpu")
            x = init_t.Xavier().init_array(name, (8,), device="cpu").numpy()
        assert x.shape == (8,) and x.dtype == np.float32
        outs.append(x)
        if want is None:
            assert np.abs(x).max() > 0
        else:
            np.testing.assert_array_equal(x, np.full(8, want, np.float32))


def test_init_array_takes_the_jax_modules_call():
    """The JAX `Module` calls `init_array(name, arr.shape, arr.dtype)`
    (positional shape and dtype); so does the port's."""
    with mxt.cpu():
        out = init_t.Uniform(0.01).init_array("w", (3, 2), torch.float32)
    assert out.shape == (3, 2) and np.abs(out.numpy()).max() <= 0.01


def test_constant_and_bilinear_equal_jax():
    for make, shape in ((lambda m: m.Constant(0.5), (3, 4)),
                        (lambda m: m.create("constant", value=-2.0), (5,)),
                        (lambda m: m.Bilinear(), (2, 1, 4, 4)),
                        (lambda m: m.create("bilinear"), (1, 1, 3, 6)),
                        (lambda m: m.create("zeros"), (2, 2)),
                        (lambda m: m.One(), (2,))):
        j, dj = _draw("jax", make, shape)
        t, dt = _draw("port", make, shape)
        assert dj == dt == "float32"
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("shape", [(6, 4), (4, 6), (3, 2, 2, 2)])
def test_orthogonal(shape):
    """Both packages give `scale` times orthonormal rows (or columns) of
    the flattened matrix, and the same factor of the same draw."""
    for package in ("jax", "port"):
        x, dtype = _draw(package, lambda m: m.Orthogonal(scale=1.5), shape)
        assert x.shape == shape and dtype == "float32"
        m = x.reshape(shape[0], -1)
        g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(g, 2.25 * np.eye(len(g)), atol=1e-5)
    a = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    q, r = jnp.linalg.qr(jnp.asarray(a))
    ref = np.asarray(q * jnp.sign(jnp.diagonal(r)))
    got = init_t.orthogonal_factor(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_registry_names_equal_jax():
    assert init_t._registry.keys() == init_j._registry.keys()
    for name in init_t._registry.keys():
        assert type(init_t.create(name)).__name__ == \
            type(init_j.create(name)).__name__
    with pytest.raises(TypeError):
        init_t.create(3)
    with pytest.raises(KeyError):
        init_t.create("no_such_init")


def test_mx_init_and_mxnet_error_on_the_package():
    assert mxt.init is init_t
    assert issubclass(mxt.MXNetError, RuntimeError)
    assert mxt.MXNetError is mxt.base.MXNetError
    assert MXNetError_j.__mro__[1:] == mxt.MXNetError.__mro__[1:]
    from mxnet_tpu_torch import sym
    a, b = sym.Variable("a"), sym.Variable("b")
    ex = (a + b).bind(args={"a": mxt.nd.array([1.0], ctx=mxt.cpu())})
    with pytest.raises(mxt.MXNetError, match="unbound variable 'b'"):
        ex.forward()


@pytest.mark.parametrize("alias,module", [
    ("sym", "symbol"), ("symbol", "symbol"), ("mod", "module"),
    ("module", "module"), ("model", "module"), ("io", "io"),
    ("callback", "callback"), ("mon", "monitor"), ("monitor", "monitor"),
    ("name", "name"), ("attribute", "attribute"),
    ("executor", "symbol.executor"), ("registry", "registry"),
    ("init", "initializer")])
def test_package_aliases_are_the_jax_names(alias, module):
    import importlib
    assert getattr(mxt, alias) is importlib.import_module(
        f"mxnet_tpu_torch.{module}")
    assert getattr(mx, alias).__name__ == f"mxnet_tpu.{module}"
    assert mxt.AttrScope is mxt.attribute.AttrScope
