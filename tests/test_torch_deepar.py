"""PyTorch port, DeepAR (`models/deepar.py`) against the JAX package's on
the CPU, float32: a DeepAR of 8 cells and 2 layers, dropout 0, its
weights drawn by the JAX package from seed 0 and carried by name, on the
example's synthetic seasonal series (`RandomState(0)`, 2 + sin(2πt/12) +
0.1 noise).

Tolerances: the teacher-forced forward within 1e-5 and the NLL within
1e-5 relative for both outputs (the JAX op's scan and ATen's LSTM sum
the gates in other orders; lgamma and log differ by float32 ulps);
three eager Adam steps (`autograd.record()`, `model.loss`, `backward()`,
`gluon.Trainer("adam").step(1)`) against the JAX package's: losses
within 1e-5 relative, parameters within 1e-5. `sample_paths` by shape
and statistics only, since the two packages' random streams differ:
over 400 paths each, the per-step mean and standard deviation of the
two packages' paths within 6 standard errors of each other; negative
binomial samples are non-negative integers. `crps_eval` equal.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mxj
from mxnet_tpu import autograd as agj
from mxnet_tpu import gluon as gj
from mxnet_tpu import nd as ndj
from mxnet_tpu.models import deepar as dj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import gluon as gt
from mxnet_tpu_torch import nd, weights
from mxnet_tpu_torch.models import deepar as dt

CPU = mxt.cpu()
B, LEN, CTX, HORIZON = 4, 20, 16, 4
DISTRS = ["GaussianOutput", "NegativeBinomialOutput"]


def _series():
    t = np.arange(LEN)
    return (2.0 + np.sin(2 * np.pi * t / 12)[None, :]
            + 0.1 * np.random.RandomState(0).randn(B, LEN)).astype(np.float32)


def _pair(distr):
    """The JAX model from seed 0 and the port's with its weights (a
    horizon of 4: each step of the JAX sampler compiles its scans
    anew)."""
    mxj.random.seed(0)
    jm = dj.DeepAR(num_cells=8, num_layers=2, context_length=CTX,
                   prediction_length=HORIZON, dropout=0.0,
                   distr=getattr(dj, distr))
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    tm = dt.DeepAR(num_cells=8, num_layers=2, context_length=CTX,
                   prediction_length=HORIZON, dropout=0.0,
                   distr=getattr(dt, distr), device="cpu")
    return jm, weights.load_named_arrays(tm, arrays)


def test_parameter_paths_equal_jax():
    jm, tm = _pair("GaussianOutput")
    assert list(tm.collect_params()) == list(jm.collect_params())
    assert len(tm.collect_params()) == 10


@pytest.mark.parametrize("distr", DISTRS)
def test_forward_and_nll_match_jax(distr):
    jm, tm = _pair(distr)
    x = _series()
    raw_j = jm(ndj.array(x)).asnumpy()
    raw_t = tm(nd.array(x, ctx=CPU))
    assert isinstance(raw_t, nd.NDArray) and raw_t.shape == (B, LEN - 1, 2)
    np.testing.assert_allclose(raw_t.asnumpy(), raw_j, rtol=1e-5, atol=1e-5)
    lj = float(jm.loss(ndj.array(x)).asscalar())
    lt = tm.loss(nd.array(x, ctx=CPU))
    assert isinstance(lt, nd.NDArray)
    np.testing.assert_allclose(lt.asscalar(), lj, rtol=1e-5)
    # the nll on its own, by element
    nll_t = getattr(dt, distr).nll(torch.tensor(raw_j),
                                   torch.tensor(x[:, 1:]))
    nll_j = np.asarray(getattr(dj, distr).nll(raw_j, x[:, 1:]))
    np.testing.assert_allclose(nll_t.numpy(), nll_j, rtol=1e-5, atol=1e-6)


def test_forward_with_features_matches_jax():
    jm, tm = _pair("GaussianOutput")
    x = _series()
    f = np.random.RandomState(1).randn(B, LEN, 1).astype(np.float32)
    want = jm(ndj.array(x), ndj.array(f)).asnumpy()
    got = tm(nd.array(x, ctx=CPU), nd.array(f, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="features"):
        tm.sample_paths(nd.array(x, ctx=CPU), 2, features=f)


@pytest.mark.parametrize("distr", DISTRS)
def test_eager_adam_steps_match_jax(distr):
    jm, tm = _pair(distr)
    x = _series()[:, :CTX]
    trj = gj.Trainer(jm.collect_params(), "adam", {"learning_rate": 5e-3})
    trt = gt.Trainer(tm.collect_params(), "adam", {"learning_rate": 5e-3})
    for _ in range(3):
        with agj.record():
            lj = jm.loss(ndj.array(x))
        lj.backward()
        trj.step(1)
        with agt.record():
            lt = tm.loss(nd.array(x, ctx=CPU))
        lt.backward()
        trt.step(1)
        np.testing.assert_allclose(lt.asscalar(), lj.asscalar(), rtol=1e-5)
    pj = jm.collect_params()
    for k, p in tm.collect_params().items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(pj[k].data()._data),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("distr", DISTRS)
def test_sample_paths_statistics_match_jax(distr):
    jm, tm = _pair(distr)
    ctx = _series()[:, :CTX]
    S = 400
    mxj.random.seed(1)
    sj = jm.sample_paths(ndj.array(ctx), num_samples=S).asnumpy()
    mxt.random.seed(1, "cpu")
    st = tm.sample_paths(nd.array(ctx, ctx=CPU), num_samples=S)
    assert isinstance(st, nd.NDArray) and st.shape == (S, B, HORIZON)
    st = st.asnumpy()
    assert np.isfinite(st).all()
    se = np.sqrt((sj.var(0) + st.var(0)) / S) + 1e-6
    assert np.all(np.abs(st.mean(0) - sj.mean(0)) < 6 * se)
    assert np.all(np.abs(st.std(0) - sj.std(0))
                  < 6 * se + 0.1 * sj.std(0))
    if distr == "NegativeBinomialOutput":
        assert (st >= 0).all() and np.array_equal(st, np.round(st))
    # the port's stream repeats from its seed
    mxt.random.seed(1, "cpu")
    again = tm.sample_paths(torch.tensor(ctx), num_samples=S).numpy()
    np.testing.assert_array_equal(again, st)


def test_crps_eval_equals_jax():
    rng = np.random.RandomState(3)
    samples = rng.randn(50, B, HORIZON).astype(np.float32)
    target = rng.randn(B, HORIZON).astype(np.float32)
    assert dt.crps_eval(samples, target) == dj.crps_eval(samples, target)
