"""PyTorch port, `parallel.ShardedTrainer`'s user boundary against the
JAX package's (ROADMAP queue 3, fault 9): `loss_fn` receives NDArrays
and may return `nd.<op>(...).mean()`, an NDArray; `step` takes
NDArrays and returns the loss as an NDArray, whose `asscalar()` reads
it. A Dense layer over (T, N, F) features gives (T, N, C) logits; two
Adam steps from the same weights (batch 8, which the JAX trainer's
8-device CPU mesh divides) with a loss over `nd.ctc_loss` and one over
`nd.concat`: each step's `asscalar()` within 1e-6 of the JAX trainer's,
and the trained weights within 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import nd as ndj
from mxnet_tpu import parallel as par_j
from mxnet_tpu.gluon import nn as nn_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd, parallel, weights
from mxnet_tpu_torch.gluon import nn as nn_t

CPU = mxt.cpu()
T, N, F, C = 8, 8, 5, 4

LOSSES = {
    "ctc_loss": lambda ns: lambda out, label: ns.ctc_loss(out,
                                                          label).mean(),
    "concat": lambda ns: lambda out, label: (
        (ns.concat(out, out, dim=2) - label) ** 2).mean(),
}


def _batch(name):
    rng = np.random.RandomState(0)
    x = rng.randn(T, N, F).astype(np.float32)
    if name == "ctc_loss":
        y = rng.randint(1, C, (N, 3)).astype(np.float32)
    else:
        y = rng.randn(T, N, 2 * C).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_step_returns_the_jax_trainers_ndarray_loss(name):
    x, y = _batch(name)
    mxj.random.seed(0)
    jm = nn_j.Dense(C, flatten=False, in_units=F)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    par_j.make_mesh(dp=-1)
    try:
        jt = par_j.ShardedTrainer(jm, LOSSES[name](ndj), "adam",
                                  {"learning_rate": 0.05})
        jl = [float(jt.step([ndj.array(x)], [ndj.array(y)]).asscalar())
              for _ in range(2)]
        jw = [np.asarray(w) for w in jt.params]
    finally:
        par_j.set_mesh(None)
    tm = weights.load_named_arrays(nn_t.Dense(C, flatten=False, in_units=F),
                                   arrays)
    tt = parallel.ShardedTrainer(tm, LOSSES[name](nd), "adam",
                                 {"learning_rate": 0.05}, device="cpu")
    tl = []
    for _ in range(2):
        loss = tt.step([nd.array(x, ctx=CPU)], [nd.array(y, ctx=CPU)])
        assert isinstance(loss, nd.NDArray)
        assert loss.shape == () and loss.dtype == np.float32
        tl.append(float(loss.asscalar()))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-6)
    assert tl[1] < tl[0]
    for w_t, w_j in zip(tt.params, jw):
        np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=1e-6)
