"""PyTorch port, the eager `gluon.Trainer`, its optimizers and the lr
schedulers against the JAX package's on the CPU, and the promotion of
`nn_ops.fully_connected`.

A small two-layer Dense net (weights carried by name) trains 3 steps of
the MXNet loop (`autograd.record()`, `L2Loss`, `backward()`,
`trainer.step(batch_size)`) with sgd (momentum, wd), nag, adam and adamw
(wd, clip), one bias at `wd_mult` 0 and one weight at `lr_mult` 0.5,
and `set_learning_rate` before the last step. Losses and parameters
within 2e-6 (float32; for Adam the step divides the gradient by its own
magnitude, which passes on the last bits). Schedulers are plain Python
in both packages: compared exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import autograd as agj
from mxnet_tpu import gluon as gj
from mxnet_tpu import lr_scheduler as lrj
from mxnet_tpu import nd as ndj
from mxnet_tpu import optimizer as optj
from mxnet_tpu.ops import nn_ops as opsj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import gluon as gt
from mxnet_tpu_torch import lr_scheduler as lrt
from mxnet_tpu_torch import nd, weights
from mxnet_tpu_torch import optimizer as optt
from mxnet_tpu_torch.ops import nn_ops

CPU = mxt.cpu()

_OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
         "nag": {"learning_rate": 0.1, "momentum": 0.9},
         "adam": {"learning_rate": 1e-2},
         "adamw": {"learning_rate": 1e-2, "wd": 1e-2, "clip_gradient": 1.0}}


def _net(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(6, in_units=5, activation="tanh"),
            g.nn.Dense(3, in_units=6))
    return net


def _mults(params):
    params["0.bias"].wd_mult = 0.0
    params["1.weight"].lr_mult = 0.5


@pytest.mark.parametrize("kind", sorted(_OPTS))
def test_trainer_steps_match_jax(kind):
    _train_both(kind)


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_trainer_updates_the_list_once_a_step(kind, monkeypatch):
    """`Trainer.step` with Adam/AdamW makes one `update_multi` call a step
    over every trainable parameter (one kernel launch a weight dtype on
    the card), never `update` per index, and still trains as the JAX
    package's per-index updates do (the lr_mult/wd_mult case, 2e-6)."""
    calls = []
    multi = optt.Adam.update_multi

    def counted(self, indices, weights, grads, states):
        calls.append(list(indices))
        return multi(self, indices, weights, grads, states)

    def per_index(*args):
        raise AssertionError("Adam.update called per index")

    monkeypatch.setattr(optt.Adam, "update_multi", counted)
    monkeypatch.setattr(optt.Adam, "update", per_index)
    _train_both(kind)
    assert calls == [[0, 1, 2, 3]] * 3


def _train_both(kind):
    """Three steps of the MXNet loop in both packages; losses and
    parameters within 2e-6."""
    jnet = _net(gj)
    jnet.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = weights.load_named_arrays(_net(gt), arrays)
    _mults(jnet.collect_params())
    _mults(tnet.collect_params())
    trj = gj.Trainer(jnet.collect_params(), kind, dict(_OPTS[kind]))
    trt = gt.Trainer(tnet.collect_params(), kind, dict(_OPTS[kind]))
    rng = np.random.RandomState(0)
    x = rng.randn(5, 5).astype(np.float32)
    y = rng.randn(5, 3).astype(np.float32)
    lj_fn, lt_fn = gj.loss.L2Loss(), gt.loss.L2Loss()
    for step in range(3):
        if step == 2:
            trj.set_learning_rate(trj.learning_rate / 2)
            trt.set_learning_rate(trt.learning_rate / 2)
        with agj.record():
            lj = lj_fn(jnet(ndj.array(x)), ndj.array(y))
        with agt.record():
            lt = lt_fn(tnet(nd.array(x, ctx=CPU)), nd.array(y, ctx=CPU))
        assert isinstance(lt, nd.NDArray) and lt.shape == (5,)
        np.testing.assert_allclose(lt.asnumpy(), lj.asnumpy(), rtol=2e-6,
                                   atol=2e-6)
        lj.backward()
        lt.backward()
        trj.step(5)
        trt.step(5)
        assert trt.optimizer.rescale_grad == trj.optimizer.rescale_grad
        assert trt.learning_rate == trj.learning_rate
    for k, p in tnet.collect_params().items():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(jnet.collect_params()[k].data()
                                           ._data), rtol=2e-6, atol=2e-6,
            err_msg=k)


def test_trainer_api():
    net = _net(gt)
    net.initialize(device="cpu")
    tr = gt.Trainer(net.collect_params(), "sgd", kvstore="device")
    assert len(tr._params) == 4 and tr.learning_rate == 0.01
    tr.allreduce_grads()
    tr.step(2)                       # no backward yet: zero gradients
    tr.zero_grad()
    with pytest.raises(ValueError):
        gt.Trainer(net.collect_params(), "sgd",
                   compression_params={"type": "2bit"})
    with pytest.raises(KeyError, match="Unknown optimizer"):
        gt.Trainer(net.collect_params(), "no_such_optimizer")
    with agt.record():
        loss = net(torch.ones(1, 5)).sum()
    loss.backward()
    before = [p.detach().clone() for p in tr._params]
    gt.Trainer(net.collect_params(), "lamb").step(1)
    assert all(not torch.equal(b, p) for b, p in zip(before, tr._params))


def _sched(mod):
    return [mod.FactorScheduler(step=3, factor=0.5, base_lr=0.1,
                                warmup_steps=2, warmup_begin_lr=0.01),
            mod.MultiFactorScheduler(step=[2, 5, 9], factor=0.3,
                                     base_lr=0.2),
            mod.PolyScheduler(max_update=10, base_lr=0.1, pwr=2,
                              final_lr=1e-3, warmup_steps=3,
                              warmup_mode="constant"),
            mod.CosineScheduler(max_update=12, base_lr=0.05, final_lr=0.0,
                                warmup_steps=4)]


def test_schedulers_equal_jax_exactly():
    for sj, st in zip(_sched(lrj), _sched(lrt)):
        assert [st(n) for n in range(15)] == [sj(n) for n in range(15)]


def test_optimizer_reads_its_scheduler_as_in_jax():
    kw = dict(learning_rate=0.1)
    oj = optj.create("adam", lr_scheduler=lrj.FactorScheduler(2, 0.5), **kw)
    ot = optt.create("adam", lr_scheduler=lrt.FactorScheduler(2, 0.5), **kw)
    w = np.ones(4, np.float32)
    wj, wt = ndj.array(w), torch.tensor(w)
    sj = oj.create_state(0, wj)
    st = ot.create_state(0, wt)
    for i in range(5):
        g = np.full(4, 0.1 * (i + 1), np.float32)
        oj.update(0, wj, ndj.array(g), sj)
        ot.update(0, wt, torch.tensor(g), st)
        assert ot.learning_rate == oj.learning_rate
        np.testing.assert_allclose(wt.numpy(), wj.asnumpy(), rtol=1e-6)


def test_fully_connected_promotes_as_jnp_matmul():
    """A float32 input through a bf16 weight: float32 out, the JAX
    package's value; bf16 through bf16 stays bf16."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8).astype(np.float32)
    w = rng.randn(5, 8).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    wb, bb = jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ref = np.asarray(opsj.fully_connected(jnp.asarray(x), wb, bb))
    wt = torch.tensor(w).to(torch.bfloat16)
    bt = torch.tensor(b).to(torch.bfloat16)
    got = nn_ops.fully_connected(torch.tensor(x), wt, bt)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    got_f32_bias = nn_ops.fully_connected(torch.tensor(x), wt,
                                          torch.tensor(b))
    assert got_f32_bias.dtype == torch.float32
    same = nn_ops.fully_connected(torch.tensor(x).to(torch.bfloat16), wt, bt)
    assert same.dtype == torch.bfloat16
    dense = gt.nn.Dense(5, in_units=8, dtype="bfloat16")
    dense.initialize(device="cpu")
    assert dense(torch.tensor(x)).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dropout_scales_kept_values_as_jax(dtype):
    """Where both packages keep an element (their masks are their own
    streams'), the kept value is the same: the JAX package divides by
    the keep rate rounded to the data's dtype (a weak-typed scalar), so
    in bf16 by 0.8984375 for p = 0.1, not by 0.9."""
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.tensor(x).to(getattr(torch, dtype))
    ref = np.asarray(opsj.dropout(xj, 0.1, _training=True), np.float32)
    got = nn_ops.dropout(xt, 0.1, training=True).float().numpy()
    both = (ref != 0) & (got != 0)
    assert both.sum() > 3000
    np.testing.assert_array_equal(got[both], ref[both])
