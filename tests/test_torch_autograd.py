"""PyTorch port, autograd: the recording and training scopes, backward
with MXNet's grad_req semantics and `autograd.grad`, against the JAX
package's `mxnet_tpu.autograd` on the CPU.

Flags are compared exactly. Gradients of a small Dense net (weights
carried from the JAX package by name) are compared at 1e-6 (float32,
one GEMM of a few elements in another order).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as agj
from mxnet_tpu import gluon as gj
from mxnet_tpu import nd as ndj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import gluon as gt
from mxnet_tpu_torch import nd, weights
from mxnet_tpu_torch.gluon.block import training

CPU = mxt.cpu()


def _flags(ag):
    return ag.is_recording(), ag.is_training()


def test_scope_flags_match_jax():
    seen = {}
    for name, ag in (("jax", agj), ("port", agt)):
        out = [_flags(ag)]
        with ag.record():
            out.append(_flags(ag))
            with ag.pause():
                out.append(_flags(ag))
                with ag.train_mode():
                    out.append(_flags(ag))
            with ag.predict_mode():
                out.append(_flags(ag))
            out.append(_flags(ag))
        with ag.record(train_mode=False):
            out.append(_flags(ag))
        with ag.train_mode():
            out.append(_flags(ag))
        out.append(_flags(ag))
        seen[name] = out
    assert seen["port"] == seen["jax"]


def test_record_and_pause_set_torch_grad_mode_and_restore_it():
    assert torch.is_grad_enabled()
    with agt.record():
        assert torch.is_grad_enabled()
        with agt.pause():
            assert not torch.is_grad_enabled()
        assert torch.is_grad_enabled()
    with torch.no_grad():
        with agt.record():
            assert torch.is_grad_enabled()
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled() and not agt.is_recording()


def test_the_scope_decides_the_training_mode_else_the_block():
    drop = gt.nn.Dropout(0.5)
    x = torch.ones(2000)
    assert torch.equal(drop(x), x)                    # a block starts in eval
    with agt.record():
        assert training(drop)
        y = drop(x)
        assert 0.3 < float((y == 0).float().mean()) < 0.7
        assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    with agt.record(train_mode=False):
        assert torch.equal(drop(x), x)
    drop.train()
    assert training(drop) and not torch.equal(drop(x), x)
    with agt.predict_mode():
        assert torch.equal(drop(x), x)
    assert agt.set_training(False) is None            # no flag was set
    assert torch.equal(drop(x), x)
    assert agt.set_training(None) is False
    assert training(drop)


def _dense_pair(seed=0):
    jnet = gj.nn.Dense(3, in_units=4)
    jnet.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = gt.nn.Dense(3, in_units=4)
    weights.load_named_arrays(tnet, arrays)
    x = np.random.RandomState(seed).randn(5, 4).astype(np.float32)
    return jnet, tnet, x


def _jgrads(net):
    return {k: np.asarray(p.grad()._data)
            for k, p in net.collect_params().items()}


def _tgrads(net):
    return {k: p.grad.numpy() for k, p in net.collect_params().items()}


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_write_replaces_and_add_sums_as_in_jax(grad_req):
    jnet, tnet, x = _dense_pair()
    jnet.collect_params().setattr("grad_req", grad_req)
    for p in jnet.collect_params().values():
        p.data().grad_req = grad_req
    tnet.collect_params().setattr("grad_req", grad_req)
    for scale in (1.0, 3.0):
        with agj.record():
            lj = (jnet(ndj.array(x)) * scale).sum()
        lj.backward()
        with agt.record():
            lt = (tnet(nd.array(x, ctx=CPU)) * scale).sum()
        lt.backward()
        _close(_tgrads(tnet), _jgrads(jnet))
    jnet.collect_params().zero_grad()
    tnet.collect_params().zero_grad()
    _close(_tgrads(tnet), _jgrads(jnet))
    assert all(not g.any() for g in _tgrads(tnet).values())


def test_parameters_record_only_under_record():
    _, tnet, x = _dense_pair()
    out = tnet(torch.from_numpy(x))
    assert not out.requires_grad                     # serving: no graph
    assert all(not p.requires_grad for p in tnet.parameters())
    with agt.record():
        out = tnet(torch.from_numpy(x))
    assert out.requires_grad
    assert all(p.requires_grad for p in tnet.parameters())


def test_autograd_grad_and_head_grads_match_jax():
    x = np.array([[0.5, -1.0, 2.0]], np.float32)
    g = np.array([[1.0, 2.0, -1.0]], np.float32)
    jx, tx = ndj.array(x), nd.array(x, ctx=CPU)
    jx.attach_grad()
    tx.attach_grad()
    with agj.record():
        jy = jx * jx * jx
    with agt.record():
        ty = tx * tx * tx
    (gj_,) = agj.grad(jy, [jx], head_grads=[ndj.array(g)])
    (gt_,) = agt.grad(ty, [tx], head_grads=[nd.array(g, ctx=CPU)])
    np.testing.assert_allclose(gt_.asnumpy(), gj_.asnumpy(), rtol=1e-6)
    assert not tx.grad.asnumpy().any()               # .grad left alone
    jnet, tnet, xs = _dense_pair(1)
    with agj.record():
        lj = jnet(ndj.array(xs)).sum()
    with agt.record():
        lt = tnet(nd.array(xs, ctx=CPU)).sum()
    wj = jnet.collect_params()["weight"].data()
    wt = tnet.collect_params()["weight"]
    np.testing.assert_allclose(agt.grad(lt, [wt])[0].asnumpy(),
                               agj.grad(lj, [wj])[0].asnumpy(), rtol=1e-6)


def test_mark_variables_writes_into_the_given_buffer():
    x = nd.array([1.0, -2.0], ctx=CPU)
    gx = nd.zeros((2,), ctx=CPU)
    agt.mark_variables(x, gx)
    for _ in range(2):
        with agt.record():
            y = (x * x).sum()
        agt.backward(y)
    np.testing.assert_array_equal(gx.asnumpy(), [2.0, -4.0])
    assert x.grad is gx
    agt.mark_variables([x], [gx], "add")
    with agt.record():
        y = (x * 3).sum()
    y.backward()
    np.testing.assert_array_equal(gx.asnumpy(), [5.0, -1.0])
