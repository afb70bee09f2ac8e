"""PyTorch port, `mx.monitor.Monitor`, `gluon.SymbolBlock` and the
`mx.name` scopes against the JAX package on the CPU (the cases of
`tests/unittest/test_monitor.py` and `test_name_runtime.py` that apply).

The Module path's monitor rows (outputs, parameters, gradients) equal
the JAX package's names and statistics within 1e-5 on carried weights;
on a gluon block the rows follow the interval and the pattern, and a
second install adds no hook. `SymbolBlock.imports` of a symbol and
`.params` file written by the JAX package gives the JAX SymbolBlock's
outputs within 1e-5, BatchNorm's statistics included.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu.gluon.symbol_block import SymbolBlock as SymbolBlock_j
from mxnet_tpu import io as io_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import sym as sym_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import gluon
from mxnet_tpu_torch import io as io_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import sym as sym_t
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn

CPU = mxt.cpu()


def _hooks(net):
    return sum(len(b._forward_hooks) for b in [net] + list(net.children()))


def test_monitor_gluon_interval_and_stats():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=3), nn.Dense(2,
                                                                 in_units=8))
    net.initialize()
    mon = mxt.monitor.Monitor(interval=2)
    mon.install(net)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    lfn = gloss.SoftmaxCrossEntropyLoss()
    x = nd_t.array(np.random.RandomState(0).rand(4, 3), ctx=CPU)
    y = nd_t.array(np.array([0, 1, 0, 1], np.float32), ctx=CPU)
    seen = []
    for step in range(4):
        assert mon.tic() == (step % 2 == 0)
        with autograd.record():
            loss = lfn(net(x), y).mean()
        loss.backward()
        tr.step(1)
        rows = mon.toc()
        seen.append(rows)
    assert seen[1] == [] and seen[3] == []
    names = [r[1] for r in seen[2]]
    assert "hybridsequential.0" in names and "hybridsequential" in names
    assert "0.weight" in names and "0.weight_grad" in names
    assert all(float(r[2]) >= 0 for r in seen[2])


def test_monitor_install_idempotent_and_pattern():
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
    net.initialize()
    mon = mxt.monitor.Monitor(interval=1, monitor_gradient=False)
    mon.install(net)
    mon.tic()
    net(nd_t.ones((2, 3), ctx=CPU))
    baseline = len(mon.toc())
    n_hooks = _hooks(net)
    mon.install(net)                        # a no-op
    assert _hooks(net) == n_hooks
    mon.tic()
    net(nd_t.ones((2, 3), ctx=CPU))
    assert len(mon.toc()) == baseline
    net.add(nn.Dense(3, in_units=2))        # a child added later is hooked
    mon.install(net)
    assert len(list(net.children())[-1]._forward_hooks) == 1
    shared = nn.Dense(4, in_units=4)
    net2 = nn.HybridSequential()
    net2.add(shared, shared)
    net2.initialize()
    mon2 = mxt.monitor.Monitor(interval=1, pattern=".*weight.*",
                               monitor_gradient=False)
    mon2.install(net2)
    assert len(shared._forward_hooks) == 1   # torch lists a child once
    mon2.tic()
    net2(nd_t.ones((2, 4), ctx=CPU))
    rows = mon2.toc()
    assert rows and all("weight" in r[1] for r in rows)


def _module_rows(pkg):
    m, sym, nd, io = ((mx, sym_j, nd_j, io_j) if pkg == "jax"
                      else (mxt, sym_t, nd_t, io_t))
    with m.name.NameManager():
        data = sym.var("data")
        h = sym.FullyConnected(data, num_hidden=4, name="fc1")
        out = sym.SoftmaxOutput(h, name="softmax", normalization="batch")
    mod = m.mod.Module(out, context=m.cpu())
    x = np.random.RandomState(1).rand(8, 3).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 4, 8).astype(np.float32)
    it = io.NDArrayIter(x, y, batch_size=8)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    rs = np.random.RandomState(3)
    kw = {"ctx": CPU} if pkg == "port" else {}
    mod.init_params(arg_params={
        "fc1_weight": nd.array(rs.normal(0, 0.5, (4, 3)), **kw),
        "fc1_bias": nd.array(rs.normal(0, 0.5, 4), **kw)})
    mon = m.monitor.Monitor(interval=1)
    mod.install_monitor(mon)
    batch = next(iter(it))
    mon.tic()
    mod.forward(batch, is_train=True)
    mod.backward()
    mon.activated = True                    # the backward's grads too
    mod.forward(batch, is_train=True)
    return mon.toc()


def test_monitor_module_path_equals_jax():
    rj, rt = _module_rows("jax"), _module_rows("port")
    assert [r[:2] for r in rt] == [r[:2] for r in rj]
    names = [r[1] for r in rt]
    assert any("fc1" in n for n in names)
    assert any(n.endswith("_grad") for n in names)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(float(a[2]), float(b[2]), rtol=1e-5)


def _jax_export(tmp_path):
    """A symbol with BatchNorm and its .params written by the JAX
    package."""
    with mx.name.NameManager():
        data = sym_j.var("data")
        h = sym_j.Convolution(data, kernel=(3, 3), num_filter=4,
                              name="conv")
        h = sym_j.BatchNorm(h, name="bn")
        h = sym_j.Activation(h, act_type="relu")
        out = sym_j.FullyConnected(h, num_hidden=3, name="fc")
    out.save(str(tmp_path / "net-symbol.json"))
    shapes, _, aux = out.infer_shape(data=(2, 2, 6, 6))
    rs = np.random.RandomState(0)
    params = {f"arg:{n}": nd_j.array(rs.normal(0, 0.3, s).astype(np.float32))
              for n, s in zip(out.list_arguments(), shapes) if n != "data"}
    params.update({f"aux:{n}": nd_j.array(
        (rs.rand(*s) + 0.5).astype(np.float32))
        for n, s in zip(out.list_auxiliary_states(), aux)})
    nd_j.save(str(tmp_path / "net-0000.params"), params)
    return str(tmp_path / "net-symbol.json"), str(tmp_path / "net-0000.params")


def test_symbol_block_imports_a_jax_export(tmp_path):
    sym_file, param_file = _jax_export(tmp_path)
    x = np.random.RandomState(1).normal(size=(2, 2, 6, 6)).astype(np.float32)
    bj = SymbolBlock_j.imports(sym_file, ["data"], param_file)
    bt = gluon.SymbolBlock.imports(sym_file, ["data"], param_file, ctx=CPU)
    ref = bj(nd_j.array(x)).asnumpy()
    got = bt(nd_t.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    names = sorted(bt.collect_params())
    assert names == sorted(bj.collect_params())
    assert bt.collect_params()["bn_moving_mean"].grad_req == "null"
    # training mode: batch statistics, and the moving ones written back
    with ag_j.record():
        rj = bj(nd_j.array(x))
    with autograd.record():
        rt = bt(nd_t.array(x, ctx=CPU))
    np.testing.assert_allclose(rt.asnumpy(), rj.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    rt.backward()
    assert bt.collect_params()["fc_weight"].grad is not None
    mj = bj.collect_params()["bn_moving_mean"].data().asnumpy()
    mt = bt.collect_params()["bn_moving_mean"].detach().numpy()
    np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=1e-6)


def test_symbol_block_creates_missing_params_at_first_forward():
    data = sym_t.var("data")
    out = sym_t.FullyConnected(data, num_hidden=5, name="fc")
    blk = gluon.SymbolBlock(out, data)
    with pytest.raises(mxt.MXNetError, match="initialize"):
        blk(nd_t.ones((2, 3), ctx=CPU))
    blk.initialize(init="xavier")
    y = blk(nd_t.ones((2, 3), ctx=CPU))
    assert y.shape == (2, 5)
    assert blk.fc_weight.shape == (5, 3)
    np.testing.assert_array_equal(blk.fc_bias.detach().numpy(), 0)


def test_name_scopes():
    data = sym_t.var("data")
    with mxt.name.Prefix("mlp_"):
        h = sym_t.FullyConnected(data, num_hidden=4)
    assert h.name.startswith("mlp_fullyconnected")
    assert not sym_t.FullyConnected(data, num_hidden=4).name \
        .startswith("mlp_")
    with mxt.name.NameManager():
        a, b = sym_t.relu(data), sym_t.relu(data)
    assert (a.name, b.name) == ("relu0", "relu1")
    with mxt.name.Prefix("outer_"):
        with mxt.name.Prefix("inner_"):
            assert sym_t.relu(data).name.startswith("inner_")
    with mxt.AttrScope(group="4"):
        v = sym_t.var("v")
    assert v.attr("group") == "4" and sym_t.var("w").attr("group") is None
    with pytest.raises(ValueError):
        mxt.AttrScope(group=4)
