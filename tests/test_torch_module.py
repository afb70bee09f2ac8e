"""PyTorch port, `mx.mod` (Module, BucketingModule, checkpoints) and
`mx.io` against the JAX package on the CPU (the cases of
`tests/unittest/test_module.py` and `test_io.py` that apply).

`Module.fit` from carried `arg_params` with the same seeded shuffling
gives weights within 1e-5 of the JAX package's after 2 epochs, with SGD
and with Adam (the port's Adam runs `update_multi` over the list, the
JAX package `update` per index). Checkpoints (`-symbol.json`,
`-%04d.params`) and `.states` files written by either package load in
the other and resume to the same weights. `NDArrayIter` gives the JAX
package's batches (pad, discard, the shuffled order after
`np.random.seed`).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import io as io_j
from mxnet_tpu import module as mod_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import symbol as sym_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import io as io_t
from mxnet_tpu_torch import module as mod_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import symbol as sym_t
from mxnet_tpu_torch.ndarray.ndarray import NotPortedError

PKGS = {"jax": (mx, sym_j, nd_j, io_j, mod_j),
        "port": (mxt, sym_t, nd_t, io_t, mod_t)}
TOL = 1e-5


def _mlp_sym(sym, hidden=16, classes=4, bn=False):
    data = sym.Variable("data")
    # before a BatchNorm a bias has a zero gradient (the norm removes
    # it), which Adam would turn into steps of rounding noise: no bias
    h = sym.FullyConnected(data, num_hidden=hidden, name="fc1", no_bias=bn)
    if bn:
        h = sym.BatchNorm(h, name="bn1")
    h = sym.Activation(h, act_type="relu", name="relu1")
    h = sym.FullyConnected(h, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(h, name="softmax", normalization="batch")


def _blob_data(n=64, classes=4, dim=10, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.normal(0, 3.0, (classes, dim))
    y = rs.randint(0, classes, n)
    x = centers[y] + rs.normal(0, 0.5, (n, dim))
    return x.astype(np.float32), y.astype(np.float32)


def _params(bn=False, hidden=16, dim=10, classes=4, seed=1):
    rs = np.random.RandomState(seed)
    p = {"fc1_weight": rs.normal(0, 0.3, (hidden, dim)),
         "fc1_bias": rs.normal(0, 0.1, hidden),
         "fc2_weight": rs.normal(0, 0.3, (classes, hidden)),
         "fc2_bias": rs.normal(0, 0.1, classes)}
    if bn:
        del p["fc1_bias"]
        p.update(bn1_gamma=1 + rs.normal(0, 0.1, hidden),
                 bn1_beta=rs.normal(0, 0.1, hidden))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _arr(pkg, v):
    nd = PKGS[pkg][2]
    return nd.array(v, ctx=mxt.cpu()) if pkg == "port" else nd.array(v)


def _fit(pkg, opt, bn=False, epochs=2, **kw):
    m, sym, _, io, mod = PKGS[pkg]
    x, y = _blob_data()
    np.random.seed(5)
    it = io.NDArrayIter(x, y, batch_size=16, shuffle=True)
    module = mod.Module(_mlp_sym(sym, bn=bn), context=m.cpu(), **kw)
    module.fit(it, num_epoch=epochs, optimizer=opt,
               optimizer_params={"learning_rate": 0.05},
               arg_params={k: _arr(pkg, v) for k, v in _params(bn).items()},
               aux_params={"bn1_moving_mean": _arr(pkg, np.zeros(16)),
                           "bn1_moving_var": _arr(pkg, np.ones(16))}
               if bn else None)
    return module, it


def _params_np(module):
    arg, aux = module.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def _close(a, b, tol=TOL):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("bn", [False, True], ids=["mlp", "mlp-batchnorm"])
def test_fit_two_epochs_equals_jax(opt, bn):
    mj, _ = _fit("jax", opt, bn)
    mt, _ = _fit("port", opt, bn)
    _close(_params_np(mt), _params_np(mj))


def test_fit_converges():
    """The JAX test's end-to-end threshold: the classic fit() reaches
    high accuracy on separable blobs."""
    x, y = _blob_data(256)
    it = io_t.NDArrayIter(x, y, batch_size=32, shuffle=True)
    module = mod_t.Module(_mlp_sym(sym_t, hidden=32), context=mxt.cpu())
    module.fit(it, num_epoch=12, optimizer="sgd",
               optimizer_params={"learning_rate": 0.5},
               initializer=mxt.init.Xavier())
    assert dict(module.score(it, "acc"))["accuracy"] > 0.95


def test_predict_and_score_equal_jax():
    outs = {}
    for pkg in ("jax", "port"):
        module, it = _fit(pkg, "sgd")
        preds = module.predict(it)
        assert preds[0].shape == (64, 4)
        outs[pkg] = (preds[0].asnumpy(), dict(module.score(it, "acc")),
                     dict(module.score(it, "ce")))
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], atol=TOL)
    np.testing.assert_allclose(outs["port"][0].sum(1), np.ones(64),
                               rtol=1e-5)
    assert outs["port"][1] == outs["jax"][1]
    np.testing.assert_allclose(outs["port"][2]["cross-entropy"],
                               outs["jax"][2]["cross-entropy"], rtol=1e-5)


def test_predict_drops_the_padding():
    x, y = _blob_data(20)
    it = io_t.NDArrayIter(x, y, batch_size=8)
    module = mod_t.Module(_mlp_sym(sym_t), context=mxt.cpu())
    module.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    module.init_params()
    assert module.predict(it)[0].shape == (20, 4)
    assert module.predict(it, num_batch=1)[0].shape == (8, 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_and_states_load_both_ways(writer, tmp_path):
    """A checkpoint with optimizer states written by one package, loaded
    by the other: same predictions, and one more Adam epoch from the
    restored states gives the same weights as the writer's own resume."""
    reader = "port" if writer == "jax" else "jax"
    module, it = _fit(writer, "adam")
    prefix = str(tmp_path / "mlp")
    module.save_checkpoint(prefix, 2, save_optimizer_states=True)
    for suffix in ("-symbol.json", "-0002.params", "-0002.states"):
        assert os.path.exists(prefix + suffix)
    res = {}
    for pkg in (writer, reader):
        m, _, _, io, mod = PKGS[pkg]
        x, y = _blob_data()
        it = io.NDArrayIter(x, y, batch_size=16)
        m2 = mod.Module.load(prefix, 2, load_optimizer_states=True,
                             context=m.cpu())
        m2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        m2.init_params()
        pred = m2.predict(it)[0].asnumpy()
        m2.init_optimizer(optimizer="adam",
                          optimizer_params={"learning_rate": 0.05})
        assert m2._opt_states
        for batch in it:
            m2.forward_backward(batch)
            m2.update()
        res[pkg] = (pred, _params_np(m2))
    np.testing.assert_allclose(res[reader][0], res[writer][0], atol=TOL)
    _close(res[reader][1], res[writer][1])


def test_checkpoint_files_are_the_jax_files(tmp_path):
    """The port's .params and -symbol.json equal the JAX package's bytes
    for the same weights."""
    for pkg in ("jax", "port"):
        m, sym, nd, _, mod = PKGS[pkg]
        with m.name.NameManager():
            s = _mlp_sym(sym)
        arg = {k: _arr(pkg, v) for k, v in _params().items()}
        mod.save_checkpoint(str(tmp_path / pkg), 3, s, arg, {})
    for suffix in ("-symbol.json", "-0003.params"):
        assert (tmp_path / f"jax{suffix}").read_bytes() == \
            (tmp_path / f"port{suffix}").read_bytes()


def test_fixed_params_do_not_move():
    x, y = _blob_data()
    it = io_t.NDArrayIter(x, y, batch_size=16)
    module = mod_t.Module(_mlp_sym(sym_t), context=mxt.cpu(),
                          fixed_param_names=["fc1_weight", "fc1_bias"])
    module.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    module.init_params()
    module.init_optimizer(optimizer="sgd",
                          optimizer_params={"learning_rate": 0.5})
    before = module._exec.arg_dict["fc1_weight"].asnumpy().copy()
    fc2 = module._exec.arg_dict["fc2_weight"].asnumpy().copy()
    module.forward_backward(next(iter(it)))
    module.update()
    np.testing.assert_array_equal(
        module._exec.arg_dict["fc1_weight"].asnumpy(), before)
    assert not np.allclose(fc2, module._exec.arg_dict["fc2_weight"]
                           .asnumpy())
    assert module._exec.grad_dict["fc1_weight"] is None


def test_fixed_params_fit_equals_jax():
    kw = {"fixed_param_names": ["fc2_bias"]}
    _close(_params_np(_fit("port", "adam", **kw)[0]),
           _params_np(_fit("jax", "adam", **kw)[0]))


def _bucket_run(pkg, steps=(2, 3, 2)):
    m, sym, nd, io, mod = PKGS[pkg]

    def sym_gen(n_steps):
        data = sym.Variable("data")
        h = sym.reshape(data, shape=(-1, 5))
        h = sym.FullyConnected(h, num_hidden=3, name="fc1")
        return (sym.SoftmaxOutput(h, name="softmax"), ("data",),
                ("softmax_label",))

    bm = mod.BucketingModule(sym_gen, default_bucket_key=2, context=m.cpu())
    bm.bind(data_shapes=[("data", (4, 2, 5))],
            label_shapes=[("softmax_label", (8,))])
    bm.init_params(arg_params={
        "fc1_weight": _arr(pkg, np.random.RandomState(0).normal(
            0, 0.3, (3, 5)).astype(np.float32)),
        "fc1_bias": _arr(pkg, np.zeros(3, np.float32))})
    bm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 0.1})
    rs = np.random.RandomState(1)
    for n in steps:
        b = io.DataBatch(
            data=[_arr(pkg, rs.rand(4, n, 5).astype(np.float32))],
            label=[_arr(pkg, rs.randint(0, 3, 4 * n).astype(np.float32))])
        b.bucket_key = n
        bm.forward_backward(b)
        bm.update()
    return bm


def test_bucketing_module_shares_params_and_equals_jax():
    bt = _bucket_run("port")
    assert set(bt._buckets) == {2, 3}
    assert bt._buckets[2]._exec.arg_dict["fc1_weight"] is \
        bt._buckets[3]._exec.arg_dict["fc1_weight"]
    _close(_params_np(bt), _params_np(_bucket_run("jax")))


def test_forward_default_respects_bind_mode_and_missing_params_raise():
    net = sym_t.BatchNorm(sym_t.Variable("data"), name="bn")
    module = mod_t.Module(net, label_names=None, context=mxt.cpu())
    module.bind(data_shapes=[("data", (8, 4))], for_training=False)
    module.init_params()
    before = module._exec.aux_dict["bn_moving_mean"].asnumpy().copy()
    x = np.random.RandomState(0).normal(5.0, 1.0, (8, 4)).astype(np.float32)
    module.forward(io_t.DataBatch(data=[nd_t.array(x, ctx=mxt.cpu())]))
    np.testing.assert_array_equal(
        module._exec.aux_dict["bn_moving_mean"].asnumpy(), before)
    x, y = _blob_data(32)
    it = io_t.NDArrayIter(x, y, batch_size=16)
    module = mod_t.Module(_mlp_sym(sym_t, hidden=32), context=mxt.cpu())
    module.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    partial = {"fc1_weight": nd_t.zeros((32, 10), ctx=mxt.cpu())}
    with pytest.raises(mxt.MXNetError, match="allow_missing"):
        module.init_params(arg_params=partial)
    module.init_params(arg_params=partial, allow_missing=True,
                       force_init=True)
    np.testing.assert_array_equal(
        module._exec.arg_dict["fc1_weight"].asnumpy(), 0)
    with pytest.raises(mxt.MXNetError, match="num_epoch"):
        module.fit(it)


def test_module_context_none_is_the_card():
    """`Module(context=None)` resolves to the card (the JAX package
    ignores `context`); an explicit mx.cpu() runs on the CPU."""
    x, y = _blob_data(16)
    it = io_t.NDArrayIter(x, y, batch_size=16)
    m = mod_t.Module(_mlp_sym(sym_t), context=mxt.cpu())
    m.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    assert m._exec._device.type == "cpu"
    if not torch.cuda.is_available():
        m = mod_t.Module(_mlp_sym(sym_t))
        with pytest.raises(RuntimeError):
            m.bind(data_shapes=it.provide_data,
                   label_shapes=it.provide_label)


def test_fit_runs_the_callbacks(tmp_path, caplog):
    import logging
    x, y = _blob_data()
    it = io_t.NDArrayIter(x, y, batch_size=16)
    val = io_t.NDArrayIter(*_blob_data(32, seed=1), batch_size=16)
    module = mod_t.Module(_mlp_sym(sym_t), context=mxt.cpu())
    seen = []
    prefix = str(tmp_path / "cb")
    with caplog.at_level(logging.INFO):
        module.fit(it, eval_data=val, num_epoch=2, optimizer="sgd",
                   optimizer_params={"learning_rate": 0.1},
                   initializer=mxt.init.Xavier(),
                   batch_end_callback=[mxt.callback.Speedometer(16, 2),
                                       mxt.callback.log_train_metric(2),
                                       lambda p: seen.append(p.nbatch)],
                   epoch_end_callback=lambda e, s, a, x_: mod_t
                   .save_checkpoint(prefix, e + 1, s, a, x_))
    assert seen == [0, 1, 2, 3] * 2
    assert os.path.exists(prefix + "-0002.params")
    text = caplog.text
    assert "Speed:" in text and "Validation-accuracy" in text
    save = mxt.callback.do_checkpoint(str(tmp_path / "dc"))
    save(0, module=module)
    assert os.path.exists(str(tmp_path / "dc") + "-0001.params")


# -- io --------------------------------------------------------------------

def _batches(pkg, it):
    return [([d.asnumpy() for d in b.data], [l.asnumpy() for l in b.label],
             b.pad) for b in it]


@pytest.mark.parametrize("kw", [{}, {"last_batch_handle": "discard"},
                                {"shuffle": True}],
                         ids=["pad", "discard", "shuffle"])
def test_ndarray_iter_equals_jax(kw):
    X = np.random.RandomState(0).normal(size=(10, 3)).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    out = {}
    for pkg in ("jax", "port"):
        io = PKGS[pkg][3]
        np.random.seed(7)
        it = io.NDArrayIter(X, y, batch_size=4, **kw)
        out[pkg] = (_batches(pkg, it), it.provide_data, it.provide_label)
        it.reset()
        out[pkg] += (_batches(pkg, it),)
    assert len(out["port"][0]) == (2 if kw.get("last_batch_handle") else 3)
    for a, b in zip(out["port"][0] + out["port"][3],
                    out["jax"][0] + out["jax"][3]):
        for x, z in zip(a[0] + a[1], b[0] + b[1]):
            np.testing.assert_array_equal(x, z)
        assert a[2] == b[2]
    assert [tuple(d) for d in out["port"][1]] == \
        [tuple(d) for d in out["jax"][1]]
    assert [tuple(d) for d in out["port"][2]] == \
        [tuple(d) for d in out["jax"][2]]


def test_iter_batches_are_host_arrays_and_multi_input():
    it = io_t.NDArrayIter({"a": np.zeros((4, 2)), "b": np.ones((4, 3))},
                          np.zeros(4), batch_size=2)
    b = next(it)
    assert [d.shape for d in b.data] == [(2, 2), (2, 3)]
    assert all(d.context.device_type == "cpu" for d in b.data + b.label)
    assert [d.name for d in it.provide_data] == ["a", "b"]


def test_resize_prefetch_csv_and_mnist(tmp_path):
    X = np.random.normal(size=(8, 2)).astype(np.float32)
    resized = io_t.ResizeIter(io_t.NDArrayIter(X, np.zeros(8), batch_size=4),
                              5)
    assert len(list(resized)) == 5
    pf = io_t.PrefetchingIter(io_t.NDArrayIter(X, np.zeros(8), batch_size=4))
    assert len(list(pf)) == 2
    pf.reset()
    assert len(list(pf)) == 2
    assert pf.provide_data[0].shape == (4, 2)
    path = str(tmp_path / "d.csv")
    np.savetxt(path, np.arange(24).reshape(6, 4), delimiter=",")
    outs = []
    for io in (io_j, io_t):
        it = io.CSVIter(data_csv=path, data_shape=(2, 2), batch_size=4)
        outs.append(_batches(None, it))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a[0][0], b[0][0])
        assert a[2] == b[2]
    mj = io_j.MNISTIter(image=str(tmp_path / "t10k-images"), batch_size=32,
                        flat=True)
    mt = io_t.MNISTIter(image=str(tmp_path / "t10k-images"), batch_size=32,
                        flat=True)
    bj, bt = next(mj), next(mt)
    np.testing.assert_array_equal(bt.data[0].asnumpy(), bj.data[0].asnumpy())
    np.testing.assert_array_equal(bt.label[0].asnumpy(),
                                  bj.label[0].asnumpy())


def test_record_and_libsvm_iters_are_not_ported_yet():
    with pytest.raises(NotPortedError, match="The facades"):
        io_t.ImageRecordIter(path_imgrec="x.rec", data_shape=(3, 8, 8),
                             batch_size=4)
    with pytest.raises(NotPortedError, match="Left for later PRs"):
        io_t.LibSVMIter(data_libsvm="x", data_shape=(4,), batch_size=2)
