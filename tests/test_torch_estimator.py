"""PyTorch port, `gluon.contrib` (the Estimator fit loop, the contrib
layers and cells) and `resilience.save_estimator` / `restore_estimator`
against `mxnet_tpu` on the CPU, float32, inputs from numpy seeds,
weights carried by `weights.load_named_arrays`.

  * `Estimator.fit` of a small MLP for 2 epochs (SGD, a DataLoader, so
    the loop runs through `prefetch_to_mesh` in both packages) gives the
    JAX package's per-batch mean losses and metric values within 1e-5
    (absolute; float32 GEMMs reduce in other orders).
  * A fit interrupted after epoch 1 and resumed from its checkpoint ends
    bit-equal to an uninterrupted one in the port (SGD with momentum),
    with dropout drawing from the restored random streams.
  * PixelShuffle1D/2D/3D equal the JAX package's bit for bit; LSTMPCell
    and Conv2DLSTMCell on the same weights within 1e-6; a
    VariationalDropoutCell keeps one mask a sequence.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import metric as metric_j
from mxnet_tpu import nd as nd_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as autograd_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import metric as metric_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import random as random_t
from mxnet_tpu_torch import resilience as resilience_t
from mxnet_tpu_torch import weights


def _mlp(gluon, dropout=0.0):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=6))
    if dropout:
        net.add(gluon.nn.Dropout(dropout))
    net.add(gluon.nn.Dense(3, in_units=16))
    return net


def _dataset(gluon):
    rng = np.random.RandomState(7)
    x = rng.randn(24, 6).astype(np.float32)
    y = rng.randint(0, 3, 24).astype(np.float32)
    return gluon.data.ArrayDataset(x, y)


def _fit(gluon, metric, est_mod, net, epochs=2):
    seen = []

    class Record(est_mod.BatchEnd):
        def batch_end(self, est):
            seen.append([float(est.last_loss.mean().asscalar())]
                        + [float(m.get()[1]) for m in est.train_metrics])
    est = est_mod.Estimator(
        net, gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=[metric.Accuracy(), metric.Loss("loss")],
        optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    est.fit(gluon.data.DataLoader(_dataset(gluon), batch_size=4),
            epochs=epochs, event_handlers=[Record()])
    return est, seen


def test_estimator_fit_matches_jax_per_batch():
    from mxnet_tpu.gluon.contrib import estimator as est_j
    from mxnet_tpu_torch.gluon.contrib import estimator as est_t
    mx.random.seed(0)
    jnet = _mlp(gluon_j)
    jnet.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    ej, want = _fit(gluon_j, metric_j, est_j, jnet)
    with mxt.cpu():
        tnet = _mlp(gluon_t)
        weights.load_named_arrays(tnet, arrays)
        et, got = _fit(gluon_t, metric_t, est_t, tnet)
    assert et.num_epoch == ej.num_epoch == 2
    assert et.num_batch == ej.num_batch == 12
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for name, p in jnet.collect_params().items():
        np.testing.assert_allclose(
            tnet.collect_params()[name].data().asnumpy(),
            np.asarray(p.data()._data), atol=1e-5, rtol=0, err_msg=name)


def _resumable(seed=3):
    from mxnet_tpu_torch.gluon.contrib import estimator as est_t
    with mxt.cpu():
        random_t.seed(seed, "cpu")
        net = _mlp(gluon_t, dropout=0.3)
        net.initialize()
    # SGD with momentum: a gluon Trainer's states file holds the momenta
    # but not the optimizer's update counts, in both packages, so Adam's
    # bias correction would restart after a resume
    return est_t.Estimator(
        net, gluon_t.loss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9})


def test_estimator_resume_is_bit_exact(tmp_path):
    loader = gluon_t.data.DataLoader(_dataset(gluon_t), batch_size=4)
    with mxt.cpu():
        ref = _resumable()
        random_t.seed(11, "cpu")
        ref.fit(loader, epochs=3)
        cd = str(tmp_path / "fit")
        a = _resumable()
        random_t.seed(11, "cpu")
        a.fit(loader, epochs=1, checkpoint_dir=cd)
        assert [s for s, _ in resilience_t.list_checkpoints(cd)] == [1]
        random_t.seed(99, "cpu")       # the relaunch starts elsewhere
        b = _resumable(seed=5)
        b.fit(loader, epochs=3, resume="auto", checkpoint_dir=cd)
    assert b.num_epoch == 3 and b.num_batch == ref.num_batch == 18
    assert resilience_t.last_resume()["step"] == 1
    for name, p in ref.net.collect_params().items():
        assert torch.equal(b.net.collect_params()[name].data()._t,
                           p.data()._t), name


@pytest.mark.parametrize("cls,shape,factor", [
    ("PixelShuffle1D", (2, 6, 5), 3),
    ("PixelShuffle2D", (2, 8, 3, 5), (2, 2)),
    ("PixelShuffle3D", (1, 16, 2, 3, 2), 2)])
def test_pixel_shuffle_equals_jax(cls, shape, factor):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = getattr(gluon_j.contrib.nn, cls)(factor)(nd_j.array(x))
    got = getattr(gluon_t.contrib.nn, cls)(factor)(nd_t.array(x, ctx="cpu"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def _cell_pair(make, x):
    jc = make(gluon_j.contrib.rnn)
    mx.random.seed(2)
    jc.initialize()
    with mxt.cpu():
        tc = make(gluon_t.contrib.rnn)
        weights.load_named_arrays(tc, {
            k: np.asarray(p.data()._data)
            for k, p in jc.collect_params().items()})
        out_t, st_t = tc.unroll(x.shape[1], nd_t.array(x, ctx="cpu"))
    out_j, st_j = jc.unroll(x.shape[1], nd_j.array(x))
    for a, b in zip([out_t] + list(st_t), [out_j] + list(st_j)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), atol=1e-6,
                                   rtol=0)


def test_lstmp_cell_equals_jax():
    x = np.random.RandomState(4).randn(3, 5, 4).astype(np.float32)
    _cell_pair(lambda m: m.LSTMPCell(16, 6, input_size=4), x)


def test_conv2d_lstm_cell_equals_jax():
    x = np.random.RandomState(5).randn(2, 3, 2, 6, 6).astype(np.float32)
    _cell_pair(lambda m: m.Conv2DLSTMCell((2, 6, 6), 4), x)


def test_variational_dropout_keeps_one_mask_a_sequence():
    with mxt.cpu():
        random_t.seed(0, "cpu")
        base = gluon_t.rnn.RNNCell(8, input_size=4)
        cell = gluon_t.contrib.rnn.VariationalDropoutCell(
            base, drop_inputs=0.5, drop_states=0.5)
        base.initialize()
        x = nd_t.ones((64, 4), ctx="cpu")
        states = cell.begin_state(64, ctx="cpu")
        with autograd_t.record():
            cell(x, states)
            a = cell._input_mask.asnumpy()
            cell(x, states)
            b = cell._input_mask.asnumpy()
        np.testing.assert_array_equal(a, b)
        assert set(np.unique(a)) == {0.0, 2.0}
        cell.reset()
        assert cell._input_mask is None
        cell(x, states)                 # not training: no mask drawn
        assert cell._input_mask is None
