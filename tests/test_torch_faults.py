"""PyTorch port, ROADMAP.md queue 3 faults 10-12, each call made the
same way on both packages (JAX keywords and positions) on the CPU.

Fault 10: `ShardedTrainer(net, loss)` trains with SGD, the JAX default,
and takes the JAX package's keywords at their defaults (`donate=True`,
`data_specs` / `label_specs` None or all None); two default steps from
the same weights give weights within 1e-6 (absolute, float32) of the
JAX package's. Fault 11: `hasattr` / `getattr(..., None)` of an unknown
name on an NDArray and on `nd` are False / None, as in the JAX package,
and the not-ported error is still a NotImplementedError naming its
queue item. Fault 12: `Block.initialize(init, ctx, verbose,
force_reinit)` and `GPTForCausalLM.generate(..., seed, on_device,
num_beams)` in the JAX order: the same parameters, the same greedy
tokens.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import parallel as parallel_j
from mxnet_tpu.models import gpt as gpt_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import gpt as gpt_t

CPU = mxt.cpu()


def _mlp(gluon, **kw):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=6),
            gluon.nn.Dense(3, in_units=16))
    return net


def _batch():
    x = np.random.RandomState(0).randn(8, 6).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, 8).astype(np.float32)
    return x, y


@pytest.fixture
def mesh():
    parallel_j.make_mesh(dp=-1)
    yield
    parallel_j.set_mesh(None)


def _start():
    with mxt.cpu():
        tn = _mlp(gluon_t)
        tn.initialize()
    return tn, {k: p.detach().numpy().copy()
                for k, p in tn.collect_params().items()}


def _jax_from(arrays):
    jn = _mlp(gluon_j)
    for k, p in jn.collect_params().items():
        p.initialize()
        p.set_data(nd_j.array(arrays[k]))
    return jn


def test_fault10_default_optimizer_is_sgd_like_jax(mesh):
    tn, arrays = _start()
    jn = _jax_from(arrays)
    lj = gluon_j.loss.SoftmaxCrossEntropyLoss()
    lt = gluon_t.loss.SoftmaxCrossEntropyLoss()
    jt = parallel_j.ShardedTrainer(jn, lambda o, l: lj(o, l))
    tt = parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l), device="cpu")
    assert type(tt._opt).__name__ == type(jt._opt).__name__ == "SGD"
    x, y = _batch()
    for _ in range(2):
        lj_ = float(jt.step([nd_j.array(x)], [nd_j.array(y)]).asscalar())
        lt_ = float(tt.step([x], [y]).asscalar())
        assert abs(lj_ - lt_) <= 1e-6
    assert tt._names == jt._names
    for name, w_j, w_t in zip(jt._names, jt.params, tt.params):
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                                   atol=1e-6, err_msg=name)
        assert not np.array_equal(w_t.numpy(), arrays[name])


@pytest.mark.parametrize("kw", [
    {"donate": True}, {"donate": False},
    {"data_specs": None, "label_specs": None},
    {"data_specs": [None, None], "label_specs": [None]},
    {"param_mode": "replicate", "mesh": None}])
def test_fault10_jax_keywords_at_their_defaults(mesh, kw):
    for pkg, gluon, extra in ((parallel_j, gluon_j, {}),
                              (parallel_t, gluon_t, {"device": "cpu"})):
        with mxt.cpu():
            net = _mlp(gluon)
            net.initialize()
        lfn = gluon.loss.SoftmaxCrossEntropyLoss()
        pkg.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd", None,
                           **kw, **extra)


def test_fault10_positional_order_and_multi_device_specs():
    tn, _ = _start()
    lt = gluon_t.loss.SoftmaxCrossEntropyLoss()
    tr = parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l), "sgd", None,
                                   None, "replicate", True, None, None,
                                   "cpu")
    assert tr.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l),
                                  data_specs=[("dp", "fsdp"), None],
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="Multi-device"):
        parallel_t.ShardedTrainer(tn, lambda o, l: lt(o, l),
                                  label_specs=[("dp",)], device="cpu")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fault11_hasattr_of_unknown_names(pkg):
    nd = nd_j if pkg == "jax" else nd_t
    x = nd.array([1.0, 2.0]) if pkg == "jax" else nd.array([1.0, 2.0],
                                                           ctx=CPU)
    assert hasattr(x, "no_such_name") is False
    assert hasattr(nd, "no_such_name") is False
    assert getattr(nd, "no_such_name", None) is None
    assert getattr(x, "no_such_name", None) is None
    assert hasattr(x, "transpose") and hasattr(nd, "transpose")


def test_fault11_not_ported_still_names_the_item():
    x = nd_t.array([1.0, 2.0], ctx=CPU)
    for obj, name in ((x, "smooth_l1"), (nd_t, "smooth_l1")):
        with pytest.raises(NotImplementedError,
                           match="The eager MXNet surface"):
            getattr(obj, name)
        with pytest.raises(AttributeError):
            getattr(obj, name)


def _bn_net(gluon):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=3), gluon.nn.BatchNorm(in_channels=4))
    return net


def test_fault12_initialize_in_the_jax_order():
    """init, ctx, verbose, force_reinit by position on both packages:
    the same parameters (the name rule of "zeros": gammas and running
    variances 1, the rest 0), a second call without force_reinit leaves
    them, and force_reinit (4th) redraws."""
    jn, tn = _bn_net(gluon_j), _bn_net(gluon_t)
    jn.initialize("zeros", mx.cpu(), False, False)
    tn.initialize("zeros", mxt.cpu(), False, False)
    jp, tp = jn.collect_params(), tn.collect_params()
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k].data()._data))
    for net in (jn, tn):
        net.initialize("ones", ctx=None, verbose=True)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k].data()._data))
    jn.initialize("ones", None, False, True)
    tn.initialize("ones", None, False, True)
    for k in jp:
        np.testing.assert_array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k].data()._data))
    assert float(tp["0.weight"].sum()) == 12.0
    assert all(p.device.type == "cpu" for p in tn.parameters())
    with pytest.raises(TypeError, match="ctx or device"):
        tn.initialize(ctx=mxt.cpu(), device="cpu")


def test_fault12_generate_on_device_in_the_jax_position():
    parallel_j.make_mesh(dp=-1)
    try:
        jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
        mx.random.seed(0)
        jm.initialize()
        arrays = {k: np.asarray(p.data()._data)
                  for k, p in jm.collect_params().items()}
        tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
        weights.load_named_arrays(tm, arrays)
        prompt = np.random.RandomState(3).randint(0, 128, (2, 7)) \
            .astype(np.int32)
        # prompt, max_new_tokens, eos, temperature, top_k, seed, on_device
        ref = np.asarray(jm.generate(prompt, 6, None, 0.0, 0, 0, True))
        for on_device in (True, False):
            got = tm.generate(prompt, 6, None, 0.0, 0, 0, on_device)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                tm.generate(prompt, max_new_tokens=6, on_device=on_device,
                            num_beams=1), ref)
        np.testing.assert_array_equal(
            np.asarray(jm.generate(prompt, 6, None, 0.0, 0, 0, False)), ref)
    finally:
        parallel_j.set_mesh(None)
