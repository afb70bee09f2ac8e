"""PyTorch port, `gluon.model_zoo`: every family against the JAX
package's `mxnet_tpu.gluon.model_zoo` on the CPU, float32
(`tests/unittest/test_model_zoo.py` case by case, then parity).

Parity, one case a family (`check_family`): the port's net, seeded and
initialised with "xavier" as `examples/image_classification/
train_cifar10.py` does, resolves its shapes on one forward; its weights
carry to the JAX net by name (`Parameter.set_data`; the paths are the
same). Dropout is set to rate 0 in both nets (the two packages draw
other masks). In the nets with a BatchNorm after every convolution
(VGG-BN, MobileNet v1 and v2, DenseNet, Inception-v3) the BatchNorms
normalise by their running statistics in the step
(`use_global_stats`): with batch statistics, a float32 gradient of
these nets at batch 8 is itself 1-5% away from the float64 gradient of
the same net (port, measured), so neither package is a reference for
the other there. The ResNet factories return `models.resnet`'s nets,
whose forward, BatchNorm statistics and SGD steps with batch
statistics `test_torch_resnet.py` and `test_torch_sgd.py` hold against
the JAX package (resnet18_v1 here: its parameter paths and forward
shapes). Then, on a seeded batch of 8 (which the JAX trainer's 8-device
CPU test mesh divides):
  * the evaluation-mode logits (JAX: `hybridize()`);
  * one SGD step (lr 0.01, momentum 0.9, wd 1e-4): the port through the
    example's eager loop (`autograd.record()`, `loss.mean().backward()`,
    `gluon.Trainer.step(1)`), the JAX package through its jitted
    `parallel.ShardedTrainer` step (the JAX eager loop compiles op by op:
    minutes a family on the CPU). The loss, every weight after the step
    and every running statistic.
Tolerance `TOL`: the largest difference over the largest |value| of the
JAX tensor, 1e-4 (float32; convolutions, batch statistics and the
backward reduce in other orders). DenseNet is held as `DenseNet(16, 8,
(2, 2))` and Inception-v3 at its smallest input, 75 x 75: the JAX side
of densenet121 and of inceptionv3 at 96 compiles for minutes (the JAX
file marks them slow); both full nets run through the port in
`test_zoo_forward_shapes`. This file holds AlexNet, SqueezeNet,
MobileNet v1 and DenseNet; `test_torch_model_zoo_deep.py` VGG,
MobileNet v2 and Inception-v3, so that xdist spreads the files.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, parallel
from mxnet_tpu.gluon import loss as loss_j
from mxnet_tpu.gluon.model_zoo import get_model as get_j
from mxnet_tpu.gluon.model_zoo import vision as vision_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as autograd_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.gluon.model_zoo import get_model as get_t
from mxnet_tpu_torch.gluon.model_zoo import vision as vision_t

TOL = 1e-4
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
CPU = mxt.cpu()
# family -> (the net in each package, input size, BatchNorms frozen)
FAMILIES = {
    "alexnet": (lambda v, **kw: v.alexnet(classes=10, **kw), 64, False),
    "squeezenet1.1": (
        lambda v, **kw: v.squeezenet1_1(classes=10, **kw), 64, False),
    "mobilenet0.25": (
        lambda v, **kw: v.mobilenet0_25(classes=10, **kw), 64, True),
    "densenet(16, 8, (2, 2))": (
        lambda v, **kw: v.DenseNet(16, 8, (2, 2), classes=10, **kw), 32,
        True),
    "vgg11_bn": (lambda v, **kw: v.vgg11_bn(classes=10, **kw), 32, True),
    "mobilenetv2_0.5": (
        lambda v, **kw: v.mobilenet_v2_0_5(classes=10, **kw), 64, True),
    "inceptionv3": (
        lambda v, **kw: v.inception_v3(classes=10, **kw), 75, True),
}


def batch(size, n=8):
    x = np.random.RandomState(0).randn(n, 3, size, size).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, n).astype(np.float32)
    return x, y


def prepare(net, frozen_bn):
    """Dropout off; with `frozen_bn` every BatchNorm on its running
    statistics (`use_global_stats`)."""
    for m in (net.modules() if isinstance(net, torch.nn.Module)
              else _jax_blocks(net)):
        if type(m).__name__ == "Dropout":
            m._rate = 0.0
        if frozen_bn and type(m).__name__ == "BatchNorm":
            m._use_global_stats = True


def _jax_blocks(block):
    yield block
    for child in block._children.values():
        yield from _jax_blocks(child)


def close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - ref).max()) / scale
    assert err <= TOL, (what, err)
    return err


def port_net(family, size):
    """The port's net on the CPU, seeded, xavier, shapes resolved."""
    make, _, frozen = FAMILIES[family]
    net = make(vision_t, device="cpu")
    mxrandom.seed(0, "cpu")
    net.initialize(init="xavier")
    with torch.no_grad():
        net(torch.zeros(1, 3, size, size))
    prepare(net, frozen)
    return net


def jax_net(family, arrays):
    make, _, frozen = FAMILIES[family]
    net = make(vision_j)
    params = net.collect_params()
    assert set(params) == set(arrays)
    for k, p in params.items():
        p.initialize()
        p.set_data(nd.array(arrays[k]))
    prepare(net, frozen)
    return net


def check_family(family):
    """Evaluation logits, then one SGD step, port against JAX."""
    _, size, _ = FAMILIES[family]
    x, y = batch(size)
    tn = port_net(family, size)
    arrays = {k: p.detach().numpy().copy()
              for k, p in tn.collect_params().items()}
    jn = jax_net(family, arrays)
    jn.hybridize()
    with torch.no_grad():
        logits_t = tn(torch.from_numpy(x)).numpy()
    logits_j = jn(nd.array(x)).asnumpy()
    assert logits_t.shape == (8, 10)
    close(logits_t, logits_j, "eval logits")

    parallel.make_mesh(dp=-1)
    try:
        lj = loss_j.SoftmaxCrossEntropyLoss()
        jt = parallel.ShardedTrainer(jn, lambda o, l: lj(o, l), "sgd",
                                     dict(SGD))
        loss_jax = float(jt.step([nd.array(x)], [nd.array(y)]).asscalar())
    finally:
        parallel.set_mesh(None)

    lt = gluon_t.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon_t.Trainer(tn.collect_params(), "sgd", dict(SGD))
    with autograd_t.record():
        loss = lt(tn(nd_t.array(x, ctx=CPU)), nd_t.array(y, ctx=CPU)).mean()
    loss.backward()
    trainer.step(1)
    close(float(loss.asscalar()), loss_jax, "loss")
    params = tn.collect_params()
    for name, w in zip(jt._names, jt.params):
        close(params[name].detach().numpy(), w, name)
    for (name, _), a in zip(jt._aux_params, jt.aux):
        close(params[name].detach().numpy(), a, name)
    moved = params[jt._names[-1]].detach().numpy()
    assert not np.array_equal(moved, arrays[jt._names[-1]])


@pytest.mark.parametrize("family", ["alexnet", "squeezenet1.1",
                                    "mobilenet0.25",
                                    "densenet(16, 8, (2, 2))"])
def test_family_forward_and_sgd_step_match_jax(family):
    check_family(family)


@pytest.mark.parametrize("name,size", [
    ("alexnet", 224), ("vgg11", 32), ("vgg11_bn", 32),
    ("squeezenet1.0", 224), ("squeezenet1.1", 224), ("mobilenet0.25", 224),
    ("mobilenetv2_0.5", 224), ("resnet18_v1", 32), ("resnet18_v2", 32),
    ("resnet50_v2", 32), ("densenet121", 64), ("inceptionv3", 96)])
def test_zoo_forward_shapes(name, size):
    """The JAX file's shapes case, every net at its size, on the port."""
    net = get_t(name, classes=10, device="cpu")
    net.initialize()
    x = nd_t.array(np.random.RandomState(0)
                   .randn(2, 3, size, size).astype(np.float32), ctx=CPU)
    out = net(x)
    assert out.shape == (2, 10)
    assert np.isfinite(out.asnumpy()).all()


@pytest.mark.parametrize("name", sorted(vision_j._MODELS))
def test_names_and_parameter_paths_equal_jax(name):
    """get_model knows the JAX package's names, and each net's
    parameter paths (before any forward) are the JAX package's."""
    assert sorted(vision_t._MODELS) == sorted(vision_j._MODELS)
    tn = get_t(name, classes=7, device="cpu")
    jn = get_j(name, classes=7)
    assert list(tn.collect_params()) == list(jn.collect_params())


def test_get_model_unknown():
    for get in (get_t, get_j):
        with pytest.raises(ValueError, match="unknown model"):
            get("resnext500")


def test_pretrained_missing_weights_raises(tmp_path):
    messages = []
    for v, kw in ((vision_t, {"device": "cpu"}), (vision_j, {})):
        with pytest.raises(FileNotFoundError, match="pretrained weights") \
                as err:
            v.mobilenet0_25(pretrained=True, root=str(tmp_path), **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_zoo_model_save_load_roundtrip(tmp_path):
    with mxt.cpu():
        net = get_t("mobilenet0.25", classes=4)
        net.initialize()
        x = nd_t.array(np.random.RandomState(1).randn(1, 3, 64, 64)
                       .astype(np.float32))
        ref = net(x).asnumpy()
        path = str(tmp_path / "m.params")
        net.save_parameters(path)
        net2 = get_t("mobilenet0.25", classes=4)
        net2.load_parameters(path)
        np.testing.assert_allclose(net2(x).asnumpy(), ref, rtol=1e-5,
                                   atol=1e-5)


def test_jax_params_file_loads_into_the_port(tmp_path):
    """A `.params` file the JAX package's net writes loads by name into a
    fresh port net, whose parameters and logits then equal the net the
    weights came from bit for bit; `pretrained=True` reads it from
    `root` under the reference's file name."""
    tn = port_net("mobilenet0.25", 64)
    arrays = {k: p.detach().numpy().copy()
              for k, p in tn.collect_params().items()}
    jn = jax_net("mobilenet0.25", arrays)
    jn.save_parameters(str(tmp_path / "mobilenet0.25.params"))
    fresh = vision_t.mobilenet0_25(classes=10, pretrained=True,
                                   root=str(tmp_path), device="cpu")
    for k, p in fresh.collect_params().items():
        assert np.array_equal(p.detach().numpy(), arrays[k]), k
    x = torch.from_numpy(batch(64, 2)[0])
    with torch.no_grad():
        assert torch.equal(fresh(x), tn(x))
