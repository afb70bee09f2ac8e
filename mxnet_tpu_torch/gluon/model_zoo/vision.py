"""Vision model zoo (counterpart of `mxnet_tpu/gluon/model_zoo/vision.py`;
reference: `python/mxnet/gluon/model_zoo/vision/` — alexnet/vgg/resnet/
squeezenet/mobilenet/densenet/inception + the `get_model` registry).

The same networks, factories and `get_model` names as the JAX package,
with its parameter paths (`features.3.squeeze.weight`), so
`weights.load_named_arrays` carries any net's weights by name. Branches
join with `torch.cat` on the channel axis. `device=None` builds a net on
the current device (the entered context's, else the card); deferred
shapes take the device of the first input. `pretrained=True` loads a
local `.params` file from `root` through `load_parameters` and raises
FileNotFoundError when there is none: nothing downloads.

ResNets delegate to `models.resnet` (the benchmark family).
"""
from __future__ import annotations

import os

import torch

from ... import context
from .. import nn
from ..block import HybridBlock

__all__ = ["get_model", "alexnet", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1_0",
           "squeezenet1_1", "mobilenet1_0", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_5", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2",
           "densenet121", "densenet161", "densenet169", "densenet201",
           "inception_v3",
           "AlexNet", "VGG", "SqueezeNet", "MobileNet", "MobileNetV2",
           "DenseNet", "Inception3"]


def _load_pretrained(net, name, root):
    path = os.path.join(os.path.expanduser(root), f"{name}.params")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained weights for {name!r} not found at {path}; this "
            f"environment has no model store access — place a .params file "
            f"there (reference format, nd.save dict)")
    net.load_parameters(path)


class AlexNet(HybridBlock):
    """Reference: model_zoo/vision/alexnet.py."""

    def __init__(self, classes=1000, device=None):
        super().__init__()
        with context.resolve(device):
            self.features = nn.HybridSequential()
            for args in [(64, 11, 4, 2), (192, 5, 1, 2)]:
                ch, k, s, p = args
                self.features.add(nn.Conv2D(ch, k, strides=s, padding=p,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2))
            for ch in (384, 256):
                self.features.add(nn.Conv2D(ch, 3, padding=1,
                                            activation="relu"))
            self.features.add(nn.Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(nn.MaxPool2D(3, 2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_VGG_SPEC = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
             13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
             16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
             19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    """Reference: model_zoo/vision/vgg.py."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 device=None):
        super().__init__()
        with context.resolve(device):
            self.features = nn.HybridSequential()
            for num, ch in zip(layers, filters):
                for _ in range(num):
                    self.features.add(nn.Conv2D(ch, 3, padding=1,
                                                use_bias=True))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(2, 2))
            self.features.add(nn.Flatten())
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Conv2D(squeeze, 1, activation="relu")
        self.expand1 = nn.Conv2D(expand1x1, 1, activation="relu")
        self.expand3 = nn.Conv2D(expand3x3, 3, padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1(x), self.expand3(x)], 1)


class SqueezeNet(HybridBlock):
    """Reference: model_zoo/vision/squeezenet.py."""

    def __init__(self, version="1.0", classes=1000, device=None):
        super().__init__()
        with context.resolve(device):
            if version not in ("1.0", "1.1"):
                raise ValueError(f"unsupported SqueezeNet version "
                                 f"{version!r}; choose '1.0' or '1.1'")
            self.features = nn.HybridSequential()
            if version == "1.0":
                self.features.add(nn.Conv2D(96, 7, strides=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for sq, e1, e3 in [(16, 64, 64), (16, 64, 64), (32, 128, 128)]:
                    self.features.add(_Fire(sq, e1, e3))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for sq, e1, e3 in [(32, 128, 128), (48, 192, 192),
                                   (48, 192, 192), (64, 256, 256)]:
                    self.features.add(_Fire(sq, e1, e3))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                self.features.add(_Fire(64, 256, 256))
            else:  # 1.1
                self.features.add(nn.Conv2D(64, 3, strides=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for sq, e1, e3 in [(16, 64, 64), (16, 64, 64)]:
                    self.features.add(_Fire(sq, e1, e3))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for sq, e1, e3 in [(32, 128, 128), (32, 128, 128)]:
                    self.features.add(_Fire(sq, e1, e3))
                self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                for sq, e1, e3 in [(48, 192, 192), (48, 192, 192),
                                   (64, 256, 256), (64, 256, 256)]:
                    self.features.add(_Fire(sq, e1, e3))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential()
            self.output.add(nn.Conv2D(classes, 1, activation="relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def _conv_bn_relu(seq, channels, kernel, stride=1, pad=0, groups=1,
                  relu6=False):
    seq.add(nn.Conv2D(channels, kernel, strides=stride, padding=pad,
                      groups=groups, use_bias=False))
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu6" if relu6 else "relu"))


class MobileNet(HybridBlock):
    """Depthwise-separable MobileNet v1 (reference: mobilenet.py).
    Depthwise = grouped conv with groups == channels."""

    def __init__(self, multiplier=1.0, classes=1000, device=None):
        super().__init__()
        with context.resolve(device):
            def c(ch):
                return max(int(ch * multiplier), 8)
            spec = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
                    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
                    (1024, 2), (1024, 1)]
            self.features = nn.HybridSequential()
            _conv_bn_relu(self.features, c(32), 3, stride=2, pad=1)
            in_ch = c(32)
            for ch, stride in spec:
                _conv_bn_relu(self.features, in_ch, 3, stride=stride, pad=1,
                              groups=in_ch)  # depthwise
                _conv_bn_relu(self.features, c(ch), 1)  # pointwise
                in_ch = c(ch)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _InvertedResidual(HybridBlock):
    def __init__(self, in_ch, out_ch, stride, expand):
        super().__init__()
        self.use_shortcut = stride == 1 and in_ch == out_ch
        mid = in_ch * expand
        self.body = nn.HybridSequential()
        if expand != 1:
            _conv_bn_relu(self.body, mid, 1, relu6=True)
        _conv_bn_relu(self.body, mid, 3, stride=stride, pad=1, groups=mid,
                      relu6=True)
        self.body.add(nn.Conv2D(out_ch, 1, use_bias=False))
        self.body.add(nn.BatchNorm())

    def forward(self, x):
        out = self.body(x)
        return x + out if self.use_shortcut else out


class MobileNetV2(HybridBlock):
    """Reference: mobilenet.py MobileNetV2 (inverted residuals)."""

    def __init__(self, multiplier=1.0, classes=1000, device=None):
        super().__init__()
        with context.resolve(device):
            def c(ch):
                return max(int(ch * multiplier), 8)
            self.features = nn.HybridSequential()
            _conv_bn_relu(self.features, c(32), 3, stride=2, pad=1, relu6=True)
            in_ch = c(32)
            spec = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
            for expand, ch, n, s in spec:
                for i in range(n):
                    self.features.add(_InvertedResidual(
                        in_ch, c(ch), s if i == 0 else 1, expand))
                    in_ch = c(ch)
            last = c(1280) if multiplier > 1.0 else 1280
            _conv_bn_relu(self.features, last, 1, relu6=True)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _DenseLayer(HybridBlock):
    """BN-ReLU-Conv1x1(4k) -> BN-ReLU-Conv3x3(k), output concatenated onto
    the input (reference model_zoo/vision/densenet.py _make_dense_layer)."""

    def __init__(self, growth_rate, bn_size=4, dropout=0.0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(bn_size * growth_rate, 1, use_bias=False),
                      nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(growth_rate, 3, padding=1, use_bias=False))
        self._dropout = dropout
        if dropout:
            self.drop = nn.Dropout(dropout)

    def forward(self, x):
        out = self.body(x)
        if self._dropout:
            out = self.drop(out)
        return torch.cat([x, out], 1)


class _Transition(HybridBlock):
    def __init__(self, out_channels):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm(), nn.Activation("relu"),
                      nn.Conv2D(out_channels, 1, use_bias=False),
                      nn.AvgPool2D(2, 2))

    def forward(self, x):
        return self.body(x)


_DENSENET_SPEC = {121: (64, 32, [6, 12, 24, 16]),
                  161: (96, 48, [6, 12, 36, 24]),
                  169: (64, 32, [6, 12, 32, 32]),
                  201: (64, 32, [6, 12, 48, 32])}


class DenseNet(HybridBlock):
    """Reference: model_zoo/vision/densenet.py."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0.0, classes=1000, device=None):
        super().__init__()
        with context.resolve(device):
            self.features = nn.HybridSequential()
            self.features.add(nn.Conv2D(num_init_features, 7, strides=2,
                                        padding=3, use_bias=False),
                              nn.BatchNorm(), nn.Activation("relu"),
                              nn.MaxPool2D(3, 2, padding=1))
            channels = num_init_features
            for i, num_layers in enumerate(block_config):
                for _ in range(num_layers):
                    self.features.add(_DenseLayer(growth_rate, bn_size,
                                                  dropout))
                channels += num_layers * growth_rate
                if i != len(block_config) - 1:
                    channels //= 2
                    self.features.add(_Transition(channels))
            self.features.add(nn.BatchNorm(), nn.Activation("relu"),
                              nn.GlobalAvgPool2D(), nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class _Branches(HybridBlock):
    """Parallel branches concatenated on the channel axis (the Inception
    block wiring primitive)."""

    def __init__(self, *branches):
        super().__init__()
        self.branches = nn.HybridSequential()
        for b in branches:
            self.branches.add(b)

    def forward(self, x):
        return torch.cat([b(x) for b in self.branches], 1)


def _i3_conv(ch, k, s=1, p=0):
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(ch, k, strides=s, padding=p, use_bias=False),
            nn.BatchNorm(epsilon=0.001), nn.Activation("relu"))
    return blk


def _i3_seq(*blocks):
    s = nn.HybridSequential()
    s.add(*blocks)
    return s


class Inception3(HybridBlock):
    """Inception-v3 (reference model_zoo/vision/inception.py), built from
    the standard A/B/C/D/E blocks; expects 299x299 inputs (any >= 75 works
    — the head is a global pool)."""

    def __init__(self, classes=1000, device=None):
        super().__init__()
        with context.resolve(device):
            conv, seq = _i3_conv, _i3_seq

            def pool_branch(pool, ch):
                return seq(pool, conv(ch, 1))

            def block_a(pool_ch):
                return _Branches(
                    conv(64, 1),
                    seq(conv(48, 1), conv(64, 5, p=2)),
                    seq(conv(64, 1), conv(96, 3, p=1), conv(96, 3, p=1)),
                    pool_branch(nn.AvgPool2D(3, 1, padding=1), pool_ch))

            def block_b():
                return _Branches(
                    conv(384, 3, s=2),
                    seq(conv(64, 1), conv(96, 3, p=1), conv(96, 3, s=2)),
                    nn.MaxPool2D(3, 2))

            def block_c(ch7):
                return _Branches(
                    conv(192, 1),
                    seq(conv(ch7, 1), conv(ch7, (1, 7), p=(0, 3)),
                        conv(192, (7, 1), p=(3, 0))),
                    seq(conv(ch7, 1), conv(ch7, (7, 1), p=(3, 0)),
                        conv(ch7, (1, 7), p=(0, 3)),
                        conv(ch7, (7, 1), p=(3, 0)),
                        conv(192, (1, 7), p=(0, 3))),
                    pool_branch(nn.AvgPool2D(3, 1, padding=1), 192))

            def block_d():
                return _Branches(
                    seq(conv(192, 1), conv(320, 3, s=2)),
                    seq(conv(192, 1), conv(192, (1, 7), p=(0, 3)),
                        conv(192, (7, 1), p=(3, 0)), conv(192, 3, s=2)),
                    nn.MaxPool2D(3, 2))

            def block_e():
                return _Branches(
                    conv(320, 1),
                    seq(conv(384, 1), _Branches(conv(384, (1, 3), p=(0, 1)),
                                                conv(384, (3, 1), p=(1, 0)))),
                    seq(conv(448, 1), conv(384, 3, p=1),
                        _Branches(conv(384, (1, 3), p=(0, 1)),
                                  conv(384, (3, 1), p=(1, 0)))),
                    pool_branch(nn.AvgPool2D(3, 1, padding=1), 192))

            self.features = nn.HybridSequential()
            self.features.add(conv(32, 3, s=2), conv(32, 3), conv(64, 3, p=1),
                              nn.MaxPool2D(3, 2), conv(80, 1), conv(192, 3),
                              nn.MaxPool2D(3, 2),
                              block_a(32), block_a(64), block_a(64),
                              block_b(),
                              block_c(128), block_c(160), block_c(160),
                              block_c(192),
                              block_d(), block_e(), block_e(),
                              nn.GlobalAvgPool2D(), nn.Dropout(0.5),
                              nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


# --------------------------------------------------------------------------
# factory functions + registry
# --------------------------------------------------------------------------

def alexnet(pretrained=False, root="~/.mxnet/models", **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        _load_pretrained(net, "alexnet", root)
    return net


def _make_vgg(num, batch_norm=False):
    def factory(pretrained=False, root="~/.mxnet/models", **kwargs):
        layers, filters = _VGG_SPEC[num]
        net = VGG(layers, filters, batch_norm=batch_norm, **kwargs)
        if pretrained:
            _load_pretrained(net, f"vgg{num}{'_bn' if batch_norm else ''}",
                             root)
        return net
    factory.__name__ = f"vgg{num}{'_bn' if batch_norm else ''}"
    return factory


vgg11, vgg13, vgg16, vgg19 = (_make_vgg(n) for n in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (
    _make_vgg(n, True) for n in (11, 13, 16, 19))


def squeezenet1_0(pretrained=False, root="~/.mxnet/models", **kwargs):
    net = SqueezeNet("1.0", **kwargs)
    if pretrained:
        _load_pretrained(net, "squeezenet1.0", root)
    return net


def squeezenet1_1(pretrained=False, root="~/.mxnet/models", **kwargs):
    net = SqueezeNet("1.1", **kwargs)
    if pretrained:
        _load_pretrained(net, "squeezenet1.1", root)
    return net


def _make_mobilenet(multiplier, v2=False):
    def factory(pretrained=False, root="~/.mxnet/models", **kwargs):
        cls = MobileNetV2 if v2 else MobileNet
        net = cls(multiplier, **kwargs)
        if pretrained:
            tag = f"mobilenetv2_{multiplier}" if v2 else \
                f"mobilenet{multiplier}"
            _load_pretrained(net, tag, root)
        return net
    factory.__name__ = (f"mobilenet_v2_{multiplier}" if v2
                        else f"mobilenet_{multiplier}").replace(".", "_")
    return factory


mobilenet1_0 = _make_mobilenet(1.0)
mobilenet0_5 = _make_mobilenet(0.5)
mobilenet0_25 = _make_mobilenet(0.25)
mobilenet_v2_1_0 = _make_mobilenet(1.0, v2=True)
mobilenet_v2_0_5 = _make_mobilenet(0.5, v2=True)


def _resnet_factory(name):
    def factory(pretrained=False, root="~/.mxnet/models", **kwargs):
        from ...models import resnet as _resnet
        net = getattr(_resnet, name)(**kwargs)
        if pretrained:
            _load_pretrained(net, name, root)
        return net
    factory.__name__ = name
    return factory


def _make_densenet(num):
    def factory(pretrained=False, root="~/.mxnet/models", **kwargs):
        init, growth, cfg = _DENSENET_SPEC[num]
        net = DenseNet(init, growth, cfg, **kwargs)
        if pretrained:
            _load_pretrained(net, f"densenet{num}", root)
        return net
    factory.__name__ = f"densenet{num}"
    return factory


densenet121 = _make_densenet(121)
densenet161 = _make_densenet(161)
densenet169 = _make_densenet(169)
densenet201 = _make_densenet(201)


def inception_v3(pretrained=False, root="~/.mxnet/models", **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        _load_pretrained(net, "inceptionv3", root)
    return net


resnet18_v1 = _resnet_factory("resnet18_v1")
resnet34_v1 = _resnet_factory("resnet34_v1")
resnet50_v1 = _resnet_factory("resnet50_v1")
resnet101_v1 = _resnet_factory("resnet101_v1")
resnet152_v1 = _resnet_factory("resnet152_v1")
resnet18_v2 = _resnet_factory("resnet18_v2")
resnet34_v2 = _resnet_factory("resnet34_v2")
resnet50_v2 = _resnet_factory("resnet50_v2")
resnet101_v2 = _resnet_factory("resnet101_v2")
resnet152_v2 = _resnet_factory("resnet152_v2")

_MODELS = {
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.5": mobilenet0_5,
    "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.5": mobilenet_v2_0_5,
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """Fetch a model constructor by name (reference: model_zoo.get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
