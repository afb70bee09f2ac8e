"""ResNet family (counterpart of `mxnet_tpu/models/resnet.py`):
BasicBlockV1/V2, BottleneckV1/V2, ResNetV1/V2 (with the CIFAR-style
`thumbnail` stem), `get_resnet` and resnet{18,34,50,101,152}_v{1,2}.

NCHW tensors at the API, as in the JAX package; on the card the
convolutions run channels-last in memory (`ops.nn_ops.conv_memory_format`).
Convolutions and BatchNorms are built without `in_channels` where the
JAX package builds them so, and take their shapes at the first forward;
the parameter paths are the JAX package's (`features.4.0.body.1.gamma`).
Train in bf16 by casting the net (`net.cast("bfloat16")`), running
statistics included, as the JAX package does.

`device=None` builds the parameters on the card (raising when there is
none); pass `device="cpu"` to build them on the CPU. Deferred
parameters take the device of the first input.
"""
from __future__ import annotations

import torch

from .. import context
from ..gluon import HybridBlock, nn

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1",
           "BasicBlockV2", "BottleneckV2", "ResNetV2",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.ds = nn.HybridSequential()
            self.ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                                  use_bias=False, in_channels=in_channels))
            self.ds.add(nn.BatchNorm())
        else:
            self.ds = None

    def forward(self, x):
        residual = x if self.ds is None else self.ds(x)
        return torch.relu(self.body(x) + residual)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, use_bias=False))
        self.body.add(nn.BatchNorm())
        if downsample:
            self.ds = nn.HybridSequential()
            self.ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                                  use_bias=False, in_channels=in_channels))
            self.ds.add(nn.BatchNorm())
        else:
            self.ds = None

    def forward(self, x):
        residual = x if self.ds is None else self.ds(x)
        return torch.relu(self.body(x) + residual)


def _stages(features, block, layers, channels):
    for i, num_layer in enumerate(layers):
        stride = 1 if i == 0 else 2
        stage = nn.HybridSequential()
        in_c = channels[i]
        stage.add(block(channels[i + 1], stride,
                        downsample=channels[i + 1] != in_c or stride != 1,
                        in_channels=in_c))
        for _ in range(num_layer - 1):
            stage.add(block(channels[i + 1], 1, downsample=False,
                            in_channels=channels[i + 1]))
        features.add(stage)


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 device=None):
        super().__init__()
        with context.resolve(device):
            self.features = nn.HybridSequential()
            if thumbnail:  # CIFAR-style stem
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            _stages(self.features, block, layers, channels)
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class BasicBlockV2(HybridBlock):
    """Pre-activation residual block: BN-ReLU precedes each conv, and the
    shortcut taps the pre-activation input."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        self.ds = nn.Conv2D(channels, kernel_size=1, strides=stride,
                            use_bias=False, in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        act = torch.relu(self.bn1(x))
        residual = x if self.ds is None else self.ds(act)
        out = self.conv1(act)
        out = self.conv2(torch.relu(self.bn2(out)))
        return out + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        mid = channels // 4
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(mid, kernel_size=1, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, use_bias=False)
        self.ds = nn.Conv2D(channels, kernel_size=1, strides=stride,
                            use_bias=False, in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        act = torch.relu(self.bn1(x))
        residual = x if self.ds is None else self.ds(act)
        out = self.conv1(act)
        out = self.conv2(torch.relu(self.bn2(out)))
        out = self.conv3(torch.relu(self.bn3(out)))
        return out + residual


class ResNetV2(HybridBlock):
    """Pre-activation ResNet: a bare stem conv, BN-ReLU inside the
    blocks, a final BN-ReLU before the pool."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 device=None):
        super().__init__()
        with context.resolve(device):
            self.features = nn.HybridSequential()
            self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            _stages(self.features, block, layers, channels)
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


_SPECS = {
    18: ("basic", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottleneck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottleneck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottleneck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

_BLOCKS = {(1, "basic"): BasicBlockV1, (1, "bottleneck"): BottleneckV1,
           (2, "basic"): BasicBlockV2, (2, "bottleneck"): BottleneckV2}


def get_resnet(num_layers, classes=1000, version=1, **kwargs):
    kind, layers, channels = _SPECS[num_layers]
    block = _BLOCKS[(version, kind)]
    net_cls = ResNetV1 if version == 1 else ResNetV2
    return net_cls(block, layers, channels, classes=classes, **kwargs)


def resnet18_v1(**kw):
    return get_resnet(18, **kw)


def resnet34_v1(**kw):
    return get_resnet(34, **kw)


def resnet50_v1(**kw):
    return get_resnet(50, **kw)


def resnet101_v1(**kw):
    return get_resnet(101, **kw)


def resnet152_v1(**kw):
    return get_resnet(152, **kw)


def resnet18_v2(**kw):
    return get_resnet(18, version=2, **kw)


def resnet34_v2(**kw):
    return get_resnet(34, version=2, **kw)


def resnet50_v2(**kw):
    return get_resnet(50, version=2, **kw)


def resnet101_v2(**kw):
    return get_resnet(101, version=2, **kw)


def resnet152_v2(**kw):
    return get_resnet(152, version=2, **kw)
