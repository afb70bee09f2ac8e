"""Vision datasets + transforms (counterpart of
`mxnet_tpu/gluon/data/vision/`; reference: `gluon/data/vision/`)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, SyntheticGratings)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "SyntheticGratings",
           "ImageRecordDataset", "transforms"]
