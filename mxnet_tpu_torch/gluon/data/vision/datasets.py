"""Vision datasets (counterpart of `mxnet_tpu/gluon/data/vision/
datasets.py`, copied; reference: `python/mxnet/gluon/data/vision/
datasets.py`).

Nothing downloads: datasets read standard files from `root` when present
(idx-gzip for MNIST, pickle batches for CIFAR) and otherwise fall back to
the JAX package's deterministic synthetic sample (the same seeds, so the
same images, bit for bit), with a logged warning. A sample is an NDArray
on the current device, or host numpy inside a forked DataLoader worker.
`ImageRecordDataset` needs `io.recordio`, which is not in the port yet.
"""
from __future__ import annotations

import gzip
import logging
import os
import struct

import numpy as np

from ..dataset import Dataset
from ....ndarray import ndarray as _nd

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "SyntheticGratings"]

logger = logging.getLogger("mxnet_tpu_torch")


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        from ..dataloader import in_worker
        # forked DataLoader workers must stay off the device: hand the
        # (numpy-type-preserving) transform chain host arrays there
        data = self._data[idx] if in_worker() else _nd.array(self._data[idx])
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


def _synthetic(shape, num_classes, n, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(np.uint8)
    label = rng.randint(0, num_classes, size=n).astype(np.int32)
    return data, label


class SyntheticGratings(Dataset):
    """Deterministic LEARNABLE image classification set for zero-egress
    convergence gates: class k is a sinusoidal grating with orientation
    k*pi/C and frequency 3+(k mod 5), with per-instance random phase and
    Gaussian noise, channels modulated by cos(k)/sin(k).

    Published attainable accuracy (the falsifiable part): resnet18_v1
    (classes=10, 32x32, batch 64, adam lr 2e-3) reaches >= 85% held-out
    top-1 within 40 steps — pinned by
    tests/train/test_quality_gates.py::test_resnet18_synthetic_gratings_gate.
    Unlike random-label synthetic data (loss-trend-only gates), a model
    with a broken gradient path, dead BN, or a silently dropped regularizer
    FAILS this gate."""

    def __init__(self, train=True, num_classes=10, size=32, n=None,
                 noise=0.3, seed=None, transform=None):
        n = n if n is not None else (512 if train else 256)
        seed = seed if seed is not None else (0 if train else 1)
        rng = np.random.RandomState(seed)
        C = num_classes
        y = rng.randint(0, C, n)
        X = np.zeros((n, 3, size, size), np.float32)
        yy, xx = np.mgrid[0:size, 0:size] / size
        for i in range(n):
            k = int(y[i])
            theta = k * np.pi / C
            freq = 3 + (k % 5)
            phase = rng.uniform(0, 2 * np.pi)
            g = np.sin(2 * np.pi * freq *
                       (xx * np.cos(theta) + yy * np.sin(theta)) + phase)
            X[i] = np.stack([g, g * np.cos(k), g * np.sin(k)]) + \
                noise * rng.randn(3, size, size)
        self._data = X.astype(np.float32)
        self._label = y.astype(np.float32)
        self._transform = transform

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        data, label = self._data[idx], self._label[idx]
        if self._transform is not None:
            return self._transform(data, label)
        return data, label

    @property
    def arrays(self):
        """(X (n,3,H,W) f32, y (n,) f32) — direct batch access for gates."""
        return self._data, self._label


class MNIST(_DownloadedDataset):
    """MNIST from idx files in `root`, or synthetic fallback."""

    _files = {
        True: ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        False: ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }
    _shape = (28, 28, 1)
    _classes = 10

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        img_f, lbl_f = self._files[self._train]
        img_path = os.path.join(self._root, img_f)
        lbl_path = os.path.join(self._root, lbl_f)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self._label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(img_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self._data = np.frombuffer(f.read(), dtype=np.uint8) \
                    .reshape(n, rows, cols, 1)
        else:
            logger.warning("%s: files not found under %s — using synthetic data",
                           type(self).__name__, self._root)
            n = 1024 if self._train else 256
            self._data, self._label = _synthetic(self._shape, self._classes, n,
                                                 seed=42 if self._train else 43)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    _shape = (32, 32, 3)
    _classes = 10

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        import pickle
        batches = [f"data_batch_{i}" for i in range(1, 6)] if self._train \
            else ["test_batch"]
        base = os.path.join(self._root, "cifar-10-batches-py")
        if all(os.path.exists(os.path.join(base, b)) for b in batches):
            data, labels = [], []
            for b in batches:
                with open(os.path.join(base, b), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                data.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                labels += list(d[b"labels"])
            self._data = np.concatenate(data)
            self._label = np.asarray(labels, dtype=np.int32)
        else:
            logger.warning("%s: files not found under %s — using synthetic data",
                           type(self).__name__, self._root)
            n = 1024 if self._train else 256
            self._data, self._label = _synthetic(self._shape, self._classes, n,
                                                 seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    _classes = 100

    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None):
        super().__init__(root, train, transform)


class ImageRecordDataset(Dataset):
    """Dataset over a RecordIO pack (reference: ImageRecordDataset over
    `tools/im2rec.py` output): needs `io.recordio`."""

    def __init__(self, filename, flag=1, transform=None):
        raise NotImplementedError(
            "gluon.data.vision.ImageRecordDataset needs io.recordio, which "
            "is not in the port yet (ROADMAP.md queue 1, \"The facades\")")
