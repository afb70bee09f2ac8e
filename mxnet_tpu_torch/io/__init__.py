"""`mx.io` data iterators (counterpart of `mxnet_tpu/io/__init__.py`;
reference: `python/mxnet/io.py` over `src/io/`).

`DataDesc`, `DataBatch`, the iterator protocol (`DataIter`), the
in-memory `NDArrayIter` (pad or discard the last batch; shuffle from
numpy's global generator, so both packages give the same order after
`np.random.seed`), `ResizeIter`, the double-buffered `PrefetchingIter`,
`CSVIter` and `MNISTIter` (over the port's `gluon.data.vision.MNIST`).

Batches are host data, as a reference data iterator's are: NDArrays on
the CPU, which the executor moves to its device when it binds them.

`ImageRecordIter` needs `io.recordio` and `image`, and `LibSVMIter`
sparse NDArrays: neither is in the port yet, and both raise
`NotPortedError`.
"""
from __future__ import annotations

import queue
import threading
from collections import namedtuple

import numpy as np

from .. import context as _context
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray, NotPortedError

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "ImageRecordIter", "MNISTIter", "CSVIter",
           "LibSVMIter"]

DataDesc = namedtuple("DataDesc", ["name", "shape"])


def _host(a):
    """A host (CPU) NDArray of the numpy array a."""
    return _nd.array(a, ctx=_context.cpu())


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) else [data]
        self.label = label if label is None or isinstance(
            label, (list, tuple)) else [label]
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator protocol of the reference (`next/reset/provide_data`)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        return self.next()

    def next(self):
        raise StopIteration

    @property
    def provide_data(self):
        return None

    @property
    def provide_label(self):
        return None


class NDArrayIter(DataIter):
    """In-memory iterator (reference: mx.io.NDArrayIter)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self._data = self._init(data, data_name)
        self._label = self._init(label, label_name) if label is not None \
            else []
        self._num = len(self._data[0][1]) if self._data else 0
        self._shuffle = shuffle
        self._last = last_batch_handle
        self.reset()

    @staticmethod
    def _init(src, default_name):
        if src is None:
            return []
        if isinstance(src, (np.ndarray, NDArray)):
            src = {default_name: src}
        elif isinstance(src, (list, tuple)):
            src = {f"{default_name}_{i}" if i else default_name: d
                   for i, d in enumerate(src)}
        out = []
        for name, arr in src.items():
            if isinstance(arr, NDArray):
                arr = arr.asnumpy()
            out.append((name, np.asarray(arr)))
        return out

    @property
    def provide_data(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:])
                for n, a in self._data]

    @property
    def provide_label(self):
        return [DataDesc(n, (self.batch_size,) + a.shape[1:])
                for n, a in self._label]

    def reset(self):
        self._cursor = 0
        self._order = np.random.permutation(self._num) if self._shuffle \
            else np.arange(self._num)

    def next(self):
        if self._cursor >= self._num:
            raise StopIteration
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        pad = 0
        if len(idx) < self.batch_size:
            if self._last == "discard":
                raise StopIteration
            pad = self.batch_size - len(idx)
            idx = np.concatenate([idx, self._order[:pad]])
        self._cursor += self.batch_size
        data = [_host(a[idx]) for _, a in self._data]
        label = [_host(a[idx]) for _, a in self._label]
        return DataBatch(data, label, pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


class ResizeIter(DataIter):
    """Fix an iterator to `size` batches per epoch (reference: ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self._iter = data_iter
        self._size = size
        self._reset_internal = reset_internal
        self._cur = 0

    def reset(self):
        self._cur = 0
        if self._reset_internal:
            self._iter.reset()

    def next(self):
        if self._cur >= self._size:
            raise StopIteration
        self._cur += 1
        try:
            return self._iter.next()
        except StopIteration:
            self._iter.reset()
            return self._iter.next()

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label


class PrefetchingIter(DataIter):
    """Double-buffered prefetcher (reference: `src/io/iter_prefetcher.h`):
    one thread reads the wrapped iterator two batches ahead."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        it = iters[0] if isinstance(iters, (list, tuple)) else iters
        super().__init__(it.batch_size)
        self._iter = it
        self._queue = queue.Queue(maxsize=2)
        self._thread = None
        self._start()

    def _start(self):
        stop = object()
        self._stop = stop

        def worker():
            while True:
                try:
                    self._queue.put(self._iter.next())
                except StopIteration:
                    self._queue.put(stop)
                    return
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def reset(self):
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._iter.reset()
        self._queue = queue.Queue(maxsize=2)
        self._start()

    def next(self):
        item = self._queue.get()
        if item is self._stop:
            raise StopIteration
        return item

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label


class ImageRecordIter(DataIter):
    """RecordIO image iterator (reference: `src/io/iter_image_recordio_2.
    cc`); needs `io.recordio` and `image`, which the port lacks."""

    def __init__(self, *args, **kwargs):
        raise NotPortedError(
            "io.ImageRecordIter needs io.recordio and image, which are not "
            "in the port yet (ROADMAP.md queue 1, \"The facades\")")


class LibSVMIter(DataIter):
    """Sparse libsvm iterator (reference: `src/io/iter_libsvm.cc`); needs
    sparse NDArrays, which the port lacks."""

    def __init__(self, *args, **kwargs):
        raise NotPortedError(
            "io.LibSVMIter needs sparse NDArrays, which are not in the port "
            "yet (ROADMAP.md queue 1, \"The eager MXNet surface\")")


class MNISTIter(NDArrayIter):
    """Reference: `src/io/iter_mnist.cc`; reads idx files through the
    port's gluon MNIST (its synthetic stand-in when the files are
    missing)."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=False,
                 flat=False, **kwargs):
        import os
        from ..gluon.data.vision.datasets import MNIST
        root = os.path.dirname(image) if image else "~/.mxnet/datasets/mnist"
        train = image is None or "train" in os.path.basename(image)
        ds = MNIST(root=root, train=train)
        data = ds._data.astype(np.float32) / 255.0
        data = data.reshape(len(data), -1) if flat else \
            np.transpose(data, (0, 3, 1, 2))
        super().__init__(data, ds._label.astype(np.float32),
                         batch_size=batch_size, shuffle=shuffle)


class CSVIter(DataIter):
    """Reference: `src/io/iter_csv.cc`."""

    def __init__(self, data_csv, data_shape, batch_size, label_csv=None,
                 label_shape=(1,), round_batch=True, num_parts=1,
                 part_index=0, **kwargs):
        from ..base import part_range
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32) \
            if label_csv else np.zeros(len(data), np.float32)
        lo, hi = part_range(len(data), num_parts, part_index)
        self._inner = NDArrayIter(data[lo:hi], label[lo:hi],
                                  batch_size=batch_size)

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label
