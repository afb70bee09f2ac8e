"""Samplers (counterpart of `mxnet_tpu/gluon/data/sampler.py`, copied;
reference: `python/mxnet/gluon/data/sampler.py`). The random samplers
draw from numpy's global generator, as the JAX package's do, so after
`np.random.seed(s)` both packages give the same order."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "ShardedSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class ShardedSampler(Sampler):
    """Each distributed worker samples a disjoint slice of the dataset;
    slices union to exactly one epoch (the DataLoader analog of the
    iterators' num_parts/part_index — reference: the partition params of
    `src/io/iter_image_recordio_2.cc`). num_parts/part_index default to the
    running `torch.distributed` job (`parallel.num_workers()`/
    `parallel.rank()`), so `DataLoader(ds, sampler=ShardedSampler(len(ds)))`
    is input-correct on every process with no further wiring."""

    def __init__(self, length, num_parts=None, part_index=None, shuffle=True):
        from ...base import part_range
        if num_parts is None or part_index is None:
            from ...parallel.distributed import rank, num_workers
            num_parts = num_workers() if num_parts is None else num_parts
            part_index = rank() if part_index is None else part_index
        self._lo, self._hi = part_range(length, num_parts, part_index)
        self._shuffle = shuffle

    def __iter__(self):
        idx = np.arange(self._lo, self._hi)
        if self._shuffle:
            np.random.shuffle(idx)
        return iter(idx.tolist())

    def __len__(self):
        return self._hi - self._lo


class BatchSampler(Sampler):
    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                pass
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size
