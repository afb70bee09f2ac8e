"""`gluon.data` (counterpart of `mxnet_tpu/gluon/data/`; reference:
`python/mxnet/gluon/data/`): datasets, samplers, the DataLoader, and the
vision datasets and transforms."""
from .dataset import Dataset, ArrayDataset, SimpleDataset
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      ShardedSampler)
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "ShardedSampler", "DataLoader", "vision"]
