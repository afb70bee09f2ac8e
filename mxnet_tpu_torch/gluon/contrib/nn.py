"""gluon.contrib.nn (counterpart of `mxnet_tpu/gluon/contrib/nn.py`;
reference: `python/mxnet/gluon/contrib/nn/basic_layers.py`).

Concurrent/HybridConcurrent (parallel branches concatenated), Identity,
SparseEmbedding, SyncBatchNorm and PixelShuffle1D/2D/3D. Intended
differences, as in the JAX package: SparseEmbedding's gradient is dense
(the JAX Embedding op ignores `sparse_grad`), and SyncBatchNorm is
BatchNorm on the one device the port trains on (`num_devices` is
accepted and ignored).
"""
from __future__ import annotations

import math

import torch

from .. import nn as _nn
from ..block import HybridBlock, HybridSequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class HybridConcurrent(HybridSequential):
    """Run the children on the same input and concatenate their outputs
    along `axis`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([child(x) for child in self._modules.values()],
                         dim=self.axis)


class Concurrent(HybridConcurrent):
    pass


class Identity(HybridBlock):
    def forward(self, x):
        return x


class SparseEmbedding(_nn.Embedding):
    """Embedding with `sparse_grad=True` (reference: contrib
    SparseEmbedding). The gradient stays dense, as the JAX package's."""

    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        super().__init__(input_dim, output_dim, dtype=dtype,
                         sparse_grad=True, **kwargs)
        self._sparse_grad = True


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device BatchNorm (reference: contrib SyncBatchNorm). The port
    trains on one device, where it is BatchNorm; `num_devices` is accepted
    for MXNet's sake and ignored."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


def _pixel_shuffle(x, factors, ndim):
    """(N, C·∏f, d1..dn) -> (N, C, d1·f1..dn·fn)."""
    n, c = x.shape[0], x.shape[1]
    spatial = tuple(x.shape[2:])
    f = tuple(factors) if isinstance(factors, (list, tuple)) \
        else (factors,) * ndim
    new_c = c // math.prod(f)
    # (N, C', f1..fn, d1..dn) -> each factor dim after its spatial dim
    x = x.reshape((n, new_c) + f + spatial)
    perm = [0, 1]
    for i in range(ndim):
        perm += [2 + ndim + i, 2 + i]
    x = x.permute(perm)
    return x.reshape((n, new_c) + tuple(d * fi for d, fi in zip(spatial, f)))


class _PixelShuffle(HybridBlock):
    def __init__(self, factor, ndim):
        super().__init__()
        self._factor = factor
        self._ndim = ndim

    def forward(self, x):
        return _pixel_shuffle(x, self._factor, self._ndim)


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 3)
