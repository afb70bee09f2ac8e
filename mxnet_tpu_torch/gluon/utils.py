"""Gluon utilities (counterpart of `mxnet_tpu/gluon/utils.py`; reference:
`python/mxnet/gluon/utils.py`): `split_data`, `split_and_load`,
`clip_global_norm` and `check_sha1`. `download` keeps its signature and
raises: this project runs without a network, so files are placed
locally and passed by path."""
from __future__ import annotations

import hashlib

import torch

from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis` (the last takes the
    remainder when `even_split` is False)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"batch size {size} not divisible by number of slices {num_slice}")
    step = size // num_slice
    return [_nd.slice_axis(data, axis=batch_axis, begin=i * step,
                           end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch across the contexts of `ctx_list`, one slice each."""
    if not isinstance(data, NDArray):
        data = _nd.array(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale the NDArrays in place so that their joint L2 norm is at
    most `max_norm`; returns the norm before (a host float, which waits
    for the card)."""
    total = torch.sqrt(sum(a._t.detach().float().square().sum()
                           for a in arrays))
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for a in arrays:
        a._t = (a._t.detach().float() * scale).to(a._t.dtype)
    return float(total)


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1 << 20)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise RuntimeError(
        "mxnet_tpu_torch runs without a network; place files locally and "
        "pass paths (gluon.utils.download is unavailable by design)")
