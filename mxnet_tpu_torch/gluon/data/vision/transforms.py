"""Vision transforms (counterpart of `mxnet_tpu/gluon/data/vision/
transforms.py`; reference: `gluon/data/vision/transforms.py`).

Each transform is a Block and keeps the type it is given: numpy in,
numpy out (the forked-worker path, where the card must not be touched);
an NDArray in, an NDArray out (the Block boundary hands `forward` the
held tensor and wraps the result). Resizing and random crops run on host
numpy in both cases, as in the JAX package, so every sample's crop shape
costs no device work.
"""
from __future__ import annotations

import numpy as np
import torch

from ....ndarray.ndarray import _torch_dtype
from ...block import Block
from ...nn import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight", "RandomFlipTopBottom"]


def _host(x):
    """(numpy array, put back): a tensor's host copy and the function
    that returns a numpy result to the tensor's device."""
    if isinstance(x, np.ndarray):
        return x, lambda a: a
    return x.detach().cpu().numpy(), \
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(x.device)


class Compose(HybridSequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        if isinstance(x, np.ndarray):          # worker-process (numpy) path
            return x.astype(self._dtype)
        return x.to(_torch_dtype(self._dtype))


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1] (reference: ToTensor)."""

    def forward(self, x):
        if isinstance(x, np.ndarray):
            x = x.astype(np.float32) / 255.0
            return x.transpose(2, 0, 1) if x.ndim == 3 \
                else x.transpose(0, 3, 1, 2)
        x = x.to(torch.float32) / 255.0
        return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean_np = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std_np = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        if isinstance(x, np.ndarray):
            return (x - self._mean_np) / self._std_np
        mean = torch.from_numpy(self._mean_np).to(x.device)
        std = torch.from_numpy(self._std_np).to(x.device)
        return (x - mean) / std


def _np_bilinear(img, h, w):
    """Host-side bilinear resize, half-pixel sampling: OpenCV
    INTER_LINEAR semantics, i.e. the reference's `mx.image.imresize`
    behavior (no antialias on downscale). img: (H, W, C) numpy."""
    H, W = img.shape[:2]
    img = np.asarray(img, np.float32)
    ys = np.clip((np.arange(h) + 0.5) * H / h - 0.5, 0, H - 1)
    xs = np.clip((np.arange(w) + 0.5) * W / w - 0.5, 0, W - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0).astype(np.float32)[:, None, None]
    wx = (xs - x0).astype(np.float32)[None, :, None]
    r0 = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    r1 = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return r0 * (1 - wy) + r1 * wy


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        h, w = self._size[1], self._size[0]
        data, back = _host(x)
        dtype = data.dtype
        if data.ndim == 3:
            out = _np_bilinear(data, h, w)
        else:
            out = np.stack([_np_bilinear(d, h, w) for d in data])
        return back(out.astype(dtype))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0, x0 = max((H - h) // 2, 0), max((W - w) // 2, 0)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    """Random-area crop + resize, on host numpy throughout."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        data, back = _host(x)
        dtype = data.dtype
        H, W = data.shape[0], data.shape[1]
        area = H * W
        for _ in range(10):
            target = area * np.random.uniform(*self._scale)
            ratio = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * ratio)))
            h = int(round(np.sqrt(target / ratio)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                data = data[y0:y0 + h, x0:x0 + w, :]
                break
        return back(_np_bilinear(data, self._size[1],
                                 self._size[0]).astype(dtype))


def _flip(x, axis):
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(np.flip(x, axis=axis))
    return torch.flip(x, dims=(axis,))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _flip(x, x.ndim - 2)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return _flip(x, x.ndim - 3)
        return x
