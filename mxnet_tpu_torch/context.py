"""Device contexts (counterpart of `mxnet_tpu/context.py`).

`cpu()` / `gpu(i)` map onto `torch.device`. Every entry point of the
port resolves its device through `resolve`: no device means the card,
and a process without one raises instead of carrying on quietly on the
CPU. The CPU is used only when the caller asks for it, as the tests do.
"""
from __future__ import annotations

import torch

__all__ = ["cpu", "gpu", "resolve"]


def cpu(device_id=0):
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def resolve(device=None):
    """The torch.device an entry point runs on: the card unless the
    caller names another device explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mxnet_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               "unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
