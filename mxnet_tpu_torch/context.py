"""Device contexts (counterpart of `mxnet_tpu/context.py`).

`Context(device_type, device_id)` names a device as MXNet does: `cpu()`,
`gpu(i)` (the card; "cuda" is an alias of "gpu"). A context used as a
`with` block becomes the default device of the code inside it, on a
thread-local stack (`current_context()` reads its top), so an unchanged
MXNet script runs on the CPU inside `with mx.cpu():`.

Every entry point of the port resolves its device through `resolve`:
an explicit device (a `Context`, a `torch.device` or its name) wins,
then the innermost entered context, then the card. A process without a
card raises instead of carrying on quietly on the CPU: the CPU is used
only when the caller asks for it, by name or by an entered `mx.cpu()`,
as the tests do.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus",
           "resolve"]

_DEVTYPE_ALIASES = {"cuda": "gpu"}
_refused = None     # why this process may not use the card, if it may not


class Context:
    """A device context; a `with` block makes it the default device.

    Reference: `python/mxnet/context.py` (Context.__enter__ stack
    semantics)."""

    _stack = threading.local()

    def __init__(self, device_type, device_id=0):
        self.device_type = _DEVTYPE_ALIASES.get(device_type, device_type)
        if self.device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r} "
                             "(cpu or gpu)")
        self.device_id = int(device_id)

    @classmethod
    def of(cls, device):
        """The Context of a torch device ("cuda" is the card: gpu)."""
        if device.type == "cpu":
            return cls("cpu", 0)
        return cls("gpu", device.index or 0)

    @property
    def torch_device(self):
        """The torch.device this context names."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(Context._stack, "contexts", None)
        if stack is None:
            stack = Context._stack.contexts = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._stack.contexts.pop()
        return False

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def entered():
    """The innermost context entered on this thread, or None."""
    stack = getattr(Context._stack, "contexts", None)
    return stack[-1] if stack else None


def current_context():
    """The innermost entered context, else the card (`gpu(i)` of the
    current CUDA device: the port's default, which `resolve` refuses
    where there is no card)."""
    ctx = entered()
    if ctx is not None:
        return ctx
    index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return Context("gpu", index)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def num_gpus():
    return torch.cuda.device_count()


def refuse_card(reason):
    """From now on, resolving the card in this process raises
    RuntimeError(reason) before CUDA is touched (a forked DataLoader
    worker: CUDA does not survive fork)."""
    global _refused
    _refused = reason


def resolve(device=None):
    """The torch.device an entry point runs on: `device` when the caller
    names one (a Context, a torch.device or a name), else the innermost
    entered context, else the card."""
    if device is None:
        device = entered()
    if _refused is not None and (device is None or torch.device(
            device.torch_device if isinstance(device, Context)
            else device).type == "cuda"):
        raise RuntimeError(_refused)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mxnet_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, Context):
        device = device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               "unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
