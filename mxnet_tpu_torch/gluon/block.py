"""Block (counterpart of `mxnet_tpu/gluon/block.py`).

A Block is a thin `torch.nn.Module`. Attribute paths name parameters
exactly as the JAX package's `collect_params()` does
(`gpt.layers.0.attn.qkv.weight`), so carrying weights between the two
packages is the identity on names. PyTorch runs eagerly, so there is
no hybridize/jit cache: `HybridBlock` is the same class and
`hybridize()` changes nothing.

A block starts in evaluation mode (`training` False), as the JAX
package runs outside a train step; `train()` (what the trainer's step
sets around its forward) turns dropout on, `eval()` off. An active
autograd scope overrides the block's flag (`training(block)`).

A call with an NDArray among its arguments is a call at the user's
boundary: the block runs on the held tensors and its tensor outputs come
back as NDArrays. Inside `autograd.record()` a call lets the block's
trainable parameters record gradients (once per block).

A layer whose parameters have deferred shapes (a 0 in the shape: `Dense`
without `in_units`, convolutions without `in_channels`, `BatchNorm`)
completes them at its first forward from its input
(`_resolve_deferred` through the layer's `infer_param_shapes`), as the
JAX package's eager forward does. `cast(dtype)` casts every
floating-point parameter, deferred ones and running statistics
included, as the JAX package's does; integer `Constant`s (int8 weights)
keep their dtype.
"""
from __future__ import annotations

import re

import torch

from .. import autograd as _autograd
from .. import context
from .. import initializer as _init
from ..ndarray.ndarray import NDArray
from .parameter import ParameterDict, dtype_of, finish_deferred

__all__ = ["Block", "HybridBlock", "HybridSequential", "training"]


def training(block):
    """The training mode `block` runs in: the active autograd scope's
    flag (`record`, `pause`, `train_mode`, `predict_mode`,
    `set_training`) while one is in effect, else the block's own."""
    flag = _autograd._training
    return block.training if flag is None else flag


def _wrap(out):
    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return type(out)(_wrap(o) for o in out)
    return out


def _unwrap(x):
    return x._t if isinstance(x, NDArray) else x


class Block(torch.nn.Module):
    # True on a block that consumes remat policies per layer (BERTModel,
    # GPTModel); any other block's policy wraps its whole forward in the
    # trainer (`memsafe.block_wrap_policy`)
    _remat_handles_policy = False

    def __init__(self):
        super().__init__()
        self.training = False
        self._mx_recorded = False
        self._remat_policy = None

    def __call__(self, *args, **kwargs):
        if _autograd._recording and not self._mx_recorded:
            self._attach_grads()
        for a in args:
            if isinstance(a, NDArray):
                return _wrap(super().__call__(
                    *[_unwrap(x) for x in args],
                    **{k: _unwrap(v) for k, v in kwargs.items()}))
        return super().__call__(*args, **kwargs)

    def _attach_grads(self):
        """Let every trainable floating-point parameter of this subtree
        record gradients (`autograd.record()`'s first forward)."""
        for p in self.parameters():
            if p.grad_req != "null" and p.is_floating_point():
                _autograd.attach_grad_req(p)
        for m in self.modules():
            if isinstance(m, Block):
                m._mx_recorded = True

    def hybridize(self, active=True, **kwargs):
        """Accepted for MXNet's sake; PyTorch runs eagerly."""
        return self

    def collect_params(self, select=None):
        """All parameters of this subtree keyed by dotted path
        (optionally filtered by a regex)."""
        return ParameterDict(
            (path, p) for path, p in self.named_parameters()
            if select is None or re.search(select, path))

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, device=None, generator=None):
        """Fill every parameter not yet initialised in place (every one
        with `force_reinit`): `init` when given, else the parameter's own
        initializer, else uniform (the JAX package's precedence), through
        the name rule of `Initializer.init_array` (biases and betas 0,
        gammas 1); a `Constant` keeps its value. `ctx` (a Context or a
        torch.device, MXNet's keyword) or `device` moves the block first;
        `verbose` is accepted and prints nothing, as in the JAX package;
        `generator` is the explicit random source (its device must be the
        parameters'), else the device stream of `random.seed`. A deferred
        parameter draws nothing now: the choice is recorded and applied
        when its first forward gives it a shape."""
        if ctx is not None and device is not None:
            raise TypeError("initialize: pass ctx or device, not both")
        device = ctx if device is None else device
        if device is not None:
            self.to(context.resolve(device))
        for _, p in self.named_parameters():
            if getattr(p, "mx_constant", False) or (
                    getattr(p, "mx_initialized", False) and not force_reinit):
                continue
            initializer = _init.create(
                init or getattr(p, "mx_init", None) or "uniform")
            if getattr(p, "mx_deferred", False):
                p.mx_init_requested = (initializer, generator)
                continue
            _init._fill(initializer, p.mx_name, p.data, generator)
            p.mx_initialized = True
        return self

    def remat(self, policy="layers"):
        """Set this block tree's rematerialisation policy
        (`memsafe.POLICIES`: "none" | "dots_saveable" | "layers" |
        "full", in increasing memory savings and recompute cost). Blocks
        that handle policies per layer (BERTModel, GPTModel) take it for
        their layer stacks; any other block gets it around its whole
        forward in the trainer. Overrides the `remat_policy` knob and the
        model config's `remat` flag. Returns self."""
        from .. import memsafe as _memsafe
        _memsafe.validate_policy(policy)
        for m in self.modules():
            if getattr(type(m), "_remat_handles_policy", False):
                m._remat_policy = policy
        self._remat_policy = policy
        return self

    def save_parameters(self, filename, deduplicate=False):
        """`collect_params().save(filename)`: the JAX package's file."""
        self.collect_params().save(filename)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a `save_parameters` file of either package into this
        block's parameters in place (`ParameterDict.load`)."""
        self.collect_params().load(filename, ctx=ctx,
                                   allow_missing=allow_missing,
                                   ignore_extra=ignore_extra)

    def cast(self, dtype):
        """Cast every floating-point parameter, and its gradient, to
        `dtype` in place."""
        dt = dtype_of(dtype)
        for p in self.parameters():
            if p.is_floating_point():
                g, p.grad = p.grad, None
                p.data = p.data.to(dt)
                if g is not None:
                    p.grad = g.to(dt)
        return self

    def infer_param_shapes(self, x_shape):
        """{parameter name: full shape} from the first input's shape; the
        layers with deferred parameters say how."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support deferred shapes")

    def _resolve_deferred(self, x):
        """Complete this layer's deferred parameters from its input x."""
        shapes = None
        for name, p in self._parameters.items():
            if p is not None and getattr(p, "mx_deferred", False):
                if shapes is None:
                    shapes = self.infer_param_shapes(tuple(x.shape))
                finish_deferred(p, shapes[name], x.device)


HybridBlock = Block


class HybridSequential(Block):
    """Children registered as "0", "1", ... in insertion order; a forward
    runs them one after the other."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]
