"""Optimizers (counterpart of `mxnet_tpu/optimizer/__init__.py`).

An optimizer holds its hyperparameters and MXNet's per-parameter
bookkeeping: the update count per index (`_update_count`; Adam's bias
correction reads it), the learning rate from `lr_scheduler` when one is
given (`learning_rate`, `set_learning_rate`), and each parameter's
`lr_mult` / `wd_mult` (`_get_lr`, `_get_wd`: from `param_dict`, which
`gluon.Trainer` passes, else from `set_lr_mult` / `set_wd_mult` by index
or by name).

`create_state(index, weight)` and `update(index, weight, grad, state)`
are the eager path (`gluon.Trainer`): the update runs in place on the
parameter and its state, under `torch.no_grad()` (the Trainer's). Adam
and AdamW also have `update_multi(indices, weights, grads, states)`,
which `gluon.Trainer` calls once a step: one
`cuda_ops.fused_update.adam_update_multi` call over the list (one kernel
launch for each weight dtype on the card, its plain version per tensor
on the CPU); `update` is `update_multi` of one index. SGD (with momentum and
`multi_precision`) and NAG are `mxnet_tpu/ops/optimizer_ops.py`'s
updates in plain torch: the gradient in float32, rescaled, clipped and
with wd · w added; the state float32; the weight rounded back to its
own dtype. LAMB's eager update is not ported (ROADMAP.md queue 1, "The
eager MXNet surface"): LAMB trains through `parallel.ShardedTrainer`'s `FusedLamb`.
`parallel.ShardedTrainer` reads the same hyperparameters for its own
update (`parallel.functional_opt`). Row-sparse gradients, and with them
`lazy_update`, are not in the port (ROADMAP.md queue 1, "What the GPT-2
lifecycle left out").
"""
from __future__ import annotations

import math

import torch

from ..cuda_ops import fused_update

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "create"]


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise NotImplementedError(
            f"optimizer {name!r} is not in the port yet (have "
            f"{sorted(_REGISTRY)}; ROADMAP.md queue 1, \"The eager MXNet "
            "surface\")")
    return cls(**kwargs)


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- bookkeeping ----------------------------------------------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    # -- per-optimizer --------------------------------------------------
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0

    def _grad32(self, grad, weight, wd):
        """The update's gradient: float32, rescaled, clipped, + wd · w."""
        g = grad.float() * self.rescale_grad
        clip = self._clip()
        if clip > 0:
            g = g.clamp(-clip, clip)
        return g + wd * weight.float() if wd else g


def _zeros32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


class SGD(Optimizer):
    """SGD, with momentum when `momentum` is not 0 (the JAX package's
    defaults: lr 0.01, momentum 0); `multi_precision` keeps a float32
    master of a low-precision weight. The port has no row-sparse
    gradients, so `lazy_update` is not an option here."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.multi_precision and weight.dtype != torch.float32:
            mom = _zeros32(weight) if self.momentum else None
            return (mom, weight.detach().float())
        return _zeros32(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.multi_precision and isinstance(state, tuple):
            # mp_sgd_update / mp_sgd_mom_update: wd on the float32 master
            mom, w32 = state
            g = self._grad32(grad, w32, wd)
            if mom is not None:
                mom.mul_(self.momentum).sub_(lr * g)
                w32.add_(mom)
            else:
                w32.sub_(lr * g)
            weight.copy_(w32)
            return
        g = self._grad32(grad, weight, wd)
        if state is not None:
            # sgd_mom_update: m = mu * m - lr * g; w + m
            state.mul_(self.momentum).sub_(lr * g)
            weight.copy_(weight.float() + state)
        else:
            # sgd_update: w - lr * g
            weight.copy_(weight.float() - lr * g)


class NAG(SGD):
    """Nesterov accelerated SGD: m = mu * m + g; w - lr * (g + mu * m).
    It always keeps a momentum."""

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._grad32(grad, weight, wd)
        state.mul_(self.momentum).add_(g)
        weight.copy_(weight.float() - lr * (g + self.momentum * state))


class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT (the JAX
    package's defaults: beta1 0.9, beta2 0.999, epsilon 1e-6, bias
    correction on, trust-ratio bounds off). It trains through
    `parallel.ShardedTrainer`; its eager `update` is not in the port."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound or -1.0
        self.upper_bound = upper_bound or -1.0
        self.bias_correction = bias_correction

    def update(self, index, weight, grad, state):
        raise NotImplementedError(
            "LAMB's eager update is not in the port yet (ROADMAP.md queue "
            "1, \"The eager MXNet surface\"); train with "
            "parallel.ShardedTrainer(..., 'lamb')")


class Adam(Optimizer):
    """Adam with MXNet's update (the JAX package's defaults: lr 1e-3,
    beta1 0.9, beta2 0.999, epsilon 1e-8); weight decay folds into the
    gradient. The bias correction folds into the learning rate, a host
    float: lr · sqrt(1 - beta2^t) / (1 - beta1^t) at the parameter's own
    update count t. The port has no row-sparse gradients, so
    `lazy_update` is not an option here."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def update(self, index, weight, grad, state):
        self.update_multi([index], [weight], [grad], [state])

    def update_multi(self, indices, weights, grads, states):
        """One step of the parameters `indices`, in place, in one
        `adam_update_multi` call. Each index's update count, lr and wd
        are read in order, as `update` per index would read them."""
        lrs, wds = [], []
        for index in indices:
            self._update_count(index)
            t = self._index_update_count[index]
            lr, wd = self._get_lr(index), self._get_wd(index)
            lrs.append(lr * math.sqrt(1.0 - self.beta2 ** t)
                       / (1.0 - self.beta1 ** t))
            wds.append(wd)
        grads = [
            # the kernel reads 16-byte vectors of a contiguous gradient
            g.clone(memory_format=torch.contiguous_format)
            if w.is_cuda and (not g.is_contiguous() or g.data_ptr() % 16)
            else g for w, g in zip(weights, grads)]
        fused_update.adam_update_multi(
            weights, grads, [s[0] for s in states], [s[1] for s in states],
            lrs, wds, beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, rescale_grad=self.rescale_grad,
            clip_gradient=self._clip(), decoupled_wd=self._decoupled)


class AdamW(Adam):
    """Adam with decoupled weight decay (MXNet's contrib adamw_update:
    the decay is not scaled by the learning rate)."""

    _decoupled = True


_REGISTRY = {"sgd": SGD, "nag": NAG, "adam": Adam, "adamw": AdamW,
             "lamb": LAMB}
