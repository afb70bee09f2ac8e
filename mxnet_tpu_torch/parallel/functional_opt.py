"""Functional view of an optimizer for the train step (counterpart of
`mxnet_tpu/parallel/functional_opt.py`): the kind, the per-parameter
state and update, the per-parameter weight decay of LAMB and the
learning rate at a step.

LAMB runs through `FusedLamb` in the trainer; Adam and AdamW update each
parameter with `cuda_ops.fused_update.adam_update`, in place. SGD and NAG
are not in the port yet."""
from __future__ import annotations

import math

import torch

from .. import optimizer as opt_mod
from ..cuda_ops import fused_update

__all__ = ["FunctionalOptimizer"]

_KINDS = ("adam", "adamw", "lamb")


class FunctionalOptimizer:
    def __init__(self, optimizer, param_names=None):
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self.opt = optimizer
        self.kind = type(optimizer).__name__.lower()
        if self.kind not in _KINDS:
            raise NotImplementedError(
                f"functional path for optimizer '{self.kind}' is not in the "
                f"port (have {', '.join(_KINDS)})")
        self.param_names = param_names

    def init(self, params):
        """Per-parameter state: float32 (m, v) for Adam and AdamW."""
        return [(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                 torch.zeros(p.shape, dtype=torch.float32, device=p.device))
                for p in params]

    def apply(self, params, grads, states, t, lr):
        """One Adam/AdamW step at step t (host int) and learning rate lr
        (host float) over every parameter, in place: params and the
        (m, v) states are updated where they lie. Weight decay is the
        optimizer's wd for every parameter (Adam does not use LAMB's
        bias/LayerNorm rule). Returns (params, states)."""
        if self.kind not in ("adam", "adamw"):
            raise NotImplementedError(
                f"FunctionalOptimizer.apply runs Adam and AdamW; "
                f"{self.kind} runs through FusedLamb")
        o = self.opt
        clip = o.clip_gradient if o.clip_gradient else -1.0
        # bias-corrected lr (matches the stateful Adam.update)
        lr_t = lr * math.sqrt(1 - o.beta2 ** t) / (1 - o.beta1 ** t)
        for p, g, (m, v) in zip(params, grads, states):
            fused_update.adam_update(
                p, g.contiguous(), m, v, lr_t, beta1=o.beta1, beta2=o.beta2,
                epsilon=o.epsilon, wd=o.wd, rescale_grad=o.rescale_grad,
                clip_gradient=clip, decoupled_wd=self.kind == "adamw")
        return params, states

    def _wd_for(self, i):
        """LAMB convention: no weight decay on bias/LayerNorm params."""
        if self.param_names is None:
            return self.opt.wd
        name = self.param_names[i]
        if name.endswith("bias") or name.endswith("beta") \
                or name.endswith("gamma"):
            return 0.0
        return self.opt.wd

    def lr_at(self, num_update):
        return self.opt.lr
