"""Functional view of an optimizer for the train step (counterpart of
`mxnet_tpu/parallel/functional_opt.py`): the kind, the per-parameter
state and update, the per-parameter weight decay of LAMB and the
learning rate at a step (the optimizer's lr scheduler at the step
count, when it has one).

LAMB runs through `FusedLamb` in the trainer; Adam and AdamW update every
parameter with one `cuda_ops.fused_update.adam_update_multi` call (one
kernel launch for each weight dtype), in place. SGD and
NAG are `mxnet_tpu/ops/optimizer_ops.py`'s `sgd_update`,
`sgd_mom_update` and `nag_mom_update` in plain torch (multi-tensor
`torch._foreach_*` ops; no TPU kernel computes them), in place: the
gradient in float32, rescaled, clipped and with wd · w added; the
momentum in float32; the weight updated in float32 and rounded back to
its own dtype (no float32 master for bf16 weights)."""
from __future__ import annotations

import math

import torch

from .. import optimizer as opt_mod
from ..cuda_ops import fused_update

__all__ = ["FunctionalOptimizer"]

_KINDS = ("sgd", "nag", "adam", "adamw", "lamb")


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
        """Per-parameter state: float32 (m, v) for Adam and AdamW, a
        float32 momentum (m,) for NAG and for SGD with momentum, nothing
        for plain SGD."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        if self.kind in ("adam", "adamw"):
            return [(zeros(p), zeros(p)) for p in params]
        if self.kind == "nag" or self.opt.momentum:
            return [(zeros(p),) for p in params]
        return [() for _ in params]

    def apply(self, params, grads, states, t, lr):
        """One step at step t (host int) and learning rate lr (host
        float) over every parameter, in place: params and states are
        updated where they lie. Weight decay is the optimizer's wd for
        every parameter (only LAMB has the bias/LayerNorm rule). Returns
        (params, states)."""
        if self.kind in ("sgd", "nag"):
            self._apply_sgd(params, grads, states, lr)
            return params, states
        if self.kind not in ("adam", "adamw"):
            raise NotImplementedError(
                f"FunctionalOptimizer.apply runs SGD, NAG, Adam and AdamW; "
                f"{self.kind} runs through FusedLamb")
        o = self.opt
        clip = o.clip_gradient if o.clip_gradient else -1.0
        # bias-corrected lr (matches the stateful Adam.update)
        lr_t = lr * math.sqrt(1 - o.beta2 ** t) / (1 - o.beta1 ** t)
        n = len(params)
        fused_update.adam_update_multi(
            params, [g.contiguous() for g in grads], [s[0] for s in states],
            [s[1] for s in states], [lr_t] * n, [o.wd] * n, beta1=o.beta1,
            beta2=o.beta2, epsilon=o.epsilon, rescale_grad=o.rescale_grad,
            clip_gradient=clip, decoupled_wd=self.kind == "adamw")
        return params, states

    def _apply_sgd(self, params, grads, states, lr):
        o = self.opt
        g = torch._foreach_mul([x.float() for x in grads], o.rescale_grad)
        if o.clip_gradient and o.clip_gradient > 0:
            torch._foreach_clamp_min_(g, -o.clip_gradient)
            torch._foreach_clamp_max_(g, o.clip_gradient)
        w = [p.float() for p in params]
        if o.wd:
            torch._foreach_add_(g, torch._foreach_mul(w, o.wd))
        if not states or not states[0]:
            # sgd_update: w - lr * g
            new = torch._foreach_sub(w, torch._foreach_mul(g, lr))
        else:
            m = [s[0] for s in states]
            torch._foreach_mul_(m, o.momentum)
            if self.kind == "sgd":
                # sgd_mom_update: m = mu * m - lr * g; w + m
                torch._foreach_sub_(m, torch._foreach_mul(g, lr))
                new = torch._foreach_add(w, m)
            else:
                # nag_mom_update: m = mu * m + g; w - lr * (g + mu * m)
                torch._foreach_add_(m, g)
                step = torch._foreach_add(g, torch._foreach_mul(
                    m, o.momentum))
                new = torch._foreach_sub(w, torch._foreach_mul(step, lr))
        torch._foreach_copy_(params, new)

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
        o = self.opt
        return o.lr_scheduler(num_update) if o.lr_scheduler else o.lr
