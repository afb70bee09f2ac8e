"""Functional view of an optimizer for the train step (counterpart of
`mxnet_tpu/parallel/functional_opt.py`): the kind, the per-parameter
weight decay and the learning rate at a step. Only LAMB, which the
trainer runs through `FusedLamb`, is in the port."""
from __future__ import annotations

from .. import optimizer as opt_mod

__all__ = ["FunctionalOptimizer"]


class FunctionalOptimizer:
    def __init__(self, optimizer, param_names=None):
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self.opt = optimizer
        self.kind = type(optimizer).__name__.lower()
        if self.kind != "lamb":
            raise NotImplementedError(
                f"functional path for optimizer '{self.kind}' is not in the "
                "port (LAMB only)")
        self.param_names = param_names

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
