"""Optimizers (counterpart of `mxnet_tpu/optimizer/__init__.py`).

The port trains through `parallel.ShardedTrainer`, so an optimizer here
holds hyperparameters only: the update itself is
`parallel.fused_lamb.FusedLamb` for LAMB,
`cuda_ops.fused_update.adam_update` (through `FunctionalOptimizer`) for
Adam and AdamW, and `FunctionalOptimizer`'s plain torch for SGD and NAG.
`create` resolves a name as the JAX package's does; the other optimizers
and the lr schedulers are not ported yet.
"""
from __future__ import annotations

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "create"]


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise NotImplementedError(
            f"optimizer {name!r} is not in the port yet (have "
            f"{sorted(_REGISTRY)})")
    return cls(**kwargs)


class Optimizer:
    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None):
        if lr_scheduler is not None:
            raise NotImplementedError("lr schedulers are not in the port yet")
        self.rescale_grad = rescale_grad
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.lr = learning_rate
        self.lr_scheduler = None


class SGD(Optimizer):
    """SGD, with momentum when `momentum` is not 0 (the JAX package's
    defaults: lr 0.01, momentum 0). The port has no row-sparse
    gradients, so `lazy_update` is not an option here."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum


class NAG(SGD):
    """Nesterov accelerated SGD."""


class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT (the JAX
    package's defaults: beta1 0.9, beta2 0.999, epsilon 1e-6, bias
    correction on, trust-ratio bounds off)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound or -1.0
        self.upper_bound = upper_bound or -1.0
        self.bias_correction = bias_correction


class Adam(Optimizer):
    """Adam with MXNet's update (the JAX package's defaults: lr 1e-3,
    beta1 0.9, beta2 0.999, epsilon 1e-8); weight decay folds into the
    gradient. The port has no row-sparse gradients, so `lazy_update` is
    not an option here."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon


class AdamW(Adam):
    """Adam with decoupled weight decay (MXNet's contrib adamw_update:
    the decay is not scaled by the learning rate)."""


_REGISTRY = {"sgd": SGD, "nag": NAG, "adam": Adam, "adamw": AdamW,
             "lamb": LAMB}
