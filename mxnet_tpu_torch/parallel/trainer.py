"""ShardedTrainer: the train step on one device (counterpart of
`mxnet_tpu/parallel/trainer.py`).

The JAX package jits forward, loss, backward and optimizer into one
computation over a mesh. The port runs the same step eagerly on one
device, on one of two paths, as the JAX package chooses them:
  * LAMB, in its fused flat-master form (`FusedLamb`, the JAX package's
    path for LAMB in 'replicate' mode): the parameters live as one flat
    float32 master; each step runs the block in training mode on
    `unflatten(master)` through `torch.func.functional_call`, so autograd
    delivers the gradient already flat in float32, and `apply_flat`
    updates master and moments in place;
  * SGD, NAG, Adam and AdamW, per parameter: the trainer holds its own
    detached copies of the trainable parameters in the model dtype (as
    the JAX trainer keeps `params` apart from the block until
    `sync_to_block`) and the optimizer's float32 state for each; each
    step runs the block on those copies through `functional_call`,
    `torch.autograd.grad` returns one gradient per parameter in its
    dtype, and `FunctionalOptimizer.apply` updates copies and state in
    place.
The step counter goes up first; the bias-correction constants and the
learning rate are host floats.

The user's boundary is the JAX package's: `loss_fn` gets the model's
outputs and the labels as NDArrays and may return an NDArray (or a
tensor), and `step` takes NDArrays, tensors or numpy arrays and returns
the loss as an NDArray holding the 0-d float32 tensor, without waiting
for the card. So a `loss_fn` written for the JAX package, as
`nd.ctc_loss(...).mean()` in `examples/ocr/train_crnn.py`, runs
unchanged, and `step(...).asscalar()` reads the loss.

Parameters with grad_req 'null' (BatchNorm's running statistics) stay
out of training: `functional_call` leaves them the block's own tensors,
and a training forward updates them in place, so they carry from step
to step as the JAX trainer's aux state does. A block whose parameters
still wait for their shapes gets them from one evaluation-mode forward
on the first step's batch (the probe pass) before the trainer collects
its parameters. `set_grad_accum(n)` splits every batch into n equal
microbatches: their gradients are summed and divided by n, the loss is
the mean of theirs, BatchNorm statistics chain through them and each
draws its own dropout.

Single device and `param_mode="replicate"` only: meshes, fsdp/tp
modes, zero, memsafe, guard, check, telemetry and resilience are not in
the port yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from .. import context
from .. import optimizer as opt_mod
from ..ndarray.ndarray import NDArray
from .functional_opt import FunctionalOptimizer
from .fused_lamb import FusedLamb

__all__ = ["ShardedTrainer", "call_loss"]


def call_loss(loss_fn, outs, labels):
    """The user loss over the model outputs and labels, given as
    NDArrays as the JAX package gives them, reduced to its float32 mean
    (a scalar loss stays itself) as a tensor."""
    loss = loss_fn(*[NDArray(o) for o in outs],
                   *[NDArray(y) for y in labels])
    if isinstance(loss, NDArray):
        loss = loss._t
    return loss.float().mean()


def _as_tensor(x, device):
    if isinstance(x, NDArray):
        x = x._t
    elif isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class ShardedTrainer:
    def __init__(self, block, loss_fn, optimizer="lamb", optimizer_params=None,
                 mesh=None, param_mode="replicate", device=None):
        if mesh is not None or param_mode != "replicate":
            raise NotImplementedError(
                "the port trains on one device: meshes and sharded "
                "param modes are not in it yet")
        self.device = context.resolve(device)
        self.block = block
        self.loss_fn = loss_fn
        self._opt = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.num_update = 0
        self._accum = 1
        self._ready = False
        if not any(getattr(p, "mx_deferred", False)
                   for p in block.parameters()):
            self._setup()

    def _setup(self):
        block = self.block
        params = [(n, p) for n, p in block.named_parameters()
                  if getattr(p, "grad_req", "write") != "null"]
        for name, p in params:
            if p.device != self.device:
                raise ValueError(f"ShardedTrainer: parameter {name} is on "
                                 f"{p.device}, the trainer on {self.device}")
        self._names = [n for n, _ in params]
        self.fopt = FunctionalOptimizer(self._opt, self._names)
        o = self.fopt.opt
        if self.fopt.kind != "lamb":
            self._fl = None
            self.params = [p.detach().clone() for _, p in params]
            self.opt_state = self.fopt.init(self.params)
            self._ready = True
            return
        self._fl = FusedLamb(
            [p.shape for _, p in params], [p.dtype for _, p in params],
            [self.fopt._wd_for(i) for i in range(len(params))],
            o.beta1, o.beta2, o.epsilon, o.bias_correction, o.rescale_grad,
            o.clip_gradient or -1.0, o.lower_bound or -1.0,
            o.upper_bound or -1.0)
        self.params = self._fl.flatten([p for _, p in params])
        self.opt_state = (torch.zeros_like(self.params),
                          torch.zeros_like(self.params))
        self._ready = True

    def _finish_setup(self, data):
        """The probe pass: one evaluation-mode forward on `data` with no
        gradient gives the deferred parameters their shapes (filling
        them as `initialize` asked); then the trainer collects them."""
        was_training = self.block.training
        self.block.eval()
        try:
            with torch.no_grad():
                self.block(*data)
        finally:
            self.block.train(was_training)
        self._setup()

    def set_grad_accum(self, accum):
        """Split every later step's batch into `accum` equal microbatches
        (every data and label array's leading dimension must divide by
        it), summing their gradients: activation memory is one
        microbatch's."""
        accum = int(accum)
        if accum < 1:
            raise ValueError(f"grad accumulation factor must be >= 1, "
                             f"got {accum}")
        self._accum = accum
        return self

    def step(self, data, labels):
        """One train step on a batch: `data` and `labels` are NDArrays,
        tensors or numpy arrays (or lists of them), moved to the
        trainer's device. Returns the float32 loss: an NDArray of a 0-d
        tensor, not synchronised."""
        data = data if isinstance(data, (list, tuple)) else [data]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        data = [_as_tensor(x, self.device) for x in data]
        labels = [_as_tensor(x, self.device) for x in labels]
        if not self._ready:
            self._finish_setup(data)
        micro = self._microbatches(data, labels)
        self.num_update += 1
        t = self.num_update
        lr = self.fopt.lr_at(t)
        if self._fl is None:
            leaves = [p.detach().requires_grad_(True) for p in self.params]
            loss, grads = self._accumulate(leaves, lambda: leaves, micro)
            self.fopt.apply(self.params, grads, self.opt_state, t, lr)
            return NDArray(loss.detach())
        master = self.params.detach().requires_grad_(True)
        loss, (grad,) = self._accumulate(
            [master], lambda: self._fl.unflatten(master), micro)
        m, v = self.opt_state
        self._fl.apply_flat(self.params, grad, m, v, t, lr)
        return NDArray(loss.detach())

    def _microbatches(self, data, labels):
        """[(data, labels)] of the step's `accum` equal microbatches."""
        n = self._accum
        if n == 1:
            return [(data, labels)]
        for b in list(data) + list(labels):
            if b.dim() == 0 or b.shape[0] % n:
                raise ValueError(
                    f"grad accumulation x{n}: every batch/label array "
                    f"needs a leading dim divisible by {n}, got shape "
                    f"{tuple(b.shape)}")
        data = [x.chunk(n) for x in data]
        labels = [x.chunk(n) for x in labels]
        return [([x[i] for x in data], [y[i] for y in labels])
                for i in range(n)]

    def _accumulate(self, leaves, views, micro):
        """The mean loss and the mean gradients over the microbatches
        (the plain loss and gradients for one)."""
        loss, grads = self._loss_and_grads(leaves, views, *micro[0])
        if len(micro) == 1:
            return loss, grads
        grads = list(grads)
        for data, labels in micro[1:]:
            l_i, g_i = self._loss_and_grads(leaves, views, data, labels)
            loss = loss + l_i
            torch._foreach_add_(grads, list(g_i))
        n = len(micro)
        return loss / n, torch._foreach_div(grads, n)

    def _loss_and_grads(self, leaves, views, data, labels):
        """Forward in training mode on the parameter tensors that
        `views()` builds (inside the recorded region), the float32 mean
        loss and its gradients with respect to `leaves`."""
        was_training = self.block.training
        self.block.train()
        try:
            with torch.enable_grad():
                outs = functional_call(self.block,
                                       dict(zip(self._names, views())),
                                       tuple(data))
                outs = outs if isinstance(outs, (list, tuple)) else (outs,)
                loss = call_loss(self.loss_fn, outs, labels)
                grads = torch.autograd.grad(loss, leaves)
        finally:
            self.block.train(was_training)
        return loss, grads

    def sync_to_block(self):
        """Write the trained parameters (the LAMB master, or the Adam
        copies) back into the block's parameters (model dtype), e.g.
        before serving or saving them."""
        trained = self.params if self._fl is None \
            else self._fl.unflatten_master(self.params)
        with torch.no_grad():
            for name, w in zip(self._names, trained):
                p = self.block.get_parameter(name)
                p.copy_(w.to(p.dtype))

    @property
    def param_count(self):
        if self._fl is None:
            return sum(p.numel() for p in self.params)
        return sum(self._fl.sizes)
