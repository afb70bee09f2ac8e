"""Optimizers (counterpart of `mxnet_tpu/optimizer/__init__.py`).

An optimizer holds its hyperparameters and MXNet's per-parameter
bookkeeping: the update count per index (`_update_count`; Adam's bias
correction reads it), the learning rate from `lr_scheduler` when one is
given (`learning_rate`, `set_learning_rate`), and each parameter's
`lr_mult` / `wd_mult` (`_get_lr`, `_get_wd`: from `param_dict`, which
`gluon.Trainer` passes, else from `set_lr_mult` / `set_wd_mult` by index
or by name).

The boundary is the JAX package's: `create_state(index, weight)` returns
NDArrays (a tuple of them where the state has several parts, None where
there is none), and `update(index, weight, grad, state)` takes NDArrays
(or tensors: `gluon.Trainer` passes its parameters) and updates the
weight and the state in place, under `torch.no_grad()`. Inside, each
optimizer runs on the held tensors (`_create_state`, `_update`).

Every optimizer of the JAX package is here, registered by its name in
`create`, with its defaults: sgd, nag, adam, adamw, adagrad, rmsprop,
ftrl, signum, signsgd, lamb, lars, adamax, nadam, adadelta, dcasgd, sgld
and ftml. As the JAX classes do, SGD (with momentum and
`multi_precision`), NAG, AdaGrad, RMSProp, Ftrl, Signum and SignSGD call
the update ops of `ops.optimizer_ops` by name and take their results
(the gradient in float32, rescaled, clipped and with wd · w added; the
state float32; the weight rounded back to its own dtype); LARS, Adamax,
Nadam, AdaDelta, DCASGD, SGLD and FTML are the JAX classes' arithmetic
on tensors. SGLD draws its noise
from the device stream of `random.seed` (a draw from another stream than
the JAX package's).

Adam and AdamW have `update_multi(indices, weights, grads, states)`,
which `gluon.Trainer` calls once a step: one
`cuda_ops.fused_update.adam_update_multi` call over the list (one kernel
launch for each weight dtype on the card, its plain version per tensor
on the CPU); `update` is `update_multi` of one index.

LAMB (`lamb_update`'s semantics: bias correction by the parameter's own
count, wd · w inside the update, trust = ||w|| / ||u|| per tensor with
a zero norm taken as 1, then the bounds) runs its step on the LAMB
kernels through `parallel.fused_lamb.FusedLamb`'s flat layout:
`update_multi` gathers a step's list into one flat float32 weight and
gradient (each tensor padded to whole 512-lane rows), runs pass 1 and
pass 2 once over it (two kernel launches a step on the card, the plain
versions on the CPU) with the per-tensor norms summed in a fixed order,
and writes the weights back. The moments live in flat vectors for the
list; each state NDArray holds a view of its segment. `update` is
`update_multi` of one index.

`parallel.ShardedTrainer` reads the same hyperparameters for its own
update (`parallel.functional_opt`). Row-sparse gradients, and with them
`lazy_update`, are not in the port (ROADMAP.md queue 1, "What the GPT-2
lifecycle left out").
"""
from __future__ import annotations

import math

import torch

from .. import ops as _ops
from .. import random as _random
from ..base import Registry
from ..cuda_ops import fused_update
from ..ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "RMSProp",
           "Ftrl", "Signum", "SignSGD", "LAMB", "LARS", "Adamax", "Nadam",
           "AdaDelta", "DCASGD", "SGLD", "FTML", "create", "register"]

_registry = Registry("optimizer")
register = _registry.register


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _registry.get(name)(**kwargs)


def _tensor(x):
    return x._t if isinstance(x, NDArray) else x


def _tensors(state):
    """The tensors of a state (NDArrays, tensors, None, or a tuple)."""
    if isinstance(state, tuple):
        return tuple(_tensors(s) for s in state)
    return _tensor(state)


def _arrays(state):
    """A state of tensors as NDArrays."""
    if isinstance(state, tuple):
        return tuple(_arrays(s) for s in state)
    return NDArray(state) if isinstance(state, torch.Tensor) else state


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

    # -- the NDArray boundary --------------------------------------------
    def create_state(self, index, weight):
        """The state of parameter `index` as NDArrays (None if none)."""
        return _arrays(self._create_state(index, _tensor(weight)))

    def update(self, index, weight, grad, state):
        """One step of parameter `index`, in place on `weight` and the
        NDArrays of `state`."""
        with torch.no_grad():
            self._update(index, _tensor(weight), _tensor(grad),
                         _tensors(state))

    # -- per-optimizer, on tensors -----------------------------------------
    def _create_state(self, index, weight):
        return None

    def _update(self, index, weight, grad, state):
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

    def _hyper(self, index):
        """Count the update of `index`; (lr, wd) for it."""
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _op(self, name, weight, grad, state, lr, **kwargs):
        """The update op `name` on (weight, grad, *state, lr), its results
        copied into the weight and the state in place (the mp ops return
        (weight, *state) in their argument order)."""
        outs = _ops.OPS[name](weight, grad, *state, lr,
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip(), **kwargs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for dst, src in zip((weight,) + tuple(state), outs):
            dst.copy_(src)


def _zeros32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


@register("sgd")
class SGD(Optimizer):
    """SGD, with momentum when `momentum` is not 0 (the JAX package's
    defaults: lr 0.01, momentum 0); `multi_precision` keeps a float32
    master of a low-precision weight. The port has no row-sparse
    gradients, so `lazy_update` is not an option here."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def _create_state(self, index, weight):
        if self.multi_precision and weight.dtype != torch.float32:
            mom = _zeros32(weight) if self.momentum else None
            return (mom, weight.detach().float())
        return _zeros32(weight) if self.momentum else None

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        if self.multi_precision and isinstance(state, tuple):
            # wd on the float32 master
            mom, w32 = state
            if mom is not None:
                self._op("mp_sgd_mom_update", weight, grad, (mom, w32), lr,
                         momentum=self.momentum, wd=wd)
            else:
                self._op("mp_sgd_update", weight, grad, (w32,), lr, wd=wd)
        elif state is not None:
            self._op("sgd_mom_update", weight, grad, (state,), lr,
                     momentum=self.momentum, wd=wd)
        else:
            self._op("sgd_update", weight, grad, (), lr, wd=wd)


@register("nag")
class NAG(SGD):
    """Nesterov accelerated SGD: m = mu * m + g; w - lr * (g + mu * m).
    It always keeps a momentum."""

    def _create_state(self, index, weight):
        return _zeros32(weight)

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        self._op("nag_mom_update", weight, grad, (state,), lr,
                 momentum=self.momentum, wd=wd)


@register("adam")
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

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _update(self, index, weight, grad, state):
        self._update_multi([index], [weight], [grad], [state])

    def update_multi(self, indices, weights, grads, states):
        """One step of the parameters `indices` (NDArrays or tensors), in
        place, in one `adam_update_multi` call. Each index's update
        count, lr and wd are read in order, as `update` per index would
        read them."""
        with torch.no_grad():
            self._update_multi(indices, [_tensor(w) for w in weights],
                               [_tensor(g) for g in grads],
                               [_tensors(s) for s in states])

    def _update_multi(self, indices, weights, grads, states):
        lrs, wds = [], []
        for index in indices:
            lr, wd = self._hyper(index)
            t = self._index_update_count[index]
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


@register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay (MXNet's contrib adamw_update:
    the decay is not scaled by the learning rate)."""

    _decoupled = True


@register("adagrad")
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def _create_state(self, index, weight):
        return _zeros32(weight)

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        self._op("adagrad_update", weight, grad, (state,), lr,
                 epsilon=self.float_stable_eps, wd=wd)


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp; `centered` is Graves' variant (rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights or -1.0

    def _create_state(self, index, weight):
        if self.centered:
            return (_zeros32(weight), _zeros32(weight), _zeros32(weight))
        return _zeros32(weight)

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        if self.centered:
            self._op("rmspropalex_update", weight, grad, state, lr,
                     gamma1=self.gamma1, gamma2=self.gamma2,
                     epsilon=self.epsilon, wd=wd)
        else:
            self._op("rmsprop_update", weight, grad, (state,), lr,
                     gamma1=self.gamma1, epsilon=self.epsilon, wd=wd,
                     clip_weights=self.clip_weights)


@register("ftrl")
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        self._op("ftrl_update", weight, grad, state, lr, lamda1=self.lamda1,
                 beta=self.beta, wd=wd)


@register("signum")
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def _create_state(self, index, weight):
        return _zeros32(weight) if self.momentum else None

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        if state is not None:
            self._op("signum_update", weight, grad, (state,), lr,
                     momentum=self.momentum, wd=wd, wd_lh=self.wd_lh)
        else:
            self._op("signsgd_update", weight, grad, (), lr, wd=wd)


@register("signsgd")
class SignSGD(Signum):
    def __init__(self, **kwargs):
        super().__init__(momentum=0.0, **kwargs)


@register("lamb")
class LAMB(Optimizer):
    """Layer-wise adaptive moments for large-batch BERT (the JAX
    package's defaults: beta1 0.9, beta2 0.999, epsilon 1e-6, bias
    correction on, trust-ratio bounds off). Its step runs on the LAMB
    kernels over `FusedLamb`'s flat layout (the module's docstring):
    `update_multi` is two launches for each group of parameters that
    share an update count (one group in a `gluon.Trainer` step)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound or -1.0
        self.upper_bound = upper_bound or -1.0
        self.bias_correction = bias_correction
        self._flat = {}         # indices -> _FlatLamb

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def update(self, index, weight, grad, state):
        self.update_multi([index], [weight], [grad], [state])

    def update_multi(self, indices, weights, grads, states):
        """One LAMB step of the parameters `indices` (NDArrays or
        tensors; each state an (m, v) pair), in place."""
        lrs, wds, ts = [], [], []
        for index in indices:
            lr, wd = self._hyper(index)
            lrs.append(lr)
            wds.append(wd)
            ts.append(self._index_update_count[index])
        groups = {}
        for k, t in enumerate(ts):
            groups.setdefault(t, []).append(k)
        with torch.no_grad():
            for t, ks in groups.items():
                key = tuple(indices[k] for k in ks)
                ws = [_tensor(weights[k]) for k in ks]
                flat = self._flat.get(key)
                if flat is None or not flat.fits(ws, [wds[k] for k in ks]):
                    flat = self._flat[key] = _FlatLamb(
                        self, ws, [wds[k] for k in ks])
                flat.step(ws, [_tensor(grads[k]) for k in ks],
                          [states[k] for k in ks], [lrs[k] for k in ks], t)


class _FlatLamb:
    """One list of parameters in `FusedLamb`'s flat layout: the flat
    float32 weight and gradient buffers, and the flat moments, whose
    segments the state NDArrays hold as views."""

    def __init__(self, opt, weights, wds):
        from ..parallel.fused_lamb import FusedLamb
        self.opt = opt
        self.wds = list(wds)
        self.fl = FusedLamb(
            [w.shape for w in weights], [w.dtype for w in weights], wds,
            opt.beta1, opt.beta2, opt.epsilon, opt.bias_correction,
            opt.rescale_grad, opt._clip(), opt.lower_bound, opt.upper_bound)
        dev = weights[0].device
        self.w = torch.zeros(self.fl.total, device=dev)
        self.g = torch.zeros_like(self.w)
        self.m, self.v = self.fl.zeros_moments(dev)
        self.m_views = self.fl.unflatten_master(self.m)
        self.v_views = self.fl.unflatten_master(self.v)
        self.lr_seg = None

    def fits(self, weights, wds):
        return (list(wds) == self.wds
                and [tuple(w.shape) for w in weights] == self.fl.shapes
                and [w.dtype for w in weights] == self.fl.dtypes
                and weights[0].device == self.w.device)

    def _bind(self, states):
        """Hold each state's moments in the flat vectors: a state whose
        NDArrays do not hold this layout's views yet has its values
        copied in, and its NDArrays then hold the views."""
        for k, (m, v) in enumerate(states):
            for arr, view in ((m, self.m_views[k]), (v, self.v_views[k])):
                t = _tensor(arr)
                if t is view or (t.data_ptr() == view.data_ptr()
                                 and t.shape == view.shape):
                    continue
                view.copy_(t)
                if isinstance(arr, NDArray):
                    arr._t = view

    def step(self, weights, grads, states, lrs, t):
        opt, fl = self.opt, self.fl
        fl.rescale, fl.clip = opt.rescale_grad, opt._clip()
        self._bind(states)
        fl.load_flat(self.w, weights)
        fl.load_flat(self.g, grads)
        if len(set(lrs)) == 1:
            lr, scale = lrs[0], None
        else:
            # per-tensor lr (lr_mult): folded into the trust ratio rows
            lr, scale = 1.0, torch.tensor(lrs, dtype=torch.float32,
                                          device=self.w.device)
        fl.apply_flat(self.w, self.g, self.m, self.v, t, lr,
                      trust_scale=scale)
        for w, view in zip(weights, fl.unflatten_master(self.w)):
            w.copy_(view)
        for k, (m, v) in enumerate(states):
            # a state given as tensors takes the new moments back
            for arr, view in ((m, self.m_views[k]), (v, self.v_views[k])):
                if not isinstance(arr, NDArray) and arr is not view:
                    arr.copy_(view)


@register("lars")
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (reference: 1.6 LARS)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def _create_state(self, index, weight):
        return _zeros32(weight)

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        w32 = weight.float()
        g = grad.float() * self.rescale_grad
        if self.clip_gradient:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        w_norm = w32.square().sum().sqrt()
        g_norm = g.square().sum().sqrt()
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        state.copy_(self.momentum * state - lr * trust * (g + wd * w32))
        weight.copy_(w32 + state)


@register("adamax")
class Adamax(Optimizer):
    """Adam with an infinity-norm second moment."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        t = self._index_update_count[index]
        g = self._grad32(grad, weight, wd)
        m, u = state
        m.copy_(self.beta1 * m + (1 - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, g.abs()))
        step = (lr / (1 - self.beta1 ** t)) * m / (u + self.epsilon)
        weight.copy_(weight.float() - step)


@register("nadam")
class Nadam(Optimizer):
    """Nesterov Adam with the momentum schedule of Dozat (2016)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self._m_schedule = {}

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        t = self._index_update_count[index]
        g = self._grad32(grad, weight, wd)
        mu_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mu_t1 = self.beta1 * (1 - 0.5 * 0.96 ** ((t + 1)
                                                 * self.schedule_decay))
        sched = self._m_schedule.get(index, 1.0) * mu_t
        self._m_schedule[index] = sched
        sched_next = sched * mu_t1
        m, v = state
        m.copy_(self.beta1 * m + (1 - self.beta1) * g)
        v.copy_(self.beta2 * v + (1 - self.beta2) * g * g)
        g_prime = g / (1 - sched)
        m_prime = m / (1 - sched_next)
        v_prime = v / (1 - self.beta2 ** t)
        m_bar = (1 - mu_t) * g_prime + mu_t1 * m_prime
        weight.copy_(weight.float()
                     - lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register("adadelta")
class AdaDelta(Optimizer):
    """Accumulated-delta adaptive method: no learning rate; `rho` and
    `epsilon` set the step."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _update(self, index, weight, grad, state):
        self._update_count(index)
        g = self._grad32(grad, weight, self._get_wd(index))
        acc_g, acc_d = state
        acc_g.copy_(self.rho * acc_g + (1 - self.rho) * g * g)
        step = (acc_d + self.epsilon).sqrt() / (acc_g + self.epsilon).sqrt() \
            * g
        acc_d.copy_(self.rho * acc_d + (1 - self.rho) * step * step)
        weight.copy_(weight.float() - step)


@register("dcasgd")
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the stale gradient compensated
    by lamda * g^2 * (w - w_prev). One device trains synchronously, so
    the term is usually zero."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def _create_state(self, index, weight):
        mom = _zeros32(weight) if self.momentum else None
        return (mom, weight.detach().float().clone())

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        w32 = weight.float()
        g = self._grad32(grad, w32, wd)
        mom, prev = state
        comp = g + self.lamda * g * g * (w32 - prev)
        if mom is not None:
            mom.copy_(self.momentum * mom - lr * comp)
            new_w = w32 + mom
        else:
            new_w = w32 - lr * comp
        prev.copy_(new_w)
        weight.copy_(new_w)


@register("sgld")
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: an SGD half-step plus
    Gaussian noise scaled by sqrt(lr), drawn from the weight's device
    stream."""

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        w32 = weight.float()
        g = self._grad32(grad, w32, wd)
        noise = torch.randn(weight.shape, generator=_random.generator(
            weight.device), device=weight.device) * math.sqrt(lr)
        weight.copy_(w32 - lr / 2 * g + noise)


@register("ftml")
class FTML(Optimizer):
    """Follow the Moving Leader (Zheng and Kwok, 2017)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight), _zeros32(weight))

    def _update(self, index, weight, grad, state):
        lr, wd = self._hyper(index)
        t = self._index_update_count[index]
        g = self._grad32(grad, weight, wd)
        d, v, z = state
        v.copy_(self.beta2 * v + (1 - self.beta2) * g * g)
        d_t = (1 - self.beta1 ** t) / lr * (
            (v / (1 - self.beta2 ** t)).sqrt() + self.epsilon)
        sigma = d_t - self.beta1 * d
        z.copy_(self.beta1 * z + (1 - self.beta1) * g - sigma * weight.float())
        d.copy_(d_t)
        weight.copy_(-z / d_t)
