"""`mx.mod`: the classic symbolic training API (counterpart of
`mxnet_tpu/module/__init__.py`; reference: `python/mxnet/module/`).

`BaseModule.fit()` (the epoch loop with metric, callbacks and
checkpoints), `score`, `predict`, `forward_backward`; `Module` binds ONE
executor (`symbol.executor`) on one device; `BucketingModule` keeps one
Module per bucket key over one shared parameter store (the same NDArray
objects); `save_checkpoint` / `load_checkpoint`.

The files are the JAX package's: `prefix-symbol.json` (`Symbol.tojson`),
`prefix-%04d.params` (`nd.save`'s npz with `arg:` and `aux:` keys) and
the pickled `.states` of `save_optimizer_states` (numpy inside), so each
package loads the other's checkpoint and states.

`Module(context=...)` is honoured, as `Block.initialize(ctx=)` is: an
explicit `mx.cpu()` runs on the CPU, and None resolves to the card (the
JAX package ignores `context`). `kvstore` is accepted and ignored, as in
the JAX package. `Module.update` runs the optimizer's `update_multi`
over every parameter with a gradient when the optimizer has one (Adam
and AdamW: one kernel launch a weight dtype a step, with the results of
the JAX package's per-index `update`), else `update` per index.
"""
from __future__ import annotations

import logging
import pickle
from collections import namedtuple

import numpy as _np
import torch

from .. import context as _context
from .. import initializer as _init_mod
from .. import metric as _metric
from .. import optimizer as _opt
from ..base import MXNetError
from ..ndarray import ndarray as _nd
from ..ndarray.ndarray import NDArray

__all__ = ["BaseModule", "Module", "BucketingModule", "BatchEndParam",
           "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Reference: `mx.model.save_checkpoint`: symbol JSON + params file."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_checkpoint(prefix, epoch, ctx=None):
    """Reference: `mx.model.load_checkpoint`: (symbol, arg_params,
    aux_params), the arrays on `ctx` (the CPU unless the caller names a
    device: host arrays until a module binds them, as the reference
    loads them)."""
    from .. import symbol as _sym
    symbol = _sym.load(f"{prefix}-symbol.json")
    loaded = _nd.load(f"{prefix}-{epoch:04d}.params",
                      ctx=_context.cpu() if ctx is None else ctx)
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        tag, name = k.split(":", 1)
        (arg_params if tag == "arg" else aux_params)[name] = v
    return symbol, arg_params, aux_params


class BaseModule:
    """The epoch loop (reference: module/base_module.py `fit`)."""

    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger(__name__)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    # -- subclass surface ------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    # -- shared loop -----------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, batch_end_callback=None,
              reset=True, epoch=0):
        if isinstance(eval_metric, str):
            eval_metric = _metric.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, batch in enumerate(eval_data):
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback:
                param = BatchEndParam(epoch, nbatch, eval_metric, locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True):
        """The outputs over `eval_data` (less each batch's padding),
        concatenated, on the module's device."""
        if reset:
            eval_data.reset()
        outputs = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            pad = getattr(batch, "pad", 0) or 0
            row = [o._t for o in self.get_outputs()]
            if pad:
                row = [o[:o.shape[0] - pad] for o in row]
            outputs.append(row)
        if not outputs:
            return []
        return [NDArray(torch.cat([row[i] for row in outputs]))
                for i in range(len(outputs[0]))]

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, initializer=None,
            arg_params=None, aux_params=None, allow_missing=False,
            force_rebind=False, force_init=False, begin_epoch=0,
            num_epoch=None, validation_metric=None):
        """The classic training loop (reference: `BaseModule.fit`)."""
        if num_epoch is None:
            raise MXNetError("fit: num_epoch is required")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if isinstance(eval_metric, str):
            eval_metric = _metric.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback:
                    param = BatchEndParam(epoch, nbatch, eval_metric,
                                          locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data:
                res = self.score(eval_data, validation_metric, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _desc_name_shape(d):
    """DataDesc | (name, shape) -> (name, shape)."""
    if hasattr(d, "name"):
        return d.name, tuple(d.shape)
    name, shape = d[0], d[1]
    return name, tuple(shape)


class Module(BaseModule):
    """Single-executor symbolic module (reference: module/module.py)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = context
        self._fixed_param_names = set(fixed_param_names or [])
        self._exec = None
        self._optimizer = None
        self._opt_states = {}
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]

    @property
    def symbol(self):
        return self._symbol

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False):
        if self.binded and not force_rebind:
            return
        shapes = {}
        for d in data_shapes or []:
            name, shape = _desc_name_shape(d)
            shapes[name] = shape
        for d in label_shapes or []:
            name, shape = _desc_name_shape(d)
            shapes[name] = shape
        grad_req = {n: ("null" if (n in self._data_names
                                   or n in self._label_names
                                   or n in self._fixed_param_names
                                   or not for_training)
                        else "write")
                    for n in self._symbol.list_arguments()}
        self._exec = self._symbol.simple_bind(ctx=self._context,
                                              grad_req=grad_req, **shapes)
        self._for_training = for_training
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        # kvstore is accepted for MXNet's sake: one device, nothing to
        # aggregate
        if self.optimizer_initialized and not force_init:
            return
        params = dict(optimizer_params or {})
        idx2name = dict(enumerate(self._param_names))
        self._optimizer = _opt.create(optimizer, param_idx2name=idx2name,
                                      **params)
        self._opt_states = {}
        self.optimizer_initialized = True
        # Module.load(load_optimizer_states=True): restore states now that
        # an optimizer exists (init_params runs before init_optimizer in
        # fit(), so the restore must happen here)
        pre = getattr(self, "_preloaded", None)
        if pre is not None and pre[2]:
            self.load_optimizer_states(pre[2])

    # ------------------------------------------------------------------
    def install_monitor(self, mon):
        """Attach a `mx.monitor.Monitor`: records the executor's outputs,
        params, and grads on activated batches (reference:
        Module.install_monitor)."""
        self._monitor = mon
        mon._params = None  # this path feeds mon._activations directly

    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise MXNetError("forward: call bind first")
        if is_train is None:  # reference default: the bind-time flag
            is_train = getattr(self, "_for_training", False)
        feed = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feed[name] = arr
        if data_batch.label:
            for name, arr in zip(self._label_names, data_batch.label):
                feed[name] = arr
        self._exec.forward(is_train=bool(is_train), **feed)
        mon = getattr(self, "_monitor", None)
        if mon is not None and mon.activated:
            outs = self._exec.outputs
            out_names = self._symbol.list_outputs()
            for i, o in enumerate(outs):
                tag = out_names[i] if i < len(out_names) else f"output{i}"
                mon._activations.append((tag, o))
            for name in self._param_names:
                mon._activations.append((name, self._exec.arg_dict[name]))
                if mon.monitor_gradient:
                    g = self._exec.grad_dict.get(name)
                    if g is not None:
                        mon._activations.append((name + "_grad", g))

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        """One optimizer step over every parameter with a gradient, in
        place: `update_multi` over the list when the optimizer has it,
        else `update` per index."""
        if not self.optimizer_initialized:
            raise MXNetError("update: call init_optimizer first")
        indices, weights, grads, states = [], [], [], []
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict[name]
            if grad is None:
                continue
            weight = self._exec.arg_dict[name]._t
            if i not in self._opt_states:
                self._opt_states[i] = self._optimizer.create_state(i, weight)
            indices.append(i)
            weights.append(weight)
            grads.append(grad._t)
            states.append(self._opt_states[i])
        with torch.no_grad():
            if hasattr(self._optimizer, "update_multi"):
                if indices:
                    self._optimizer.update_multi(indices, weights, grads,
                                                 states)
            else:
                for i, w, g, s in zip(indices, weights, grads, states):
                    self._optimizer.update(i, w, g, s)

    def get_outputs(self):
        return self._exec.outputs

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------
    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: a.copy() for n, a in self._exec.aux_dict.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    def save_optimizer_states(self, fname):
        states = {i: _state_to_np(s) for i, s in self._opt_states.items()}
        with open(fname, "wb") as f:
            pickle.dump({"states": states,
                         "num_update": self._optimizer.num_update,
                         "index_update_count":
                             dict(self._optimizer._index_update_count)}, f)

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        device = self._exec._device if self._exec is not None else None
        self._opt_states = {i: _state_from_np(s, device)
                            for i, s in blob["states"].items()}
        self._optimizer.num_update = blob["num_update"]
        # restore per-index step counts so Adam-style bias correction
        # continues from t instead of resetting to t=1 on resume
        counts = blob.get("index_update_count")
        if counts is None:  # older checkpoints: seed every index at num_update
            counts = {i: blob["num_update"] for i in blob["states"]}
        self._optimizer._index_update_count.update(counts)

    @classmethod
    def load(cls, prefix, epoch, load_optimizer_states=False, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        mod = cls(symbol, **kwargs)
        mod._preloaded = (arg_params, aux_params,
                          f"{prefix}-{epoch:04d}.states"
                          if load_optimizer_states else None)
        return mod

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        pre = getattr(self, "_preloaded", None)
        if pre is not None and arg_params is None:
            arg_params, aux_params = pre[0], pre[1]
        self._init_params_impl(initializer, arg_params, aux_params,
                               allow_missing, force_init)

    def _init_params_impl(self, initializer, arg_params, aux_params,
                          allow_missing, force_init):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params: call bind first")
        initializer = initializer or _init_mod.Uniform(0.01)
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params and name in arg_params:
                arr._t = _np_to(arg_params[name], arr)
            else:
                if arg_params and not allow_missing:
                    raise MXNetError(
                        f"init_params: '{name}' missing from arg_params "
                        f"(pass allow_missing=True to initialize it)")
                arr._t = initializer.init_array(name, arr.shape, arr._t.dtype,
                                                device=arr._t.device)
        for name, arr in self._exec.aux_dict.items():
            if aux_params and name in aux_params:
                arr._t = _np_to(aux_params[name], arr)
            else:
                arr._t = initializer.init_array(name, arr.shape, arr._t.dtype,
                                                device=arr._t.device)
        self.params_initialized = True


def _np_to(src, like):
    """`src` (an NDArray, tensor or array-like) as a new tensor of
    `like`'s dtype on its device."""
    t = src._t if isinstance(src, NDArray) else torch.as_tensor(
        _np.asarray(src))
    if tuple(t.shape) != like.shape:
        raise MXNetError(
            f"param shape mismatch: got {tuple(t.shape)}, "
            f"expected {like.shape}")
    return t.detach().to(device=like._t.device, dtype=like._t.dtype).clone()


def _state_to_np(state):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_to_np(s) for s in state)
    return state.asnumpy() if isinstance(state, NDArray) else state


def _state_from_np(state, device):
    """An optimizer state of the `.states` file as NDArrays on device."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_state_from_np(s, device) for s in state)
    return _nd.array(_np.array(state), ctx=device, dtype=state.dtype)


class BucketingModule(BaseModule):
    """Variable-length training: one Module per bucket key, a single
    shared parameter store (reference: module/bucketing_module.py)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=None,
                 context=None, **kwargs):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets = {}
        self._curr = None
        self._init_args = None

    @property
    def symbol(self):
        return self._curr.symbol if self._curr else None

    def _get_module(self, key, data_shapes, label_shapes, for_training=True):
        if key not in self._buckets:
            symbol, data_names, label_names = self._sym_gen(key)
            mod = Module(symbol, data_names, label_names,
                         logger=self.logger, context=self._context,
                         **self._kwargs)
            mod.bind(data_shapes, label_shapes, for_training=for_training)
            if self._curr is not None:
                # share params with the master module: alias the SAME
                # NDArray objects so every bucket sees every update
                master = self._buckets[self._default_key]
                for n in mod._param_names:
                    if n in master._exec.arg_dict:
                        mod._exec.arg_dict[n] = master._exec.arg_dict[n]
                        mod._exec.grad_dict[n] = master._exec.grad_dict[n]
                for n in list(mod._exec.aux_dict):
                    if n in master._exec.aux_dict:
                        mod._exec.aux_dict[n] = master._exec.aux_dict[n]
                mod.params_initialized = True
                mod._optimizer = master._optimizer
                mod._opt_states = master._opt_states
                mod.optimizer_initialized = master.optimizer_initialized
            elif self._init_args:
                mod.init_params(**self._init_args)
            self._buckets[key] = mod
        return self._buckets[key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False):
        self._for_training = for_training
        mod = self._get_module(self._default_key, data_shapes, label_shapes,
                               for_training)
        self._curr = mod
        self.binded = True

    def init_params(self, **kwargs):
        self._init_args = kwargs
        self._curr.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        self._curr.init_optimizer(**kwargs)
        for mod in self._buckets.values():
            mod._optimizer = self._curr._optimizer
            mod._opt_states = self._curr._opt_states
            mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        self._curr = self._get_module(bucket_key, data_shapes, label_shapes,
                                      getattr(self, "_for_training", True))

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_key)
        if key != (self._curr and getattr(self._curr, "_bucket_key", None)):
            shapes = [(n, a.shape) for n, a in
                      zip(self._curr._data_names, data_batch.data)]
            lshapes = [(n, a.shape) for n, a in
                       zip(self._curr._label_names, data_batch.label or [])]
            self.switch_bucket(key, shapes, lshapes or None)
            self._curr._bucket_key = key
        self._curr.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr.backward(out_grads)

    def update(self):
        self._curr.update()

    def get_outputs(self):
        return self._curr.get_outputs()

    def update_metric(self, eval_metric, labels):
        self._curr.update_metric(eval_metric, labels)

    def get_params(self):
        return self._buckets[self._default_key].get_params()
