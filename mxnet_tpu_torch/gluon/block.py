"""Block (counterpart of `mxnet_tpu/gluon/block.py`).

A Block is a thin `torch.nn.Module`. Attribute paths name parameters
exactly as the JAX package's `collect_params()` does
(`gpt.layers.0.attn.qkv.weight`), so carrying weights between the two
packages is the identity on names. `collect_params()` lists every path,
so a block added twice (`net.add(shared, shared)`) lists its parameters
under both, as the JAX package's does; `gluon.Trainer` updates each
parameter object once.

MXNet's classic surface is here: `Block(prefix=None, params=None)`,
`name_scope()`, `register_child`, `_children` (name -> child), `params`
(this block's own parameters), `summary(*inputs)` (the JAX table; it
refuses a hybridized tree), `Sequential` and `functional_call`. A
`HybridBlock` subclass may define `hybrid_forward(F, *args, **params)`
instead of `forward`: F is the port's `nd` in an eager call (the block's
registered parameters are passed by name as NDArrays, so the block's
arithmetic records on torch's tape), and `sym` when `export` traces the
block into a symbolic graph. PyTorch runs eagerly, so `hybridize()`
compiles nothing: a hybridized block keeps the JAX package's cache keys
(input shapes and dtypes, the training flag, the trainable and auxiliary
parameter counts) in `_cache`, each with the count of calls that had it,
and no executable. A key's first call is where the JAX package compiles:
there the observers record it (`compile_total`, `compile_seconds`, a
compile or recompile event with the signature diff, a flight-ring
compile record, a `compile` span, an inspect cost record), mx.check
records the call (`check.StepRecord`, inside inspect's counting pass
when both are on) and lints it (`check.check_jit`; under check=error
the key is forgotten and CheckError propagates), and later calls count
`hybrid_cache_hits_total`. With memsafe armed, that first call is
budget-checked on its parameters and inputs before it runs
(`memsafe.check_budget`; a MemoryBudgetError forgets the key).

A block starts in evaluation mode (`training` False), as the JAX
package runs outside a train step; `train()` (what the trainer's step
sets around its forward) turns dropout on, `eval()` off. An active
autograd scope overrides the block's flag (`training(block)`).

A call with an NDArray among its arguments is a call at the user's
boundary: the block runs on the held tensors and its tensor outputs come
back as NDArrays. Inside `autograd.record()` a call lets the block's
trainable parameters record gradients (once per block).

Whose `forward` runs on what: the port's own layers and models (every
class whose `forward` is defined in a module of this package) compute
on torch tensors. A block whose `forward` is defined anywhere else — a
user's `HybridBlock` subclass written as MXNet users write one, with
`.astype`, `.reshape`, `nd.arange` and `h.sum(axis=1)` — is the user's,
and its forward receives NDArrays, as the JAX package passes them
(`_user_forward`, decided once per class from
`type(block).forward.__module__`). Tensors given to such a block (by a
port layer that holds it, or by `ShardedTrainer`'s `functional_call`)
are wrapped into NDArrays before its forward and its outputs are
unwrapped after it, so the caller gets what it gave; NDArrays hold the
very tensors, so gradients flow through them unchanged. A
`hybrid_forward` block keeps `HybridBlock.forward`, which hands
`hybrid_forward` NDArrays itself.

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

import contextlib
import re
import time

import torch

from .. import autograd as _autograd
from .. import check as _check
from .. import context
from .. import diagnostics as _diagnostics
from .. import initializer as _init
from .. import inspect as _inspect
from .. import memsafe as _memsafe
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..ndarray.ndarray import NDArray
from .parameter import ParameterDict, dtype_of, finish_deferred

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "functional_call", "training"]

_M_CACHE_HITS = _telemetry.counter(
    "hybrid_cache_hits_total", "hybridized calls at a signature seen "
    "before (the JAX package's jit-cache hits)")
_M_CACHE_MISSES = _telemetry.counter(
    "hybrid_cache_misses_total", "hybridized calls at a new signature "
    "(the JAX package's jit-cache misses)")
_M_COMPILES = _telemetry.counter(
    "compile_total", "first calls at a new signature (hybridized blocks "
    "and ShardedTrainer steps; PyTorch compiles nothing, so this counts "
    "where the JAX package compiles)")
_M_RECOMPILES = _telemetry.counter(
    "recompile_total", "new signatures after the first for the same "
    "block/step (shape/dtype churn)")
_M_COMPILE_SECONDS = _telemetry.histogram(
    "compile_seconds", "wall time of the first call at a new signature")


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


_PORT_PACKAGE = __name__.split(".")[0]
_user_forward_of = {}


def _user_forward(cls):
    """True when `cls.forward` is the user's: defined outside this
    package (then it computes on NDArrays)."""
    user = _user_forward_of.get(cls)
    if user is None:
        module = getattr(cls.forward, "__module__", None) or ""
        user = not (module == _PORT_PACKAGE
                    or module.startswith(_PORT_PACKAGE + "."))
        _user_forward_of[cls] = user
    return user


class Block(torch.nn.Module):
    # True on a block that consumes remat policies per layer (BERTModel,
    # GPTModel); any other block's policy wraps its whole forward in the
    # trainer (`memsafe.block_wrap_policy`)
    _remat_handles_policy = False

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self.training = False
        self._mx_recorded = False
        self._remat_policy = None
        self.prefix = prefix or ""

    @property
    def _children(self):
        """{name: child block} in registration order."""
        return self._modules

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)
        return block

    @property
    def params(self):
        """This block's own parameters (not its children's), by name."""
        return ParameterDict((n, p) for n, p in self._parameters.items()
                             if p is not None)

    @contextlib.contextmanager
    def name_scope(self):
        """Kept for MXNet's sake: names are attribute paths."""
        yield self

    def __call__(self, *args, **kwargs):
        if args and not isinstance(args[0], (torch.Tensor, NDArray)) \
                and _is_symbol(args[0]):
            return self._symbolic(*args, **kwargs)
        if _autograd._recording and not self._mx_recorded:
            self._attach_grads()
        if self.__dict__.get("_active") and not kwargs and all(
                isinstance(a, NDArray) for a in args):
            key, is_miss = self._note_signature(args)
            if is_miss and _memsafe._enabled:
                try:                    # no execution peak before it runs
                    _memsafe.check_budget(
                        type(self).__name__, None, _memsafe.resident_bytes(
                            [a._t for a in args] + list(self.parameters())))
                except _memsafe.MemoryBudgetError:
                    self._cache.pop(key, None)  # the next call checks again
                    raise
            if is_miss and (_telemetry._enabled or _diagnostics._enabled
                            or _trace._enabled or _inspect._enabled
                            or _check._enabled):
                return self._observed_first_call(args, key)
            if not is_miss and _telemetry._enabled:
                _M_CACHE_HITS.inc()
        return self._mx_call(args, kwargs)

    def _mx_call(self, args, kwargs):
        at_boundary = any(isinstance(a, NDArray) for a in args)
        if _user_forward(type(self)):
            out = super().__call__(
                *[_wrap(x) for x in args],
                **{k: _wrap(v) for k, v in kwargs.items()})
            return _wrap(out) if at_boundary else _as_tensor(out)
        if at_boundary:
            return _wrap(super().__call__(
                *[_unwrap(x) for x in args],
                **{k: _unwrap(v) for k, v in kwargs.items()}))
        return super().__call__(*args, **kwargs)

    def _attach_grads(self):
        """Let every trainable floating-point parameter of this subtree
        record gradients (`autograd.record()`'s first forward), each
        with a zeroed gradient buffer where it has none: MXNet's buffer,
        so `p.grad()` of a parameter that no backward reaches reads
        zeros, as in the JAX package."""
        for p in self.parameters():
            if p.grad_req != "null" and p.is_floating_point():
                _autograd.attach_grad_req(p)
                if p.grad is None:
                    p.grad = torch.zeros_like(p.detach())
        for m in self.modules():
            if isinstance(m, Block):
                m._mx_recorded = True

    def _symbolic(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} has no symbolic form in the port, so "
            "export cannot trace it (ROADMAP.md queue 1, \"Left for later "
            "PRs\")")

    def hybridize(self, active=True, **kwargs):
        """Set every HybridBlock of the tree hybridized (`active`); PyTorch
        runs eagerly, so nothing is compiled."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)
        return self

    def collect_params(self, select=None):
        """All parameters of this subtree keyed by dotted path (optionally
        filtered by a regex); a parameter reachable under two paths is
        listed under both."""
        return ParameterDict(
            (path, p) for path, p in self.named_parameters(
                remove_duplicate=False)
            if select is None or re.search(select, path))

    def summary(self, *inputs):
        """Print and return a table of each block's output shape and
        parameter count for one forward of `inputs`, with the totals (the
        JAX package's text). A hybridized tree is refused, as there."""
        if any(getattr(m, "_active", False) for m in self.modules()):
            raise ValueError(
                "summary() needs the eager forward; call it before "
                "hybridize() (or after hybridize(active=False))")
        rows, handles = [], []

        def install(block, path):
            def hook(blk, ins, out, _path=path):
                outs = out if isinstance(out, (list, tuple)) else [out]
                shape = ", ".join(str(tuple(o.shape)) for o in outs
                                  if hasattr(o, "shape"))
                n_params = sum(p.numel() for p in blk._parameters.values()
                               if p is not None)
                rows.append((f"{_path}({type(blk).__name__})", shape,
                             n_params))
            handles.append(block.register_forward_hook(hook))
            for cname, child in block._modules.items():
                install(child, f"{path}.{cname}" if path else cname)

        install(self, "")
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.remove()
        params = list(self.named_parameters(remove_duplicate=False))
        total = sum(p.numel() for _, p in params)
        trainable = sum(p.numel() for _, p in params
                        if getattr(p, "grad_req", "write") != "null")
        width = max([len(r[0]) for r in rows] + [20])
        lines = ["-" * (width + 40),
                 f"{'Layer (type)':<{width}}  {'Output Shape':<24} Param #",
                 "=" * (width + 40)]
        for name, shape, n in rows:
            lines.append(f"{name:<{width}}  {shape:<24} {n}")
        lines += ["=" * (width + 40),
                  f"Total params: {total}",
                  f"Trainable params: {trainable}",
                  f"Non-trainable params: {total - trainable}",
                  "-" * (width + 40)]
        text = "\n".join(lines)
        print(text)
        return text

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, device=None, generator=None):
        """Fill every parameter not yet initialised in place (every one
        with `force_reinit`): `init` when given, else the parameter's own
        initializer, else uniform (the JAX package's precedence), through
        the name rule of `Initializer.init_array` (biases and betas 0,
        gammas 1); a `Constant` keeps its value. `ctx` (a Context or a
        torch.device, MXNet's keyword) or `device` moves the block first;
        `verbose` is accepted and prints nothing, as in the JAX package;
        without either, the parameters that no caller placed (a bare
        layer's, `parameter.Parameter`) go to the entered context's
        device, else to the card where there is one;
        `generator` is the explicit random source (its device must be the
        parameters'), else the device stream of `random.seed`. A deferred
        parameter draws nothing now: the choice is recorded and applied
        when its first forward gives it a shape."""
        if ctx is not None and device is not None:
            raise TypeError("initialize: pass ctx or device, not both")
        device = ctx if device is None else device
        if device is not None:
            self.to(context.resolve(device))
        else:
            self._place_unplaced()
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

    def _place_unplaced(self):
        """Move the parameters allocated outside any device request to
        the default device: the entered context's, else the card (none
        where there is no card and no context: they stay)."""
        ctx = context.entered()
        if ctx is None and not torch.cuda.is_available():
            return
        dev = context.resolve(ctx)
        for p in self.parameters():
            if not getattr(p, "mx_placed", True) and p.device != dev:
                p.data = p.data.to(dev)
                p.mx_placed = True

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


def _is_symbol(x):
    from ..symbol import Symbol
    return isinstance(x, Symbol)


def _as_tensor(x):
    if isinstance(x, NDArray):
        return x._t
    if isinstance(x, (tuple, list)):
        return type(x)(_as_tensor(o) for o in x)
    return x


class HybridBlock(Block):
    """A Block that may define `hybrid_forward(F, *args, **params)`, and
    that `hybridize()` marks (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._cache = {}
        self._tele_sig = None     # last new input signature (telemetry)

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._cache = {}
        return super().hybridize(active, **kwargs)

    def _note_signature(self, args):
        """Count a hybridized call under the JAX package's cache key;
        returns (key, whether the key is new: the JAX package's cache
        miss)."""
        n_grad = sum(1 for _, p in self.named_parameters(
            remove_duplicate=False) if p.grad_req != "null")
        n_all = sum(1 for _ in self.named_parameters(remove_duplicate=False))
        key = (tuple((a.shape, str(a.dtype)) for a in args),
               bool(training(self)), n_grad, n_all - n_grad)
        n = self._cache.get(key, 0)
        self._cache[key] = n + 1
        return key, n == 0

    def _observed_first_call(self, args, key):
        """The first call at a new signature with an observer on: timed
        as the JAX package times its trace and compile (telemetry's
        compile accounting and signature diff, a flight-ring compile
        record, an always-recorded `compile` span) and, with inspect on,
        counted by `inspect.count_step`."""
        name = type(self).__name__
        t0 = time.perf_counter()
        record = None
        if _check._enabled:
            record = _check.StepRecord(
                known=[a._t for a in args] + list(self.parameters())
                + list(self.buffers()))
        if _inspect._enabled:
            out = _inspect.count_step(
                name, _inspect.key_repr(key), lambda: self._mx_call(args, {}),
                args=[a._t for a in args] + list(self.parameters()),
                observer=record)
        elif record is not None:
            out = record.run(lambda: self._mx_call(args, {}))
        else:
            out = self._mx_call(args, {})
        dt = time.perf_counter() - t0
        if record is not None:
            try:
                _check.check_jit(name, key, record,
                                 owner=_check.owner_token(self),
                                 params=list(self.parameters()))
            except _check.CheckError:
                # check=error: forget the key, so the next call at it
                # records and raises again
                self._cache.pop(key, None)
                raise
        if _telemetry._enabled:
            _, train, n_grad, n_aux = key
            _M_CACHE_MISSES.inc()
            _M_COMPILES.inc()
            _M_COMPILE_SECONDS.observe(dt)
            sig = _telemetry.signature(args, train=train, n_grad=n_grad,
                                       n_aux=n_aux)
            causes, changed = _telemetry.diff_signature(self._tele_sig, sig)
            kind = "compile" if self._tele_sig is None else "recompile"
            if self._tele_sig is not None:
                _M_RECOMPILES.inc()
            self._tele_sig = sig
            _telemetry.event(kind, block=name, compile_time_s=round(dt, 6),
                             causes=causes, changed=changed, signature=sig)
        if _diagnostics._enabled:
            _diagnostics.record_event(
                "compile", block=name, compile_time_s=round(dt, 6),
                shapes=[list(a.shape) for a in args])
        if _trace._enabled:
            _trace.record_span("compile", t0, t0 + dt, cat="compile",
                               always=True, block=name)
        return out

    def _reg_params(self):
        return [(n, p) for n, p in self._parameters.items() if p is not None]

    def forward(self, *args, **kwargs):
        """`hybrid_forward(nd, *args, **params, **kwargs)` on NDArrays,
        with this block's parameters by name; deferred ones take their
        shapes from the first input first."""
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(
                f"{type(self).__name__} defines neither forward nor "
                "hybrid_forward")
        from .. import ndarray as nd
        if args and any(getattr(p, "mx_deferred", False)
                        for _, p in self._reg_params()):
            self._resolve_deferred(args[0])
        def wrap(a):
            return NDArray(a) if isinstance(a, torch.Tensor) else a
        params = {n: NDArray(p) for n, p in self._reg_params()}
        out = self.hybrid_forward(
            nd, *map(wrap, args), **params,
            **{k: wrap(v) for k, v in kwargs.items()})
        return _as_tensor(out)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def _symbolic(self, *args, **kwargs):
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            return super()._symbolic(*args, **kwargs)
        from .. import symbol as sym
        params = {n: sym.var(self._export_names[n])
                  for n, _ in self._reg_params()}
        return self.hybrid_forward(sym, *args, **params, **kwargs)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from `args` by one eager
        forward, without recording."""
        with torch.no_grad():
            self(*args)

    def export(self, path, epoch=0):
        """Write `path-symbol.json` (the block traced with F = `sym` from
        one input `data`; every parameter a variable named by its
        `collect_params` path) and `path-%04d.params` (`save_parameters`:
        the JAX package's file), which `gluon.SymbolBlock.imports` reads
        back. Each block of the tree needs a symbolic form: a
        `hybrid_forward`, or one of the layers that have one."""
        from .. import symbol as sym
        named = {}
        for prefix, m in self.named_modules(remove_duplicate=False):
            if id(m) not in named:
                named[id(m)] = prefix
        for m in self.modules():
            base = named[id(m)]
            m._export_names = {
                n: f"{base}.{n}" if base else n
                for n, p in m._parameters.items() if p is not None}
        try:
            out = self(sym.var("data"))
        finally:
            for m in self.modules():
                del m._export_names
        out.save(f"{path}-symbol.json")
        self.save_parameters(f"{path}-{epoch:04d}.params")


class Sequential(Block):
    """Children registered as "0", "1", ... in insertion order; a forward
    runs them one after the other."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
        return x

    def _symbolic(self, x, *args):
        return self.forward(x, *args)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class HybridSequential(HybridBlock):
    """The hybridizable Sequential."""

    add = Sequential.add
    forward = Sequential.forward
    _symbolic = Sequential._symbolic
    __iter__ = Sequential.__iter__
    __len__ = Sequential.__len__
    __getitem__ = Sequential.__getitem__


def functional_call(block, train=True):
    """(fn, grad_params, aux_params) of `block`: fn(gp_data, aux_data,
    rng, *inputs) -> (outputs, new_aux) runs the block's forward with the
    given tensors in place of its parameters (trainable ones, then the
    'null' ones, in `collect_params` order), in training mode when
    `train`, as the JAX package's functionalization does. `rng` is
    accepted for the signature's sake: the port's random streams are
    process state (`random`)."""
    grad_params, aux_params = [], []
    for path, p in block.collect_params().items():
        (aux_params if p.grad_req == "null" else grad_params).append(
            (path, p))

    def fn(gp_data, aux_data, rng, *inputs):
        values = {path: _as_tensor(d) for (path, _), d in
                  zip(grad_params + aux_params, list(gp_data)
                      + list(aux_data))}
        prev = _autograd.set_training(train)
        try:
            out = torch.func.functional_call(
                block, values, tuple(_as_tensor(a) for a in inputs),
                strict=False, tie_weights=False)
        finally:
            _autograd.set_training(prev)
        return out, [values[path] for path, _ in aux_params]

    return fn, grad_params, aux_params
