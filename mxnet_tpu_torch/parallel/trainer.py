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

LAMB's moments are stored in the `lamb_moments_dtype` knob's dtype
(float32 by default, or bfloat16: `FusedLamb`), read when the trainer
collects its parameters.

Checkpoints (the JAX package's `_state_pytree` layout, per tensor):
`save_states(directory)` writes the float32 master (or, on the
per-parameter path, each parameter in its dtype), the optimizer state of
each tensor (LAMB's m and v in their storage dtype), the aux tensors
(BatchNorm's running statistics), `num_update` and the state of the
port's random streams (`random.get_state`: the host stream that seeds
every flash-dropout Philox mask and each device stream), so a restored
trainer's next step equals an uninterrupted one's bit for bit. The JAX
package writes this with orbax, which the port cannot read or write: the
port's payload is one `torch.save` file of CPU tensors, `state.pt`,
read back with `weights_only=True`. On the card every resident tensor
is copied into pinned host buffers the trainer keeps (one a dtype), with
one sync.
While `resilience` is enabled the write goes through
`resilience.write_checkpoint` (temp directory, manifest with sizes and
CRC32, atomic rename) and `load_states` verifies checksums and the
fingerprint first. `load_states` copies the tensors back into the
resident flat layout in place. `save_checkpoint(prefix)` writes the
parameters to `prefix.params` (`Block.save_parameters`).

Hooks, as in the JAX package's step: with memsafe armed (`oom_recover`
or `device_bytes_limit` set) an out-of-memory raised before the
optimizer touched any state walks the degradation ladder
(`memsafe.recover_trainer`), the failed attempt's frames released and
its random draws rewound; with resilience enabled the `oom` fault fires
at the step's dispatch (`fault_point("dispatch")`), `on_step` runs
after the update (periodic checkpoint, fault injection, preemption
exit), and construction auto-resumes under the `resume` knob
(`on_trainer_init`). A block whose remat policy no layer structure
consumes (`memsafe.block_wrap_policy`) runs its whole forward under that
policy's checkpoint.

Single device and `param_mode="replicate"` only: meshes, fsdp/tp
modes, zero, guard, check and telemetry are not in the port yet.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch.func import functional_call

from .. import config as _config
from .. import context
from .. import memsafe as _memsafe
from .. import optimizer as opt_mod
from .. import random as _random
from .. import resilience as _resilience
from ..models import _remat
from ..ndarray.ndarray import NDArray
from .functional_opt import FunctionalOptimizer
from .fused_lamb import FusedLamb

_STATE_FILE = "state.pt"
_STATE_FORMAT = "mxnet_tpu_torch.ShardedTrainer/1"

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


@contextlib.contextmanager
def _zip_crc32(on):
    """torch.save with (default) or without the CRC32 of each zip record,
    where this torch has the switch."""
    try:
        from torch.utils.serialization import config as ser
    except ImportError:
        ser = None
    if on or ser is None:
        yield
        return
    prev, ser.save.compute_crc32 = ser.save.compute_crc32, False
    try:
        yield
    finally:
        ser.save.compute_crc32 = prev


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
        self.param_mode = param_mode
        self._opt = opt_mod.create(optimizer, **(optimizer_params or {}))
        self.num_update = 0
        self._accum = 1
        self._ready = False
        self._state_touched = False
        self._host_bufs = {}            # dtype -> pinned host buffer
        _memsafe.maybe_enable()
        if not any(getattr(p, "mx_deferred", False)
                   for p in block.parameters()):
            self._setup()
        if _resilience._enabled:
            _resilience.on_trainer_init(self)

    def _setup(self):
        block = self.block
        params = [(n, p) for n, p in block.named_parameters()
                  if getattr(p, "grad_req", "write") != "null"]
        for name, p in params:
            if p.device != self.device:
                raise ValueError(f"ShardedTrainer: parameter {name} is on "
                                 f"{p.device}, the trainer on {self.device}")
        self._names = [n for n, _ in params]
        self._aux_names = [n for n, p in block.named_parameters()
                           if getattr(p, "grad_req", "write") == "null"]
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
            o.upper_bound or -1.0,
            moments_dtype=_config.get("lamb_moments_dtype"))
        self.params = self._fl.flatten([p for _, p in params])
        self.opt_state = self._fl.zeros_moments(self.device)
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
        failed = None
        try:
            loss = self._step_once(data, labels)
        except Exception as e:  # noqa: BLE001 - classified below
            if not _memsafe._enabled or not _memsafe.is_oom(e):
                raise
            failed = _memsafe._release(e)
        if failed is not None:
            # outside the handler: the failed attempt's frames are gone
            loss = _memsafe.recover_trainer(self, failed, data, labels)
        if _resilience._enabled:
            _resilience.on_step(self)
        return loss

    def _step_once(self, data, labels):
        """One attempt at the step. With memsafe armed, a failure before
        the optimizer touched any state rewinds the random streams to
        where the attempt found them, so a retry draws the same masks."""
        rng = _random.get_state() if _memsafe._enabled else None
        self._state_touched = False
        try:
            return self._step_impl(data, labels)
        except BaseException:
            if rng is not None and not self._state_touched:
                _random.set_state(rng)
            raise

    def _step_impl(self, data, labels):
        if not self._ready:
            self._finish_setup(data)
        micro = self._microbatches(data, labels)
        t = self.num_update + 1
        if _resilience._enabled:
            # the `oom@step:N` fault fires here, before anything runs
            _resilience.fault_point("dispatch", step=t)
        lr = self.fopt.lr_at(t)
        if self._fl is None:
            leaves = [p.detach().requires_grad_(True) for p in self.params]
            loss, grads = self._accumulate(leaves, lambda: leaves, micro)
            self._state_touched = True
            self.fopt.apply(self.params, grads, self.opt_state, t, lr)
        else:
            master = self.params.detach().requires_grad_(True)
            loss, (grad,) = self._accumulate(
                [master], lambda: self._fl.unflatten(master), micro)
            m, v = self.opt_state
            self._state_touched = True
            self._fl.apply_flat(self.params, grad, m, v, t, lr)
        self.num_update = t
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
        policy = _memsafe.block_wrap_policy(self.block)
        try:
            with torch.enable_grad():
                tensors = views()
                if policy is None:
                    outs = functional_call(self.block,
                                           dict(zip(self._names, tensors)),
                                           tuple(data))
                else:
                    n = len(tensors)
                    outs = _remat.wrap_call(
                        self.block, lambda *a: functional_call(
                            self.block, dict(zip(self._names, a[:n])),
                            a[n:]), list(tensors) + list(data), policy)
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

    # -- checkpoints ------------------------------------------------------
    def save_checkpoint(self, prefix):
        """Write the trained parameters into the block and save them to
        `prefix.params` (`Block.save_parameters`: the JAX package's
        file)."""
        self.sync_to_block()
        self.block.save_parameters(prefix + ".params")

    def _to_host(self, tensors):
        """CPU copies of `tensors`. On the card each goes into its slice of
        a pinned host buffer of its dtype that the trainer keeps (grown
        when too small), and one sync ends the copies; CPU tensors are
        the live ones (they are written before the next step changes
        them)."""
        if self.device.type != "cuda":
            return [t.detach() for t in tensors]
        need = {}
        for t in tensors:
            need[t.dtype] = need.get(t.dtype, 0) + t.numel()
        bufs = self._host_bufs
        for dt, n in need.items():
            if dt not in bufs or bufs[dt].numel() < n:
                bufs.pop(dt, None)
                bufs[dt] = torch.empty(n, dtype=dt, pin_memory=True)
        used = dict.fromkeys(need, 0)
        out = []
        for t in tensors:
            off, n = used[t.dtype], t.numel()
            dst = bufs[t.dtype][off:off + n].view(t.shape)
            dst.copy_(t.detach(), non_blocking=True)
            used[t.dtype] = off + n
            out.append(dst)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _state(self):
        """The checkpoint payload (CPU tensors): the per-tensor layout of
        the JAX package's `_state_pytree`, plus the names and the random
        streams."""
        if not self._ready:
            raise RuntimeError(
                "save_states needs the trainer's parameters: run one step "
                "first (the block still has deferred shapes)")
        aux = [self.block.get_parameter(n) for n in self._aux_names]
        if self._fl is None:
            flat = list(self.params) + [s for st in self.opt_state
                                        for s in st]
        else:
            flat = [self.params, *self.opt_state]
        host = self._to_host(flat + aux)
        flat, aux = host[:len(flat)], host[len(flat):]
        if self._fl is None:
            n = len(self.params)
            params, rest = flat[:n], iter(flat[n:])
            opt_state = [[next(rest) for _ in st] for st in self.opt_state]
        else:
            params = self._fl.unflatten_master(flat[0])
            opt_state = [list(mv) for mv in zip(
                self._fl.unflatten_master(flat[1]),
                self._fl.unflatten_master(flat[2]))]
        return {"format": _STATE_FORMAT, "names": list(self._names),
                "params": params, "aux_names": list(self._aux_names),
                "aux": aux, "opt_state": opt_state,
                "num_update": int(self.num_update),
                "rng": _random.get_state()}

    def _write_state(self, directory, zip_crc=True):
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, _STATE_FILE)
        with open(path, "wb") as f, _zip_crc32(zip_crc):
            torch.save(self._state(), f)
            f.flush()
            os.fsync(f.fileno())

    def save_states(self, directory):
        """Write the train state into `directory` (`state.pt`): atomic and
        verified (`resilience.write_checkpoint`) while resilience is
        enabled, a plain write otherwise. Under the manifest, whose CRC32
        of the whole file is checked before any load, the zip records
        carry none of their own (torch's per-record CRC32 is a third of
        the write's time at BERT-large)."""
        if not _resilience._enabled:
            self._write_state(directory)
            return
        _resilience.write_checkpoint(
            directory, lambda tmp: self._write_state(tmp, zip_crc=False),
            step=int(self.num_update),
            fingerprint=_resilience.trainer_fingerprint(self))

    def load_states(self, directory):
        """Restore a `save_states` directory into this trainer, in place:
        master (or parameters), optimizer state (cast to this trainer's
        moment dtype), aux tensors, `num_update` and the random streams.
        While resilience is enabled and the directory has a manifest,
        checksums and the fingerprint are verified first."""
        directory = str(directory)
        if _resilience._enabled and os.path.exists(
                os.path.join(directory, "manifest.json")):
            manifest = _resilience.verify_checkpoint(directory)
            _resilience.check_fingerprint(
                manifest, _resilience.trainer_fingerprint(self), directory)
        if not self._ready:
            raise RuntimeError(
                "load_states needs the trainer's parameters: run one step "
                "first (the block still has deferred shapes)")
        state = torch.load(os.path.join(directory, _STATE_FILE),
                           map_location="cpu", weights_only=True, mmap=True)
        if state.get("format") != _STATE_FORMAT \
                or state["names"] != self._names \
                or state["aux_names"] != self._aux_names:
            raise ValueError(
                f"{directory}: the checkpoint's parameters do not match "
                "this trainer's (another model or optimizer)")
        with torch.no_grad():
            if self._fl is None:
                for p, src in zip(self.params, state["params"]):
                    p.copy_(src)
                for st, src in zip(self.opt_state, state["opt_state"]):
                    if len(st) != len(src):
                        raise ValueError(f"{directory}: optimizer state of "
                                         "another optimizer")
                    for dst, s in zip(st, src):
                        dst.copy_(s)
            else:
                self._fl.load_flat(self.params, state["params"])
                for i, flat in enumerate(self.opt_state):
                    self._fl.load_flat(flat, [mv[i] for mv in
                                              state["opt_state"]])
            for name, src in zip(self._aux_names, state["aux"]):
                self.block.get_parameter(name).copy_(src)
        self.num_update = int(state["num_update"])
        _random.set_state(state["rng"])

    @property
    def param_count(self):
        if self._fl is None:
            return sum(p.numel() for p in self.params)
        return sum(self._fl.sizes)
