"""Training monitor (counterpart of `mxnet_tpu/monitor.py`; reference:
`python/mxnet/monitor.py` `Monitor`: periodic statistics over layer
outputs, parameters and gradients, regex filtered, printed per batch).

On a gluon Block it records each block's output through torch forward
hooks (a port block runs on tensors inside, so a hook sees tensors and
records them as NDArrays); parameter and gradient statistics come from
`collect_params()`. The classic Module path feeds it through
`Module.install_monitor`.
"""
from __future__ import annotations

import re
import weakref

import torch

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x):
    return x.abs().mean()


class Monitor:
    """Collect activation/param/grad statistics every `interval` batches.

    Usage (matching the reference):
        mon = Monitor(interval=10, pattern='.*fc.*')
        mon.install(net)              # gluon Block (recursive)
        for batch in data:
            mon.tic()
            ... forward/backward/step ...
            mon.toc_print()           # or rows = mon.toc()
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_gradient=True):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.monitor_gradient = monitor_gradient
        self.step = 0
        self.activated = False
        self._activations = []
        self._params = None
        # block -> set of names it is hooked under; weak so a dead block's
        # entry (and its reused id) can never shadow a new block
        self._installed = weakref.WeakKeyDictionary()

    # -- wiring ----------------------------------------------------------
    def install(self, block, prefix=""):
        """Recursively hook a gluon Block; records each child's output when
        the monitor is activated, and registers the block's parameters for
        param/grad statistics. Idempotent per (block, name): a shared block
        reachable under two prefixes reports under both names, and a
        re-install hooks children added since."""
        name = prefix or type(block).__name__.lower()
        hooked_names = self._installed.setdefault(block, set())
        if name not in hooked_names:
            hooked_names.add(name)

            def hook(blk, inputs, output, _name=name):
                if not self.activated:
                    return
                outs = output if isinstance(output, (list, tuple)) \
                    else [output]
                for i, o in enumerate(outs):
                    if isinstance(o, torch.Tensor):
                        o = NDArray(o.detach())
                    if isinstance(o, NDArray):
                        tag = _name if len(outs) == 1 \
                            else f"{_name}_output{i}"
                        self._activations.append((tag, o))

            block.register_forward_hook(hook)
        for cname, child in block.named_children():
            self.install(child, f"{name}.{cname}")
        if prefix == "":
            self._params = block.collect_params()
        return self

    # -- per-batch protocol ---------------------------------------------
    def tic(self):
        """Start a batch; activates collection every `interval` calls."""
        self._activations = []
        self.activated = (self.step % self.interval) == 0
        self.step += 1
        return self.activated

    def toc(self):
        """End the batch: returns [(step, name, stat_value_str)] for every
        recorded activation, parameter, and gradient matching the
        pattern."""
        if not self.activated:
            return []
        rows = []
        for name, arr in self._activations:
            if self.re_pattern.match(name):
                rows.append((self.step - 1, name, self._fmt(arr)))
        if self._params is not None:
            for pname, param in self._params.items():
                if not self.re_pattern.match(pname) \
                        or getattr(param, "mx_deferred", False):
                    continue
                rows.append((self.step - 1, pname,
                             self._fmt(NDArray(param.detach()))))
                if self.monitor_gradient and param.grad_req != "null" \
                        and param.grad is not None:
                    rows.append((self.step - 1, pname + "_grad",
                                 self._fmt(NDArray(param.grad))))
        self.activated = False
        self._activations = []
        if self.sort:
            rows.sort(key=lambda r: r[1])
        return rows

    def toc_print(self):
        rows = self.toc()
        for step, name, stat in rows:
            print(f"Batch: {step:7d} {name:40s} {stat}")
        return rows

    def _fmt(self, arr):
        out = self.stat_func(arr)
        if isinstance(out, NDArray):
            out = float(out.asnumpy().reshape(-1)[0]) \
                if out.size == 1 else out.asnumpy()
        return str(out)
