"""The memory budget check (the budget half of `mxnet_tpu/memsafe.py`).

Serving admits a request only when its bucket's predicted peak fits the
device: resident bytes (parameters, KV caches or the page pool) plus the
step's execution peak, against the capacity. A predicted overrun raises
`MemoryBudgetError` BEFORE any allocation or dispatch, and the server
turns it into its degradation ladder or a 429 verdict — never a device
out-of-memory.

The JAX package predicts the execution peak from XLA's AOT memory
analysis. PyTorch runs eagerly and has no such analysis, so the server
measures the peak once per executable shape on the card
(`Server._exec_peak`) and passes it in here; on the CPU it passes None,
and the check compares resident bytes alone, as the JAX package does
when analysis is withheld.

The trainer's OOM ladder, remat policies and auto-fit are not ported
(ROADMAP).
"""
from __future__ import annotations

import sys
import threading
import time

import torch

from . import config as _config

__all__ = ["MemoryBudgetError", "is_oom", "capacity_bytes",
           "resident_bytes", "check_budget", "last_check",
           "last_headroom_bytes", "reset"]

_lock = threading.RLock()
_last_check = None            # dict of the most recent budget check
_warned = set()               # executables already headroom-warned
_totals = {}                  # CUDA device index -> its total memory


def _fmt(n):
    """Human bytes for messages: '1.50 GiB (1610612736 bytes)'."""
    n = int(n)
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if abs(n) >= div:
            return f"{n / div:.2f} {unit} ({n} bytes)"
    return f"{n} bytes"


class MemoryBudgetError(RuntimeError):
    """The budget check predicted an out-of-memory: the executable's
    predicted peak (execution peak + resident state) exceeds the device
    capacity. Raised BEFORE any device dispatch. Carries the accounting
    so callers (the serving ladder) can act on it."""

    def __init__(self, executable, predicted_bytes, capacity_bytes,
                 exec_peak_bytes=None, resident_bytes=None):
        self.executable = executable
        self.predicted_bytes = int(predicted_bytes)
        self.capacity_bytes = int(capacity_bytes)
        self.exec_peak_bytes = exec_peak_bytes
        self.resident_bytes = resident_bytes
        self.headroom_bytes = int(capacity_bytes) - int(predicted_bytes)
        short = -self.headroom_bytes
        parts = ""
        if exec_peak_bytes is not None and resident_bytes is not None:
            parts = (f" ({_fmt(exec_peak_bytes)} execution peak + "
                     f"{_fmt(resident_bytes)} resident params/optimizer/"
                     "batch)")
        super().__init__(
            f"predicted peak device memory for executable '{executable}' is "
            f"{_fmt(predicted_bytes)}{parts} but device capacity is "
            f"{_fmt(capacity_bytes)} — {_fmt(short)} short. Remediations, "
            "cheapest first: (1) rematerialization — "
            "block.remat(policy='dots_saveable'|'layers'|'full') or the "
            "remat_policy knob trades recompute for activation memory; "
            "(2) shard optimizer state across the data replicas — set "
            "zero=auto (mx.zero) or trainer.set_zero(True): resident "
            "opt-state bytes drop by (D-1)/D with values unchanged; "
            "(3) a smaller batch or BucketPad bucket — dataflow.autofit() "
            "binary-searches the largest configuration that fits. "
            "Set oom_recover=auto to walk these "
            "automatically, or raise device_bytes_limit if the simulated "
            "capacity is wrong.")


def is_oom(exc):
    """True for a device out-of-memory (`torch.cuda.OutOfMemoryError`)
    or the budget check's MemoryBudgetError."""
    return isinstance(exc, (MemoryBudgetError, torch.cuda.OutOfMemoryError))


def reset():
    """Drop the recorded check and warnings (tests and run boundaries)."""
    global _last_check
    with _lock:
        _last_check = None
        _warned.clear()


def capacity_bytes(device=None):
    """Device memory capacity in bytes: the `device_bytes_limit` knob when
    positive (tests simulate any capacity this way), else the total
    memory of the CUDA device `device` (the current one when None) as
    `torch.cuda.mem_get_info` reports it, else None: a CPU device, or
    CUDA not initialised yet by anything else (this never initialises
    it)."""
    knob = int(_config.get("device_bytes_limit"))
    if knob > 0:
        return knob
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_initialized():
        return None
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _totals:       # read once: the scheduler asks every step
        try:
            _totals[idx] = int(torch.cuda.mem_get_info(idx)[1])
        except Exception:
            return None
    return _totals[idx]


def resident_bytes(tensors):
    """Total bytes of the given tensors — the state that stays resident
    while the executable runs (parameters, caches, the page pool)."""
    return sum(int(t.numel()) * int(t.element_size()) for t in tensors)


def check_budget(executable, exec_peak, resident, capacity=None):
    """Compare one executable's predicted peak (execution peak + resident
    state) against capacity. Records the check (last_check), warns when
    headroom drops below the `memory_headroom_warn` fraction of
    capacity, and raises MemoryBudgetError on a predicted overrun.
    `exec_peak` None (no measurement) checks resident state alone."""
    global _last_check
    capacity = capacity if capacity is not None else capacity_bytes()
    predicted = int(resident or 0) + int(exec_peak or 0)
    headroom = None if capacity is None else int(capacity) - predicted
    with _lock:
        _last_check = {
            "executable": executable,
            "exec_peak_bytes": exec_peak,
            "resident_bytes": int(resident or 0),
            "predicted_bytes": predicted,
            "capacity_bytes": capacity,
            "headroom_bytes": headroom,
            "ts": time.time(),
        }
    if capacity is None:
        return _last_check
    if headroom < 0:
        raise MemoryBudgetError(executable, predicted, capacity,
                                exec_peak_bytes=exec_peak,
                                resident_bytes=int(resident or 0))
    warn_frac = float(_config.get("memory_headroom_warn"))
    if warn_frac > 0 and headroom < warn_frac * capacity \
            and executable not in _warned:
        _warned.add(executable)
        print(f"mx.memsafe: WARNING — executable '{executable}' leaves only "
              f"{_fmt(headroom)} headroom ({headroom / capacity:.1%} of "
              f"capacity, warn threshold {warn_frac:.1%}); one larger bucket "
              "or a fragmentation spike away from an out-of-memory",
              file=sys.stderr)
    return _last_check


def last_check():
    """The most recent budget check's accounting dict (None before
    any)."""
    with _lock:
        return dict(_last_check) if _last_check else None


def last_headroom_bytes():
    """Headroom recorded by the most recent budget check (None before
    any check, or when capacity was unknown)."""
    with _lock:
        return _last_check.get("headroom_bytes") if _last_check else None
