"""Preemption-safe training loop helper (the `AutoCheckpoint` part of
`mxnet_tpu/parallel/elastic.py`).

`AutoCheckpoint(trainer, directory, every_steps, keep)` wraps a trainer's
`step`: it saves `trainer.save_states(directory/step_<n>)` every
`every_steps` completed steps and at the first step boundary after a
preemption signal (SIGTERM by default), writing a `DONE` marker into
the directory after a save succeeds; `restore_latest()` loads the newest
directory with a marker, falling back past one that fails to load (a
corrupt checkpoint: with resilience enabled `load_states` verifies its
checksums). Only the newest `keep` complete checkpoints stay.
`preempted` turns true at the signal and stays so; training loops break
on it (`examples/bert/pretrain.py`'s `--auto-checkpoint-dir` flow).

The signal handler holds only a weak reference: the process-wide
signal table must not keep the trainer alive after the AutoCheckpoint is
dropped. `close()` (also the context manager's exit) restores the
previous handlers. Handlers can only be set from the main thread;
elsewhere the periodic saves still run. The JAX package's
`resize_trainer` and mesh resharding are not ported (one device).
"""
from __future__ import annotations

import os
import shutil
import signal
import time
import weakref

__all__ = ["AutoCheckpoint"]

_MARKER = "DONE"


class AutoCheckpoint:
    def __init__(self, trainer, directory, every_steps=500, keep=2,
                 on_preemption=True, signals=(signal.SIGTERM,)):
        self.trainer = trainer
        self.directory = str(directory)
        self.every_steps = int(every_steps)
        self.keep = int(keep)
        self.last_save_seconds = None
        self.last_restore_seconds = None
        self._save_pending = False     # cleared once the boundary save runs
        self._preempted = False        # sticky: "a signal arrived"
        self._prev_handlers = {}
        os.makedirs(self.directory, exist_ok=True)
        if on_preemption:
            ref = weakref.ref(self)

            def _handler(signum, frame, _ref=ref):
                obj = _ref()
                if obj is not None:
                    obj._save_pending = True
                    obj._preempted = True
            for sig in signals:
                try:
                    self._prev_handlers[sig] = signal.signal(sig, _handler)
                except (ValueError, OSError):
                    pass               # not the main thread

    @property
    def preempted(self):
        """Sticky: True once a preemption signal has arrived (the boundary
        save does NOT clear it)."""
        return self._preempted

    def clear_preempted(self):
        self._preempted = False
        self._save_pending = False

    def close(self):
        """Restore the previous signal handlers."""
        for sig, h in self._prev_handlers.items():
            try:
                signal.signal(sig, h)
            except (ValueError, OSError):
                pass
        self._prev_handlers = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # --------------------------------------------------------------- steps
    def step(self, *args, **kwargs):
        loss = self.trainer.step(*args, **kwargs)
        n = int(self.trainer.num_update)
        if self._save_pending or (
                self.every_steps > 0 and n % self.every_steps == 0):
            self.save()
            self._save_pending = False  # one boundary save per signal
        return loss

    # --------------------------------------------------------- checkpoints
    def _step_dir(self, n):
        return os.path.join(self.directory, f"step_{n:010d}")

    def save(self):
        """Checkpoint now (also called by step()). Returns the step's
        directory."""
        t0 = time.perf_counter()
        n = int(self.trainer.num_update)
        d = self._step_dir(n)
        self.trainer.save_states(d)
        # the marker AFTER a successful save: restore_latest ignores a
        # directory without one, so a kill mid-save is never resumed from
        with open(os.path.join(d, _MARKER), "w") as f:
            f.write(str(n))
        self.last_save_seconds = time.perf_counter() - t0
        self._retain()
        return d

    def _complete_steps(self):
        """Steps of the checkpoints that carry the marker, oldest first."""
        out = []
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for e in entries:
            if e.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, e, _MARKER)):
                try:
                    out.append(int(e[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def _retain(self):
        if self.keep <= 0:
            return
        for n in self._complete_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(n), ignore_errors=True)

    def restore_latest(self):
        """Load the newest COMPLETE checkpoint into the trainer. Returns
        its step, or None when no usable checkpoint exists."""
        for n in reversed(self._complete_steps()):
            t0 = time.perf_counter()
            try:
                self.trainer.load_states(self._step_dir(n))
            except Exception:          # corrupt tail: fall back one
                continue
            self.last_restore_seconds = time.perf_counter() - t0
            return n
        return None
