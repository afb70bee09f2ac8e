"""Instrumented-lock layer (counterpart of `mxnet_tpu/_locklint.py`):
the tsan-lite concurrency analysis.

Two execution contexts taking the same locks in opposite orders (a
signal handler that blocks on a lock the interrupted main thread holds)
deadlock only when the race window is hit, so tests that never hit it
pass; but the hazard is visible in the acquisition-order graph: if lock
A is ever held while B is acquired, and elsewhere B is held while A is
acquired, the pair can deadlock. This module records that graph.

`make_lock(name)` / `make_rlock(name)` are the factories the
instrumented modules (config, telemetry, trace, diagnostics, profiler,
inspect) use instead of raw `threading.Lock()` / `threading.RLock()`.
Disarmed (the default) they return the PLAIN threading primitive — zero
wrapper, zero overhead. Armed (the `check_threads` knob,
`MXNET_TPU_CHECK_THREADS=1`, read at import) they return a `CheckedLock`
that:

  * records every held-while-acquiring edge into a process-global
    acquisition-order graph, with the acquiring stack captured per edge;
  * raises `LockOrderError` the moment an edge CLOSES A CYCLE, reporting
    BOTH acquisition stacks — the deadlock is diagnosed from one
    interleaving that did not hang, instead of reproduced from the one
    that did;
  * flags a blocking re-acquire of a non-reentrant lock on the same
    thread (`self-deadlock`: certain deadlock);
  * backs `GuardedDict`, whose mutations assert the guard lock is held
    (`unguarded-mutation`) — the shared-structure half of tsan-lite.

Fork safety: a lock another thread held when the process forked stays
held forever in the child (a forked DataLoader worker). Every lock the
factories made is re-initialised, unlocked, in the child
(`os.register_at_fork`), as the standard library does for its own.

Stdlib-only on purpose: it imports nothing of the package.
"""
from __future__ import annotations

import os
import threading
import traceback

__all__ = [
    "LockOrderError", "CheckedLock", "GuardedDict",
    "make_lock", "make_rlock", "guarded_dict",
    "armed", "arm", "disarm", "reset",
    "cycles", "unguarded_mutations", "lock_graph", "findings",
]


def _env_armed():
    return os.environ.get("MXNET_TPU_CHECK_THREADS", "").lower() in (
        "1", "true", "yes", "on")


_armed = _env_armed()      # snapshot at import; arm()/disarm() for tests
_graph_lock = threading.Lock()    # guards the order graph + finding lists
_edges = {}                # (a_name, b_name) -> edge record dict
_adj = {}                  # a_name -> set of b_name (a held while b taken)
_cycles = []               # finding dicts (kept even after the raise)
_mutations = []            # unguarded-mutation finding dicts
_held = threading.local()  # per-thread stack of held CheckedLocks


class LockOrderError(RuntimeError):
    """A lock acquisition closed a cycle in the acquisition-order graph:
    two contexts take the same locks in opposite orders, so the schedule
    that interleaves them deadlocks. Carries the finding dict (both
    acquisition stacks included) as `.finding`."""

    def __init__(self, message, finding=None):
        super().__init__(message)
        self.finding = finding or {}


def armed():
    return _armed


def arm():
    global _armed
    _armed = True


def disarm():
    global _armed
    _armed = False


def reset():
    """Drop the recorded graph and findings (test boundaries)."""
    with _graph_lock:
        _edges.clear()
        _adj.clear()
        del _cycles[:]
        del _mutations[:]


_THIS_FILE = os.path.abspath(__file__)


def _stack(skip=0):
    """Compact acquisition stack: 'file:line in func' lines, innermost
    last, with this module's own frames trimmed so the innermost line is
    the CALLER's acquire site."""
    frames = [f for f in traceback.extract_stack()
              if os.path.abspath(f.filename) != _THIS_FILE]
    return [f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
            for f in frames[-8:]]


def _held_stack():
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _path_exists(src, dst):
    """DFS reachability src -> dst over the current order graph (called
    under _graph_lock)."""
    seen = set()
    todo = [src]
    while todo:
        n = todo.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        todo.extend(_adj.get(n, ()))
    return False


def _cycle_edges(src, dst):
    """One src -> dst path as edge records (called under _graph_lock);
    the reverse path of a detected cycle, for the report."""
    parent = {src: None}
    todo = [src]
    while todo:
        n = todo.pop()
        if n == dst:
            break
        for m in _adj.get(n, ()):
            if m not in parent:
                parent[m] = n
                todo.append(m)
    if dst not in parent:
        return []
    path = []
    n = dst
    while parent[n] is not None:
        path.append(_edges[(parent[n], n)])
        n = parent[n]
    return list(reversed(path))


class CheckedLock:
    """threading.Lock/RLock wrapper recording acquisition order (armed
    mode only — make_lock/make_rlock return the plain primitive when
    disarmed)."""

    def __init__(self, name, reentrant=False):
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    # -- the analysis ---------------------------------------------------
    def _before_acquire(self, blocking):
        held = _held_stack()
        if any(h is self for h in held):
            if self._reentrant:
                return  # legal re-enter: no new edge, no hazard
            if blocking:
                finding = {
                    "rule": "lock-order-cycle", "kind": "self-deadlock",
                    "lock": self.name,
                    "message": f"blocking re-acquire of non-reentrant lock "
                               f"'{self.name}' on the thread that already "
                               "holds it — certain deadlock (a signal "
                               "handler blocking on the lock the "
                               "interrupted thread holds)",
                    # BOTH sides: where the lock was FIRST taken (the
                    # frame the fix usually lives in) and the re-acquire
                    "stacks": {
                        "holding": list(self._acquire_stack or ()),
                        "acquiring": _stack()},
                }
                with _graph_lock:
                    _cycles.append(finding)
                raise LockOrderError(finding["message"], finding)
            return
        if not blocking:
            return  # try-lock cannot deadlock: no edge
        acq_stack = _stack()
        for h in held:
            if h.name == self.name:
                continue
            edge = (h.name, self.name)
            with _graph_lock:
                rec = _edges.get(edge)
                if rec is not None:
                    rec["count"] += 1
                    continue
                # adding h -> self creates a cycle iff self already
                # reaches h; collect the reverse path BEFORE inserting
                reverse = _cycle_edges(self.name, h.name) \
                    if _path_exists(self.name, h.name) else []
                rec = {"held": h.name, "acquired": self.name, "count": 1,
                       "held_stack": list(h._acquire_stack or ()),
                       "acquire_stack": acq_stack}
                _edges[edge] = rec
                _adj.setdefault(h.name, set()).add(self.name)
                if reverse:
                    order = " -> ".join(
                        [h.name, self.name]
                        + [e["acquired"] for e in reverse])
                    finding = {
                        "rule": "lock-order-cycle", "kind": "order-cycle",
                        "locks": [h.name, self.name],
                        "message": (
                            f"lock acquisition order cycle: '{h.name}' is "
                            f"held while acquiring '{self.name}' here, but "
                            f"elsewhere '{self.name}' is held while "
                            f"(transitively) acquiring '{h.name}' "
                            f"({order}) — the interleaved schedule "
                            "deadlocks"),
                        # BOTH acquisition stacks: this edge's, and the
                        # first reverse-path edge's (where the opposite
                        # order was taken)
                        "stacks": {
                            "forward": {"held": rec["held_stack"],
                                        "acquiring": acq_stack},
                            "reverse": {
                                "held": reverse[0]["held_stack"],
                                "acquiring": reverse[0]["acquire_stack"]},
                        },
                    }
                    _cycles.append(finding)
                    raise LockOrderError(finding["message"], finding)

    # -- lock protocol --------------------------------------------------
    _acquire_stack = None

    def acquire(self, blocking=True, timeout=-1):
        self._before_acquire(blocking)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held = _held_stack()
            if not (self._reentrant and any(h is self for h in held)):
                self._acquire_stack = _stack()
                held.append(self)
            else:
                held.append(self)   # symmetric push so release pops evenly
        return got

    def release(self):
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._inner.release()

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else any(h is self for h in _held_stack())

    def held_by_me(self):
        return any(h is self for h in _held_stack())

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        kind = "RLock" if self._reentrant else "Lock"
        return f"CheckedLock({self.name!r}, {kind})"


_made = []                 # every lock the factories made (fork reinit)


def _reinit_after_fork():
    """In a forked child: every factory-made lock starts unlocked (a
    thread of the parent may have held it at the fork), and this
    thread's held stack starts empty."""
    global _graph_lock, _held
    _graph_lock = threading.Lock()
    _held = threading.local()
    for lock in _made:
        inner = lock._inner if isinstance(lock, CheckedLock) else lock
        inner._at_fork_reinit()


os.register_at_fork(after_in_child=_reinit_after_fork)


def make_lock(name):
    """A mutex for module `name` ('module.purpose' by convention):
    the plain threading.Lock when disarmed (zero overhead), the
    order-recording CheckedLock under MXNET_TPU_CHECK_THREADS=1."""
    lock = CheckedLock(name) if _armed else threading.Lock()
    _made.append(lock)
    return lock


def make_rlock(name):
    """Reentrant variant of make_lock."""
    lock = CheckedLock(name, reentrant=True) if _armed \
        else threading.RLock()
    _made.append(lock)
    return lock


# ---------------------------------------------------------------------------
# guarded shared structures (the mutation half of tsan-lite)
# ---------------------------------------------------------------------------

class GuardedDict(dict):
    """dict whose mutations assert the guard CheckedLock is held by the
    mutating thread (armed mode). A mutation without the guard records an
    `unguarded-mutation` finding and raises LockOrderError — the CI sweep
    then fails on the new race instead of corrupting state silently."""

    def __init__(self, guard, name, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._guard = guard
        self._name = name

    def _assert_guarded(self):
        if isinstance(self._guard, CheckedLock) and self._guard.held_by_me():
            return
        finding = {
            "rule": "unguarded-mutation",
            "structure": self._name, "guard": getattr(
                self._guard, "name", str(self._guard)),
            "message": f"shared structure '{self._name}' mutated without "
                       f"holding its guard lock "
                       f"'{getattr(self._guard, 'name', self._guard)}'",
            "stack": _stack(),
        }
        with _graph_lock:
            _mutations.append(finding)
        raise LockOrderError(finding["message"], finding)

    def __setitem__(self, k, v):
        self._assert_guarded()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._assert_guarded()
        super().__delitem__(k)

    def clear(self):
        self._assert_guarded()
        super().clear()

    def pop(self, *a, **k):
        self._assert_guarded()
        return super().pop(*a, **k)

    def popitem(self):
        self._assert_guarded()
        return super().popitem()

    def setdefault(self, *a, **k):
        self._assert_guarded()
        return super().setdefault(*a, **k)

    def update(self, *a, **k):
        self._assert_guarded()
        return super().update(*a, **k)


def guarded_dict(guard, name, *args, **kwargs):
    """A dict asserting its mutations hold `guard` (armed mode); the
    plain dict when disarmed — zero overhead on the default path."""
    if _armed and isinstance(guard, CheckedLock):
        return GuardedDict(guard, name, *args, **kwargs)
    return dict(*args, **kwargs)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def lock_graph():
    """The acquisition-order graph as plain data: every held-while-
    acquiring edge with count and both stacks."""
    with _graph_lock:
        return [dict(rec) for rec in _edges.values()]


def cycles():
    """Lock-order cycle findings recorded this process (copies)."""
    with _graph_lock:
        return [dict(c) for c in _cycles]


def unguarded_mutations():
    with _graph_lock:
        return [dict(m) for m in _mutations]


def findings():
    """All concurrency findings (cycles + unguarded mutations)."""
    with _graph_lock:
        return [dict(c) for c in _cycles] + [dict(m) for m in _mutations]
