"""mx.guard — liveness, step deadlines and silent-corruption defense
(counterpart of `mxnet_tpu/guard.py`).

Resilience survives every failure a launcher can see — signals, exits,
torn checkpoints. Two failure classes stay invisible: a rank that hangs
(stuck host, wedged input worker, a peer dead inside a collective) and
a rank that silently corrupts data (a bit-flipped gradient). Three
layers, as in the JAX package:

  * **heartbeat liveness** — each rank writes a monotonic heartbeat
    (step id, wall time, phase) to `<diagnostics_dir>/<rank>/
    heartbeat.json` from the trainer, checkpoint and serving hook sites
    (atomic writes, at most once per interval). A supervisor polling
    the files treats a stale heartbeat as a slot loss.
  * **step deadline** — a deadline (`collective_timeout_s`) on the step
    boundary, built on the port's `diagnostics.Watchdog`. On expiry the
    rank dumps a post-mortem naming the suspected dead peer (oldest
    peer heartbeat, plus the last mx.trace skew straggler) and exits
    `EXIT_PEER_LOST` (86). The first step at a new signature and
    checkpoint writes suspend the deadline.
  * **SDC defense** — every `sdc_check_every` steps the rank hashes its
    parameters (`param_digests`: blake2b over each parameter's bytes in
    declaration order), exchanges digests across ranks and
    majority-votes. On a mismatch it rolls back to the last verified
    checkpoint through `resilience`.

One device per process: the JAX package's in-process vote has one
digest per mesh device; here each process holds one copy of its
parameters, so the in-process vote has one voter and only the exchange
across ranks can disagree. Where `torch.distributed` is initialised
with more than one rank the exchange is `all_gather_object`; a
launcher-per-rank gang (`JAX_NUM_PROCESSES` / `WORLD_SIZE` exported,
no process group) exchanges through per-rank files under the guard
directory. Quarantining a rank voted corrupt twice needs the elastic
shrink, which the port does not have: that path raises
`NotPortedError` naming "Multi-device".

On the card a digest is one copy of the parameters into pinned host
memory (`ShardedTrainer._to_host`) and one synchronisation, every
`sdc_check_every` steps and at no other time.

Surfaces: `heartbeat_age_seconds` gauge, `peer_lost_total` /
`sdc_checks_total` / `sdc_mismatches_total` / `sdc_restores_total`
counters, "peer_lost"/"sdc" telemetry events and flight-ring entries,
and `snapshot()` (mx.scope's /statusz "guard" section).

Cost model: disabled (the default), every hook site checks one module
bool and falls through: no heartbeat record, no deadline thread, no
digest. Enable with `mx.guard.enable()` or `MXNET_TPU_GUARD=1`. A
forked worker starts no deadline thread (its slot is cleared after the
fork, and `arm_deadline` refuses in a worker that refuses the card).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import _locklint
from . import config as _config
from . import goodput as _goodput
from . import telemetry as _telemetry

__all__ = [
    "enable", "disable", "enabled", "reset", "maybe_enable",
    "heartbeat", "last_heartbeat", "heartbeat_age_s", "heartbeat_path",
    "read_heartbeats",
    "arm_deadline", "disarm_deadline", "suspect_peer",
    "step_begin", "on_step", "sdc_check", "param_digests",
    "snapshot", "EXIT_PEER_LOST", "HEARTBEAT_FILE",
]

# distinct "my PEER died — exiting so the supervisor can relaunch the
# gang" process exit code, after resilience's 83/84/85 family. The rank
# exiting 86 is HEALTHY: the launcher relaunches at the same world size
# (the actually-dead peer is the slot loss, reaped by the heartbeat poll
# or the teardown SIGKILL).
EXIT_PEER_LOST = 86
HEARTBEAT_FILE = "heartbeat.json"

_lock = _locklint.make_lock("guard.state")
_enabled = False          # the fast-path bool; hook sites read it directly
_dir = ""                 # per-rank files under <_dir>/<rank>/
_rank_override = None
_beat = None              # last in-memory heartbeat; None while disabled
_beat_written = 0.0       # _clock() of the last heartbeat FILE write
_beat_suppress_until = 0.0  # stall_heartbeat fault injection window
_beat_warned = False      # one warning per unwritable heartbeat target
_hb_timeout = 60.0        # staleness threshold (heartbeat_timeout_s knob)
_coll_timeout = 0.0       # collective deadline (collective_timeout_s knob)
_sdc_every = 0            # sdc_check_every knob
_deadline = None          # diagnostics.Watchdog on the collective boundary
_compiling = False        # deadline suspended across a step compile
_strikes = 0              # consecutive SDC votes naming THIS rank
_sdc_round = 0            # vote rounds run: keys the file exchange, so a
#                           replayed step (rollback past a mismatch votes
#                           the SAME step again) never reads the previous
#                           round's stale digest files. Gang-consistent:
#                           every rank runs every round (step-keyed hook,
#                           gang-wide rollback), and a relaunch resets
#                           every rank's counter together (new processes,
#                           new generation).
_last_sdc = None          # last vote verdict (post-mortem "guard" section)
_verified_step = None     # newest step a COMPLETE unanimous vote attested:
#                           checkpoints at or below it are digest-verified
#                           (corruption persists once introduced, so a clean
#                           vote at V vouches for every step <= V); restores
#                           never reach past this bound — a checkpoint saved
#                           from already-corrupt params at the failing step
#                           must not be reloaded as "verified"
_sdc_restores = 0
_sdc_warned = False       # one warning per unsupported sdc topology
_peer_lost_info = None    # what the deadline concluded before exiting
_SDC_KEEP = 4             # newest sdc_<step>.json files kept per rank

# injectable clocks (tests): _clock drives rate limiting/backoff, _wall
# stamps the heartbeat records the supervisor ages against
_clock = time.monotonic
_wall = time.time

_M_HB_AGE = _telemetry.gauge(
    "heartbeat_age_seconds", "seconds since this rank's last liveness "
    "heartbeat (0 at every beat; the supervisor-side staleness the "
    "heartbeat_timeout_s kill is based on)")
_M_PEER_LOST = _telemetry.counter(
    "peer_lost_total", "collective-deadline expiries: this rank concluded "
    "a peer died mid-collective and exited EXIT_PEER_LOST for relaunch")
_M_SDC_CHECKS = _telemetry.counter(
    "sdc_checks_total", "silent-data-corruption digest votes run (every "
    "sdc_check_every steps; each hashes every parameter replica)")
_M_SDC_MISMATCH = _telemetry.counter(
    "sdc_mismatches_total", "digest votes that found replicas disagreeing "
    "— each one rolled the gang back to the last verified checkpoint")
_M_SDC_RESTORES = _telemetry.counter(
    "sdc_restores_total", "checkpoint restores triggered by an SDC digest "
    "mismatch (gang-consistent rollback)")


def enabled():
    """True when the guard layer is armed (hot paths read the module
    global `_enabled` directly — this accessor is the public spelling)."""
    return _enabled


def enable(guard_dir=None, rank=None, heartbeat_timeout_s=None,
           collective_timeout_s=None, sdc_check_every=None):
    """Arm the guard layer. Arguments override the `heartbeat_timeout_s`
    / `collective_timeout_s` / `sdc_check_every` knobs (read once here —
    the per-step hot path never touches the config registry). Heartbeat
    files land under `<guard_dir>/<rank>/` (default: the diagnostics_dir
    knob, so tools/launch.py --diagnostics-dir points every worker at
    one shared base). Arms the collective deadline when
    collective_timeout_s > 0."""
    global _enabled, _dir, _rank_override
    global _hb_timeout, _coll_timeout, _sdc_every
    with _lock:
        if guard_dir is not None:
            _dir = str(guard_dir)
        elif not _dir:
            _dir = _config.get("diagnostics_dir")
        if rank is not None:
            _rank_override = int(rank)
        _hb_timeout = float(
            heartbeat_timeout_s if heartbeat_timeout_s is not None
            else _config.get("heartbeat_timeout_s"))
        _coll_timeout = float(
            collective_timeout_s if collective_timeout_s is not None
            else _config.get("collective_timeout_s"))
        _sdc_every = int(sdc_check_every if sdc_check_every is not None
                         else _config.get("sdc_check_every"))
        _enabled = True
    if _coll_timeout > 0 and _deadline is None:
        arm_deadline()
    return True


def maybe_enable():
    """Arm iff the `guard` knob asks (called at trainer construction,
    like memsafe/check — a config read at construction time only; the
    step hot path keeps its single module-bool check)."""
    if _enabled:
        return True
    if _config.get("guard"):
        enable()
    return _enabled


def disable():
    global _enabled
    _enabled = False
    disarm_deadline()


def reset():
    """Drop recorded state (tests and run boundaries). While disabled
    the heartbeat record is released too, restoring the zero-allocation
    fast path."""
    global _beat, _beat_written, _beat_suppress_until, _beat_warned
    global _strikes, _sdc_round, _last_sdc, _sdc_restores, _sdc_warned
    global _peer_lost_info, _compiling, _dir, _rank_override
    global _verified_step
    disarm_deadline()
    with _lock:
        _beat = None
        _beat_written = 0.0
        _beat_suppress_until = 0.0
        _beat_warned = False
        _strikes = 0
        _sdc_round = 0
        _last_sdc = None
        _verified_step = None
        _sdc_restores = 0
        _sdc_warned = False
        _peer_lost_info = None
        _compiling = False
        if not _enabled:
            _dir = ""
            _rank_override = None


def _rank():
    if _rank_override is not None:
        return _rank_override
    for var in ("RANK", "JAX_PROCESS_ID", "DMLC_WORKER_ID"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def _generation():
    """Supervised-relaunch generation (MXNET_TPU_RESTART_COUNT, exported
    by tools/launch.py). Stamped into heartbeats and SDC records so a
    relaunched gang is never judged against — or voted with — a previous
    generation's files."""
    try:
        return int(os.environ.get("MXNET_TPU_RESTART_COUNT", "0"))
    except ValueError:
        return 0


def _env_world():
    """Gang world size as the launcher exported it (WORLD_SIZE /
    JAX_NUM_PROCESSES / DMLC_NUM_WORKER); 1 standalone. Used by the
    file-based SDC exchange, where each launcher rank is a process of
    its own with no process group."""
    for var in ("WORLD_SIZE", "JAX_NUM_PROCESSES", "DMLC_NUM_WORKER"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return max(1, int(v))
            except ValueError:
                pass
    return 1


# ---------------------------------------------------------------------------
# heartbeat liveness
# ---------------------------------------------------------------------------

def heartbeat_path(rank=None, base_dir=None):
    """Where a rank's heartbeat file lands (None when no dir is set)."""
    base = base_dir if base_dir is not None else _dir
    if not base:
        return None
    return os.path.join(str(base), str(rank if rank is not None
                                       else _rank()), HEARTBEAT_FILE)


def heartbeat(step=None, phase="", force=False):
    """Record one liveness beat: in-memory always, to the per-rank
    heartbeat file at most once per interval (timeout/4, capped at 1 s)
    unless `force`. Feeds the collective deadline (a completed
    step/input/checkpoint event is progress). Callers gate on the module
    bool — this function is never reached while disabled. The `stall_heartbeat:ms` fault injection
    suppresses the FILE write for its window (the process stays healthy;
    only its liveness signal goes dark — the supervisor-side detection
    drill)."""
    global _beat, _beat_written, _beat_suppress_until
    if not _enabled:
        return None
    now = _clock()
    rec = {"step": int(step) if step is not None
           else (_beat or {}).get("step"),
           "phase": phase, "ts": _wall(), "pid": os.getpid(),
           "rank": _rank(), "gen": _generation()}
    with _lock:
        _beat = rec
    d = _deadline
    if d is not None:
        # every beat is progress for an ARMED deadline, but only a STEP
        # beat (dispatch/compile/complete) may arm a dormant one:
        # restore/input/checkpoint beats land before the first step
        # exists, and arming from them would let a long pre-step
        # data-prep phase read as a dead peer. Dispatch must arm —
        # a FIRST step blocked in a dead peer's collective never
        # completes, and its hang still has to fire the deadline.
        # Serving gangs arm the same way: an mx.serve scheduler step
        # is the serving analog of a train step.
        d.notify(rec["step"], arm=phase.startswith(("step", "serve")))
    if _telemetry._enabled:
        _M_HB_AGE.set(0.0)
    stall_ms = _consume_stall()
    if stall_ms is not None:
        _beat_suppress_until = now + stall_ms / 1000.0
        print(f"mx.guard: fault injection: heartbeat stalled "
              f"{stall_ms:.0f} ms (writes suppressed; process healthy)",
              file=sys.stderr)
    if now < _beat_suppress_until:
        return rec
    interval = min(1.0, max(0.05, _hb_timeout / 4.0)) if _hb_timeout \
        else 1.0
    with _lock:
        # check-and-set under the lock: the trainer thread and the
        # dataflow prefetch worker both beat, and a racy pair of writers
        # would tear the shared temp file
        if not force and now - _beat_written < interval:
            return rec
        _beat_written = now
    _write_beat(rec)
    return rec


def _consume_stall():
    """Pop an armed stall_heartbeat fault spec (ms float), or None. Goes
    through the resilience injector so the spec grammar, rank targeting
    and one-shot/relaunch disarm semantics are the injector's own."""
    res = sys.modules.get(__package__ + ".resilience")
    if res is None or not res._enabled or res._injector is None:
        return None
    arg = res._injector.consume("stall_heartbeat")
    if arg is None:
        return None
    try:
        return float(arg or 100.0)
    except ValueError:
        return 100.0


def _write_beat(rec):
    """Atomic heartbeat file write (temp + replace, like the post-mortem
    writer): the supervisor must never read a torn beat. An unwritable
    dir warns once and keeps the in-memory beat — liveness degrades to
    the in-process collective deadline, never to a crash."""
    global _beat_warned
    path = heartbeat_path()
    if path is None:
        return
    # unique temp name per writer: concurrent force-beats (trainer +
    # prefetch thread) must never truncate each other's half-written
    # record or replace the live file with a torn one
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        if not _beat_warned:
            _beat_warned = True
            print(f"mx.guard: cannot write heartbeat {path!r}: {e} — "
                  "liveness degrades to the in-process deadline "
                  "(warning once)", file=sys.stderr)


def last_heartbeat():
    """This process's most recent beat (None before any)."""
    with _lock:
        return dict(_beat) if _beat else None


def heartbeat_age_s():
    """Seconds since this process's last in-memory heartbeat (None
    before any) — the rank-local spelling of the staleness the
    supervisor poll computes from the heartbeat FILE, served live by
    mx.scope's /healthz endpoint."""
    with _lock:
        beat = dict(_beat) if _beat else None
    if not beat:
        return None
    return round(max(0.0, _wall() - float(beat.get("ts", 0.0))), 3)


def read_heartbeats(base_dir=None):
    """{rank: record} for every readable heartbeat file under the guard
    dir (digit-named rank subdirectories, the diagnostics layout).
    Torn/unreadable files are skipped — the atomic write makes those a
    crash artifact, not a liveness signal."""
    base = base_dir if base_dir is not None else _dir
    out = {}
    try:
        names = os.listdir(str(base))
    except (OSError, TypeError):
        return out
    for name in names:
        if not name.isdigit():
            continue
        path = os.path.join(str(base), name, HEARTBEAT_FILE)
        try:
            with open(path) as f:
                out[int(name)] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


# ---------------------------------------------------------------------------
# collective deadline
# ---------------------------------------------------------------------------

def arm_deadline(deadline_s=None, **kwargs):
    """Start (or restart) the gang-aware collective deadline: a
    mx.diagnostics Watchdog that fires when no step completes within
    `collective_timeout_s` — the signature of a peer dead inside a
    blocking collective. Starts DISARMED: the first completed step arms
    it, so a minutes-long first compile or data-prep phase can never
    read as a dead peer. `kwargs` (clock, interval, on_fire) are the
    Watchdog's — injectable for deterministic tests. 0 disables; a
    forked worker that refuses the card starts no thread."""
    global _deadline
    from . import diagnostics as _diagnostics
    if deadline_s is None:
        deadline_s = _coll_timeout
    disarm_deadline()
    if not deadline_s or float(deadline_s) <= 0 \
            or _diagnostics._in_forked_worker():
        return None
    kwargs.setdefault("on_fire", _peer_lost)
    kwargs.setdefault("armed", False)
    with _lock:
        _deadline = _diagnostics.Watchdog(deadline_s, **kwargs).start()
    return _deadline


def disarm_deadline():
    global _deadline
    with _lock:
        d, _deadline = _deadline, None
    if d is not None:
        d.stop()


def suspect_peer(base_dir=None):
    """Who is the gang most likely waiting on: the peer rank (self
    excluded) with the OLDEST current-generation heartbeat, annotated
    with the last mx.trace skew probe's straggler when one was measured.
    Returns {"rank", "age_s", "step", "phase", "straggler_rank"?} or
    None when no peer evidence exists."""
    me, gen = _rank(), _generation()
    now = _wall()
    worst = None
    for rank, rec in read_heartbeats(base_dir).items():
        if rank == me or rec.get("gen", 0) != gen:
            continue
        age = now - float(rec.get("ts", now))
        if worst is None or age > worst["age_s"]:
            worst = {"rank": rank, "age_s": round(age, 3),
                     "step": rec.get("step"), "phase": rec.get("phase")}
    straggler = None
    tr = sys.modules.get(__package__ + ".trace")
    if tr is not None and getattr(tr, "_skews", None):
        last = tr._skews[-1]
        if last.get("participants", 1) > 1:
            straggler = last.get("straggler_rank")
    if worst is None and straggler is None:
        return None
    out = worst or {"rank": straggler, "age_s": None, "step": None,
                    "phase": None}
    if straggler is not None:
        out["straggler_rank"] = straggler
    return out


def _peer_lost(msg):
    """The collective deadline expired: name the suspected dead peer,
    dump a post-mortem, and exit EXIT_PEER_LOST so the supervisor
    relaunches the gang instead of this rank blocking forever in a
    collective its peer will never join."""
    global _peer_lost_info
    suspect = suspect_peer()
    info = {"ts": _wall(), "deadline_s": _coll_timeout or None,
            "note": msg, "suspect": suspect,
            "last_heartbeat": last_heartbeat()}
    with _lock:
        _peer_lost_info = info
    who = (f"suspect: rank {suspect['rank']} (last heartbeat step "
           f"{suspect.get('step')}, {suspect.get('age_s')}s ago, phase "
           f"{suspect.get('phase') or '?'})") if suspect \
        else "no peer heartbeat evidence"
    if _telemetry._enabled:
        _M_PEER_LOST.inc()
        _telemetry.event("peer_lost", rank=_rank(), suspect=suspect,
                         note=msg)
    try:
        from . import diagnostics as _diagnostics
        _diagnostics.record_event("peer_lost", suspect=suspect, note=msg)
        _diagnostics.dump(reason="peer_lost",
                          note=f"collective deadline expired — {who}")
    except Exception:
        pass    # a dying rank with an unwritable dir still gets stderr
    print(f"mx.guard: collective deadline expired on rank {_rank()} — "
          f"{who}; exiting {EXIT_PEER_LOST} (EXIT_PEER_LOST) for "
          "supervised relaunch", file=sys.stderr)
    _exit_process(EXIT_PEER_LOST)


def _exit_process(code):
    """Immediate process exit from the deadline thread (sys.exit in a
    non-main thread only kills that thread; the main thread is stuck in
    the collective this exit escapes). Streams flushed first so the
    verdict line survives. Monkeypatched by tests."""
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(code)


# ---------------------------------------------------------------------------
# trainer hooks
# ---------------------------------------------------------------------------

def step_begin(step, compiling=False):
    """Pre-dispatch hook (ShardedTrainer, behind the module bool):
    heartbeat the dispatch, and SUSPEND the collective deadline across a
    step compile — a cold executable build is a legitimate minutes-scale
    non-step region, not a dead peer."""
    global _compiling
    if not _enabled:
        return
    heartbeat(step=step,
              phase="step.compile" if compiling else "step.dispatch")
    d = _deadline
    if compiling and d is not None and not _compiling:
        _compiling = True
        d.suspend()


def on_step(trainer, step):
    """Post-step hook (ShardedTrainer, behind the module bool): resume a
    compile-suspended deadline, beat the completed step, and run the SDC
    digest vote on its cadence."""
    global _compiling
    d = _deadline
    if _compiling and d is not None:
        _compiling = False
        d.resume()
    heartbeat(step=step, phase="step")
    if _sdc_every > 0 and step % _sdc_every == 0:
        sdc_check(trainer, step)


# ---------------------------------------------------------------------------
# SDC defense
# ---------------------------------------------------------------------------

def param_digests(trainer):
    """Deterministic digests of the trainer's parameters: one 64-bit
    blake2b hex digest per device copy, hashing every parameter's bytes
    in declaration order. The port holds one copy per process (the
    per-parameter list, or LAMB's flat float32 master, whose bytes are
    the parameters' in the same order), so the list has one entry. On
    the card the parameters are copied to pinned host memory once
    (`_to_host`: one synchronisation)."""
    import hashlib

    import torch

    params = trainer.params
    leaves = list(params) if isinstance(params, (list, tuple)) else [params]
    to_host = getattr(trainer, "_to_host", None)
    if to_host is not None and any(t.is_cuda for t in leaves):
        leaves = to_host(leaves)
    h = hashlib.blake2b(digest_size=8)
    for leaf in leaves:
        t = leaf.detach().contiguous().reshape(-1)
        if t.device.type != "cpu":
            t = t.cpu()
        h.update(t.view(torch.uint8).numpy())     # the buffer, no copy
    return [h.hexdigest()]


def _sdc_wait_s():
    """How long one rank waits for its peers' digests: the collective
    timeout when set (the vote IS a collective), else bounded by the
    heartbeat timeout — a vote must never outwait the liveness layer."""
    if _coll_timeout > 0:
        return _coll_timeout
    return max(5.0, min(30.0, _hb_timeout or 30.0))


def _sdc_path(rank, step):
    return os.path.join(_dir, str(rank), f"sdc_{int(step):010d}.json")


def _write_sdc(rec):
    try:
        d = os.path.join(_dir, str(rec["rank"]))
        os.makedirs(d, exist_ok=True)
        path = _sdc_path(rec["rank"], rec["step"])
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
        # keep only the newest few vote files: the exchange is keyed by
        # (gen, step), old rounds are dead weight
        old = sorted(n for n in os.listdir(d)
                     if n.startswith("sdc_") and n.endswith(".json"))
        for name in old[:-_SDC_KEEP]:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass
    except OSError as e:
        print(f"mx.guard: cannot publish sdc digest: {e}", file=sys.stderr)


def _read_sdc(rank, gen, step, rnd):
    try:
        with open(_sdc_path(rank, step)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if rec.get("gen") != gen or rec.get("step") != step \
            or rec.get("round") != rnd:
        # a round mismatch is the previous vote at this SAME step (the
        # gang rolled back past a mismatch and replayed): keep polling
        # until the peer overwrites it with this round's digest
        return None
    return rec


def _exchange_digests(mine):
    """All ranks' digest records for this vote round, keyed by rank.

    Where `torch.distributed` is initialised with more than one rank,
    the records are all-gathered (`all_gather_object`: every rank
    reaches the vote at the same step — the hook is step-keyed). A
    launcher-per-rank gang without a process group exchanges through
    per-rank files under the guard dir with a bounded wait — a dead
    peer costs one wait window, never a hang."""
    dist = _dist_world()
    if dist is not None:
        dist_mod, world = dist
        gathered = [None] * world
        dist_mod.all_gather_object(gathered, dict(mine))
        return {int(r["rank"]): r for r in gathered if r is not None}
    world = _env_world()
    if world <= 1 or not _dir:
        return {mine["rank"]: mine}
    _write_sdc(mine)
    recs = {mine["rank"]: mine}
    deadline = _clock() + _sdc_wait_s()
    while len(recs) < world and _clock() < deadline:
        for r in range(world):
            if r not in recs:
                rec = _read_sdc(r, mine["gen"], mine["step"],
                                mine["round"])
                if rec is not None:
                    recs[r] = rec
        if len(recs) < world:
            # keep beating while we wait: a healthy rank polling for a
            # dead peer's digest must not itself read heartbeat-stale
            # and get killed by the supervisor (the waits here can
            # exceed heartbeat_timeout_s; the write stays rate-limited)
            heartbeat(phase="sdc")
            time.sleep(0.05)
    if len(recs) < world:
        missing = sorted(set(range(world)) - set(recs))
        print(f"mx.guard: sdc vote at step {mine['step']}: rank(s) "
              f"{missing} never published a digest (dead peer? the "
              "liveness layer handles them) — voting with "
              f"{len(recs)}/{world}", file=sys.stderr)
    return recs


def _dist_world():
    """(torch.distributed, world size) when a process group of more than
    one rank is initialised, else None (torch not imported counts as
    none: the check never imports it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    dist = torch.distributed
    if not dist.is_available() or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    return (dist, world) if world > 1 else None


def _vote(recs):
    """Majority vote over every replica digest in the gang. Returns
    {"ok", "majority", "participants", "replicas", "conclusive",
    "corrupt_ranks", "corrupt_replicas"}: `ok` means unanimous;
    `conclusive` means a strict majority exists to blame the minority
    (two ranks with one replica each CAN'T out-vote each other — but a
    replicated in-process mesh contributes one digest per device, so an
    8-device rank pair yields a 15-vs-1 vote on a single flipped
    replica)."""
    from collections import Counter
    replicas = []
    for r in sorted(recs):
        for d in recs[r].get("digests", []):
            replicas.append((int(r), d))
    if not replicas:
        return {"ok": True, "majority": None, "participants": 0,
                "replicas": 0, "conclusive": False, "corrupt_ranks": [],
                "corrupt_replicas": 0}
    counts = Counter(d for _, d in replicas)
    majority, n = counts.most_common(1)[0]
    total = len(replicas)
    unanimous = len(counts) == 1
    conclusive = unanimous or n * 2 > total
    corrupt = sorted({r for r, d in replicas if d != majority}) \
        if (conclusive and not unanimous) else []
    return {"ok": unanimous, "majority": majority,
            "participants": len(recs), "replicas": total,
            "conclusive": conclusive, "corrupt_ranks": corrupt,
            "corrupt_replicas": 0 if unanimous else total - n}


def sdc_check(trainer, step):
    """One silent-data-corruption vote round: digest every local replica,
    exchange gang-wide, majority-vote. On a mismatch: record the verdict
    (telemetry + flight ring + stderr), then roll the WHOLE gang back to
    the last verified checkpoint (a corrupt update must not survive on
    any rank, and a gang whose corrupt rank alone rewinds desyncs its
    collectives); a rank voted corrupt twice in a row is quarantined via
    the elastic shrink path (EXIT_SHRINK at the next boundary — the
    supervisor relaunches the gang without it). Returns the verdict."""
    global _last_sdc, _strikes, _sdc_round, _sdc_warned, _sdc_restores
    global _verified_step
    mode = getattr(trainer, "param_mode", "replicate")
    # a zero'd fused-LAMB trainer (the JAX package's mx.zero; not in the
    # port) would hold shards of the master, which cannot vote
    zero_fused = getattr(trainer, "_zero", False) \
        and getattr(trainer, "_fused", False)
    if mode != "replicate" or zero_fused:
        if not _sdc_warned:
            _sdc_warned = True
            why = (f"param_mode={mode!r} shards params"
                   if mode != "replicate"
                   else "mx.zero shards the fused-LAMB flat master")
            print(f"mx.guard: sdc checks need bit-identical data-parallel "
                  f"replicas; {why} — digest "
                  "vote skipped (warning once)", file=sys.stderr)
        return None
    if _telemetry._enabled:
        _M_SDC_CHECKS.inc()
    _sdc_round += 1
    mine = {"rank": _rank(), "step": int(step), "gen": _generation(),
            "round": _sdc_round,
            "digests": param_digests(trainer), "ts": _wall()}
    verdict = _vote(_exchange_digests(mine))
    verdict["step"] = int(step)
    world = _dist_world()
    if verdict["participants"] < (world[1] if world else _env_world()):
        verdict["partial"] = True
    with _lock:
        _last_sdc = dict(verdict)
    if verdict["ok"]:
        # a partial ok verified nothing about the missing peer — keep
        # any accumulated strikes instead of resetting them
        if not verdict.get("partial"):
            _strikes = 0
            # a clean complete vote at V attests every checkpoint <= V:
            # corruption persists once introduced, so state that voted
            # clean NOW was clean at every earlier save too
            _verified_step = int(step)
        return verdict
    if verdict.get("partial"):
        # A peer never published inside the wait window: either dead
        # (the liveness layer owns it) or slow (IT holds the complete
        # view and acts on it). Never convict or restore from a partial
        # view — a timed-out exchange must not split the gang into
        # divergent rollback decisions. The one certainty a partial
        # view still carries is THIS rank's own replicas disagreeing
        # (definite local corruption): re-vote on the local records
        # alone and let that verdict drive the strike/restore path.
        local = _vote({mine["rank"]: mine})
        if local["ok"]:
            print(f"mx.guard: SDC vote at step {step}: mismatch on a "
                  "PARTIAL exchange — unattributable, skipping the "
                  "round (a dead peer is the liveness layer's; a slow "
                  "one votes on its own complete view)", file=sys.stderr)
            if _telemetry._enabled:
                _telemetry.event("sdc", **verdict)
            return verdict
        local["step"] = int(step)
        local["partial"] = True
        verdict = local
        with _lock:
            _last_sdc = dict(verdict)
    corrupt = verdict["corrupt_ranks"]
    if _telemetry._enabled:
        _M_SDC_MISMATCH.inc()
        _telemetry.event("sdc", **verdict)
    try:
        from . import diagnostics as _diagnostics
        _diagnostics.record_event("sdc", **verdict)
    except Exception:
        pass
    if verdict["conclusive"]:
        print(f"mx.guard: SDC digest mismatch at step {step}: "
              f"{verdict['corrupt_replicas']} of {verdict['replicas']} "
              f"replica(s) disagree with the majority — corrupt rank(s): "
              f"{corrupt}", file=sys.stderr)
    else:
        print(f"mx.guard: SDC digest mismatch at step {step}: replicas "
              "disagree with NO majority — cannot attribute; rolling "
              "every rank back to the last verified checkpoint",
              file=sys.stderr)
    if _rank() in corrupt:
        _strikes += 1
        if _strikes >= 2:
            # repeat offender: this hardware is corrupting data faster
            # than rollback can launder it — quarantine the rank through
            # the elastic shrink path instead of restoring again (the
            # port's request_shrink raises NotPortedError: no elastic
            # resize on one device per process)
            from . import resilience as _resilience
            print(f"mx.guard: rank {_rank()} voted corrupt {_strikes} "
                  "consecutive time(s) — quarantining via elastic shrink",
                  file=sys.stderr)
            # roll back to verified state BEFORE the shrink exit: the
            # preemption path writes a final checkpoint into the SHARED
            # checkpoint_dir, and saving while corrupt would hand the
            # relaunched gang — as the newest verified step — exactly
            # the corruption the vote just caught
            _sdc_restore(trainer, step)
            _resilience.request_shrink("sdc quarantine")
            with _lock:
                _last_sdc["quarantined"] = True
            return verdict
    else:
        _strikes = 0
    _sdc_restore(trainer, step)
    return verdict


def _sdc_restore(trainer, step):
    """Gang-consistent rollback to the last DIGEST-verified checkpoint
    (the mx.resilience manager: CRC-verified, falling back past torn
    ones, bit-exact replay from there). CRC only proves the file matches
    what was written — a checkpoint saved from already-corrupt params
    passes it, and the periodic save at the failing step runs BEFORE the
    vote, so restore_latest() unbounded would reload exactly the
    corruption the vote just caught. Bound the restore to the newest
    step a clean complete vote attested (or, before any vote has passed,
    to strictly below the failing step — the save at the failing step is
    the one checkpoint that is provably suspect)."""
    global _sdc_restores
    from . import resilience as _resilience
    mgr = _resilience.manager_for(trainer) if _resilience._enabled else None
    if mgr is None:
        print("mx.guard: corruption detected but no checkpoint_dir is "
              "configured — cannot restore; training continues on "
              "corrupt state", file=sys.stderr)
        return None
    bound = _verified_step if _verified_step is not None else int(step) - 1
    restored = mgr.restore_latest(max_step=bound)
    if restored is None:
        print(f"mx.guard: corruption detected but no checkpoint at or "
              f"below the last digest-verified step ({bound}) exists — "
              "cannot restore (a newer save may itself be corrupt)",
              file=sys.stderr)
        return None
    _sdc_restores += 1
    if _telemetry._enabled:
        _M_SDC_RESTORES.inc()
    if _goodput._enabled:
        # steps at or below the rolled-back high-water re-train as
        # badput:replay, not goodput, until progress passes it again
        _goodput.note_rollback(int(step), int(restored))
    print(f"mx.guard: restored the last verified checkpoint (step "
          f"{restored}) — replaying past the corrupted update",
          file=sys.stderr)
    return restored


# ---------------------------------------------------------------------------
# post-mortem surface
# ---------------------------------------------------------------------------

def snapshot():
    """Plain-data summary for the post-mortem "guard" section: the last
    heartbeat, deadline/SDC config, the last vote verdict, and — when
    the collective deadline fired — what it concluded."""
    with _lock:
        return {
            "rank": _rank(),
            "enabled": _enabled,
            "dir": _dir or None,
            "heartbeat": dict(_beat) if _beat else None,
            "heartbeat_timeout_s": _hb_timeout,
            "collective_timeout_s": _coll_timeout or None,
            "deadline_armed": _deadline is not None,
            "sdc_check_every": _sdc_every or None,
            "last_sdc": dict(_last_sdc) if _last_sdc else None,
            "sdc_restores": _sdc_restores,
            "strikes": _strikes,
            "peer_lost": dict(_peer_lost_info) if _peer_lost_info
            else None,
        }


def _after_fork_in_child():
    """A forked child has no deadline thread (threads do not survive
    fork): clear the slot so nothing waits on or stops the parent's
    dead copy. The module's lock is re-initialised by `_locklint`."""
    global _deadline
    _deadline = None


os.register_at_fork(after_in_child=_after_fork_in_child)


if _config.get("guard"):
    enable()
