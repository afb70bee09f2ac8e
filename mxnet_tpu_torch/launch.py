#!/usr/bin/env python
"""The port's supervisor, fleet half (counterpart of `tools/launch.py`'s
`launch_fleet` and its `--serve-replicas` flags).

    python mxnet_tpu_torch/launch.py --serve-replicas N \\
        [--fleet-port P] [--diagnostics-dir D] [--max-restarts K] \\
        [command ...]

runs a REPLICATED SERVING GANG: N independent replica worker processes
(default command `python -m mxnet_tpu_torch.fleet`, each one
`serve.Server` with its fleet endpoint on P+1+R) behind the fleet
router's health-routed front door on P. Each replica gets
`MXNET_TPU_FLEET_REPLICA`, `MXNET_TPU_FLEET_PORT`,
`MXNET_TPU_FLEET_VERSION` and `MXNET_TPU_RESTART_COUNT` (its relaunch
generation: one-shot fault specs fire on the first launch only); every
other setting (the serving knobs, `MXNET_TPU_DEVICE_BYTES_LIMIT`, ...)
rides the launcher's environment, and a command given after the flags
replaces the default one (`... -- python -m mxnet_tpu_torch.fleet
--device cpu` runs the replicas on the CPU).

  * A replica that exits is relaunched ALONE, after `--restart-backoff`
    seconds (jittered +-20%), while the router replays its in-flight
    requests on survivors bit-identically. `replica_exit` and
    `replica_relaunch` records append to `<D>/restarts.jsonl`, and each
    replica's output is teed, unprefixed, to `<D>/<R>/worker.log`.
    A replica out of restart budget leaves the fleet.
  * `POST /roll {"version": v}` on the front door rolls the fleet one
    replica at a time onto version v: drain, wait idle, SIGTERM (the
    replica finishes or requeues its work and exits 83), relaunch at v,
    wait healthy, release traffic (`replica_roll` records).
  * `MXNET_TPU_FLEET_AUTOSCALE=on` (or `POST /scale {"n": k}`) resizes
    the fleet between `--min-workers` and `--max-replicas`, one replica
    at a time.
  * SIGTERM (or SIGINT) drains every replica — each exits through the
    resilience preemption path (83) — and the launcher exits 128 +
    signal (143 for SIGTERM).

The launcher itself is stdlib-only: run as a file, as above, it loads
the router half of `mxnet_tpu_torch/fleet.py` by file path, as
`tools/launch.py` loads the JAX package's, and imports nothing else
beyond the standard library, so the supervising process never maps
torch or the CUDA driver. (`python -m mxnet_tpu_torch.launch` works too,
but Python then imports the package, and so torch, first.) The replicas
find the package through `PYTHONPATH`, to which the launcher prepends
the directory that holds it.

The training gang (`-n/--num-workers`: rank wiring, gang relaunch,
elastic resize) is not ported: it refuses, naming queue 1's
"Multi-device".
"""
from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

EXIT_PREEMPTED = 83          # resilience.EXIT_PREEMPTED

_out_lock = threading.Lock()


def _pump(stream, rid, tee_file):
    """Forward one replica's merged stdout/stderr line by line, prefixed
    with its id; raw lines tee into its worker.log."""
    prefix = f"[rank {rid}] "
    for line in stream:
        with _out_lock:
            sys.stdout.write(prefix + line)
            sys.stdout.flush()
        if tee_file is not None:
            tee_file.write(line)
            tee_file.flush()
    stream.close()
    if tee_file is not None:
        tee_file.close()


def _spawn(command, env, rid, diagnostics_dir, restart_count=0):
    tee = None
    if diagnostics_dir:
        rank_dir = os.path.join(diagnostics_dir, str(rid))
        os.makedirs(rank_dir, exist_ok=True)
        # relaunches APPEND: the crash output stays
        tee = open(os.path.join(rank_dir, "worker.log"),
                   "a" if restart_count else "w")
        if restart_count:
            tee.write(f"=== relaunch attempt {restart_count} ===\n")
            tee.flush()
    proc = subprocess.Popen(
        list(command), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, errors="replace", bufsize=1)
    pump = threading.Thread(target=_pump, args=(proc.stdout, rid, tee),
                            daemon=True)
    pump.start()
    return proc, pump


def _terminate(procs, pumps, sig=signal.SIGTERM, grace=10.0):
    """Forward `sig` to every live replica (its drain window), wait up to
    `grace` seconds, SIGKILL stragglers, reap every child, and join the
    pumps so the worker.log tees are flushed."""
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except OSError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for t in pumps:
        t.join(timeout=5.0)


def _append_restart_event(diagnostics_dir, event):
    """Append one record to <diagnostics_dir>/restarts.jsonl."""
    if not diagnostics_dir:
        return
    try:
        os.makedirs(diagnostics_dir, exist_ok=True)
        with open(os.path.join(diagnostics_dir, "restarts.jsonl"), "a") as f:
            f.write(json.dumps(event) + "\n")
    except OSError as e:
        print(f"launch: cannot record {event.get('kind')} event: {e}",
              file=sys.stderr)


def _load_fleet():
    """The stdlib-only router half of mxnet_tpu_torch/fleet.py, loaded by
    file path (no package import, no torch)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fleet.py")
    spec = importlib.util.spec_from_file_location("mx_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def replica_env(rid, port, version, restart_count, diagnostics_dir=None):
    """The environment of replica `rid`: the launcher's, plus its fleet
    identity, relaunch generation and (with a diagnostics dir) armed
    mx.diagnostics under <dir>/<rid>."""
    env = dict(os.environ)
    env.update({
        "MXNET_TPU_FLEET_REPLICA": str(rid),
        "MXNET_TPU_FLEET_PORT": str(port),
        "MXNET_TPU_FLEET_VERSION": version,
        "MXNET_TPU_RESTART_COUNT": str(restart_count),
        "DMLC_ROLE": "worker",
        "DMLC_WORKER_ID": str(rid),
    })
    # the default command's `-m mxnet_tpu_torch.fleet` resolves wherever
    # the launcher was started from
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p and p != root])
    if diagnostics_dir:
        env["MXNET_TPU_DIAGNOSTICS"] = "1"
        env["MXNET_TPU_DIAGNOSTICS_DIR"] = diagnostics_dir
    return env


def launch_fleet(num_replicas, command=(), diagnostics_dir=None,
                 max_restarts=0, restart_backoff=3.0, min_workers=1,
                 max_replicas=0, fleet_port=8900):
    """Run the serving gang until SIGTERM/SIGINT; returns the exit code
    (128 + signal, or the last replica's code when every replica left
    the fleet)."""
    fleet = _load_fleet()
    max_replicas = max_replicas or num_replicas
    killed = {}
    signal.signal(signal.SIGINT, lambda s, f: killed.setdefault("sig", s))
    signal.signal(signal.SIGTERM, lambda s, f: killed.setdefault("sig", s))

    version = os.environ.get("MXNET_TPU_FLEET_VERSION", "v0")
    command = list(command) or [sys.executable, "-m",
                                "mxnet_tpu_torch.fleet"]
    replicas = {}        # rid -> {"proc", "pump", "restarts", "ver"}

    def _replica_url(rid):
        return f"http://127.0.0.1:{fleet_port + 1 + rid}"

    def _spawn_replica(rid, restart_count, ver):
        env = replica_env(rid, fleet_port + 1 + rid, ver, restart_count,
                          diagnostics_dir)
        proc, pump = _spawn(command, env, rid, diagnostics_dir,
                            restart_count=restart_count)
        replicas[rid] = {"proc": proc, "pump": pump,
                         "restarts": restart_count, "ver": ver}
        return proc

    for rid in range(num_replicas):
        _spawn_replica(rid, 0, version)

    router = fleet.Router({rid: _replica_url(rid) for rid in replicas})
    router.start()
    front = fleet.RouterServer(router, fleet_port)
    print(f"launch: fleet front door on {front.url} "
          f"({num_replicas} replica(s), ports "
          f"{fleet_port + 1}..{fleet_port + num_replicas})", flush=True)

    target = [num_replicas]
    roll_req = []

    def _on_scale(n):
        cur = max(min_workers, min(max_replicas, int(n)))
        if cur != target[0]:
            print(f"launch: fleet scale {target[0]} -> {cur}", flush=True)
            target[0] = cur

    router.on_scale = _on_scale
    front.on_scale = _on_scale
    front.on_roll = lambda ver: roll_req.append(ver or version)

    exit_code = 0
    try:
        while not killed.get("sig"):
            time.sleep(0.2)
            # -- reap & relaunch dead replicas (independently) ---------
            for rid, st in sorted(replicas.items()):
                code = st["proc"].poll()
                if code is None:
                    continue
                _append_restart_event(diagnostics_dir, {
                    "ts": time.time(), "kind": "replica_exit",
                    "replica": rid, "exit_code": code,
                    "preempted": code == EXIT_PREEMPTED,
                    "restarts": st["restarts"]})
                if rid >= target[0]:
                    # retired by scale-down: drained, do not relaunch
                    del replicas[rid]
                    router.remove_replica(rid)
                    continue
                if st["restarts"] >= max_restarts:
                    print(f"launch: replica {rid} exited {code} with no "
                          f"restart budget left — removing from fleet",
                          file=sys.stderr, flush=True)
                    del replicas[rid]
                    router.remove_replica(rid)
                    if not replicas:
                        exit_code = code if code else 1
                        raise KeyboardInterrupt
                    continue
                backoff = restart_backoff * random.uniform(0.8, 1.2)
                print(f"launch: replica {rid} exited {code} — relaunching "
                      f"in {backoff:.1f}s (router fails its in-flight "
                      "requests over to survivors)", flush=True)
                end = time.monotonic() + backoff
                while time.monotonic() < end and not killed.get("sig"):
                    time.sleep(0.05)
                _spawn_replica(rid, st["restarts"] + 1, st["ver"])
                _append_restart_event(diagnostics_dir, {
                    "ts": time.time(), "kind": "replica_relaunch",
                    "replica": rid, "attempt": st["restarts"] + 1,
                    "exit_code": code,
                    "preempted": code == EXIT_PREEMPTED})
            # -- reconcile the autoscale target ------------------------
            live = sorted(replicas)
            if len(live) < target[0]:
                rid = next(i for i in range(max_replicas)
                           if i not in replicas)
                print(f"launch: fleet grow — spawning replica {rid}",
                      flush=True)
                _spawn_replica(rid, 0, version)
                router.add_replica(rid, _replica_url(rid))
            elif len(live) > target[0]:
                rid = live[-1]
                print(f"launch: fleet shrink — draining replica {rid}",
                      flush=True)
                router.drain(rid)
                try:
                    replicas[rid]["proc"].send_signal(signal.SIGTERM)
                except OSError:
                    pass
            # -- rolling update ----------------------------------------
            if roll_req:
                ver = roll_req.pop(0)
                print(f"launch: rolling update -> {ver}", flush=True)
                for rid in sorted(replicas):
                    if killed.get("sig"):
                        break
                    router.drain(rid)
                    router.wait_idle(rid, timeout_s=60.0)
                    st = replicas[rid]
                    try:
                        st["proc"].send_signal(signal.SIGTERM)
                    except OSError:
                        pass
                    try:
                        st["proc"].wait(timeout=60.0)
                    except subprocess.TimeoutExpired:
                        st["proc"].kill()
                        st["proc"].wait()
                    code = st["proc"].poll()
                    _append_restart_event(diagnostics_dir, {
                        "ts": time.time(), "kind": "replica_roll",
                        "replica": rid, "exit_code": code,
                        "version": ver})
                    _spawn_replica(rid, st["restarts"] + 1, ver)
                    router.undrain(rid, remote=False)
                    router.wait_healthy(rid, timeout_s=120.0, version=ver)
                version = ver
                print(f"launch: rolling update to {ver} complete",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        # zero-drop teardown: SIGTERM tells every replica to drain
        # (finish or requeue in-flight work) within the grace below
        procs = [st["proc"] for st in replicas.values()]
        pumps = [st["pump"] for st in replicas.values()]
        _terminate(procs, pumps, grace=30.0)
        front.stop()
        router.stop()
    sig = killed.get("sig")
    return exit_code if sig is None else 128 + sig


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python mxnet_tpu_torch/launch.py", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-n", "--num-workers", type=int, default=0,
                   help="the training gang: not ported (refuses)")
    p.add_argument("--serve-replicas", type=int, default=0,
                   help="spawn N replica worker processes (default "
                        "command: python -m mxnet_tpu_torch.fleet), each "
                        "one serve.Server with a fleet endpoint on "
                        "--fleet-port+1+R, behind the health-routed front "
                        "door on --fleet-port")
    p.add_argument("--fleet-port", type=int,
                   default=int(os.environ.get("MXNET_TPU_FLEET_PORT_BASE",
                                              "8900")),
                   help="front-door port; replica R listens on this port "
                        "+1+R")
    p.add_argument("--diagnostics-dir", default=None,
                   help="arm mx.diagnostics in every replica, tee each "
                        "replica's output to <dir>/<R>/worker.log and "
                        "record replica exits, relaunches and rolls in "
                        "<dir>/restarts.jsonl")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="relaunch a replica that exits up to N times")
    p.add_argument("--restart-backoff", type=float, default=3.0,
                   help="seconds before a relaunch, jittered +-20%%")
    p.add_argument("--min-workers", type=int,
                   default=int(os.environ.get("MXNET_TPU_MIN_WORKERS",
                                              "1")),
                   help="smallest fleet autoscale may shrink to")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="largest fleet autoscale may grow to (default "
                        "--serve-replicas: autoscale can only shrink)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="replica command (default python -m "
                        "mxnet_tpu_torch.fleet)")
    args = p.parse_args(argv)
    if args.num_workers:
        p.error("-n/--num-workers: the training gang is not ported yet "
                "(ROADMAP.md queue 1, \"Multi-device\"); --serve-replicas "
                "runs the serving fleet")
    if args.serve_replicas <= 0:
        p.error("--serve-replicas N is required")
    command = list(args.command)
    if command[:1] == ["--"]:
        command = command[1:]
    return launch_fleet(args.serve_replicas, command, args.diagnostics_dir,
                        max_restarts=args.max_restarts,
                        restart_backoff=args.restart_backoff,
                        min_workers=args.min_workers,
                        max_replicas=args.max_replicas,
                        fleet_port=args.fleet_port)


if __name__ == "__main__":
    sys.exit(main())
