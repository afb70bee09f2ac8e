"""mx.ledger — persistent cross-run performance & quality ledger
(counterpart of `mxnet_tpu/ledger.py`).

A benchmark or sweep appends ONE record per run to an append-only JSONL
ledger (`<ledger_dir>/ledger.jsonl`), so the perf trajectory becomes
queryable, provenance-keyed history:

  {"kind": "run", "schema": 1, "ts": ..., "bench": "...",
   "provenance": {"platform": "gpu", "devices": 1, "smoke_mode": false,
                  "git_rev": "...", "fingerprint": "1a2b3c4d",
                  "knobs": {...perf-relevant config...}},
   "metrics": {"fleet_tokens_per_sec": 212.4, "...": ...},
   "digest": {"step_p50_ms": ..., "step_p99_ms": ..., "compiles": ...,
              "recompiles": ..., "mfu": ...},
   "rows": [...the raw bench JSON rows...]}

The record schema, the torn-line-tolerant append and read, the
provenance key, `flatten_metrics` with its direction tables, `series`,
the windowed median+MAD drift detector (`detect`, `verdict`) and the
gate are the JAX package's, so `tools/ledger_report.py` reads, renders
and gates a ledger this module wrote, unchanged. Series are grouped
STRICTLY by (bench, platform, devices, smoke_mode, config-fingerprint):
a CPU number can never land in the same series as a card number.

Where the port differs:
  * `PERF_KNOBS` lists the perf-relevant knobs the port declares
    (`lamb_moments_dtype`, `bucket_pad_min`, `remat_policy` and the
    `serve_*` ones). The JAX tuple's `kernels`, `kernels_min_elements`,
    `pallas_bwd_min_len`, `fused_lamb` and `prng` have no meaning in the
    port (it has no switch away from its kernels and no TPU generators),
    and `zero`, `zero_min_size` and `device_prefetch_depth` wait for the
    modules that read them; `config_fingerprint` skips a knob that is
    not declared, as the JAX function does.
  * A record written by a process that has initialised CUDA says
    `"platform": "gpu"` and `"devices": 1` (one card a process) with
    `"smoke_mode": false` unless its rows say otherwise: torch is read
    from `sys.modules`, never imported, so a card number never shares a
    series with a CPU or TPU number.

Off (`ledger_dir` unset) is the usual zero-overhead fast path: every
hook site reduces to one module-bool check and makes zero record_run()
calls. The file format is torn-line tolerant both ways: readers skip
malformed lines, and appends that find a torn final line (a crashed
writer) start on a fresh line. `record_run` and `record_tier1` are the
hooks the port's benchmark and sweeps call; `enable()` arms them from
the `ledger_dir` knob, at import when it is set.

Everything below is stdlib-only and the package-relative imports are
optional, so the module also loads by file path, as
`tools/ledger_report.py` loads the JAX package's.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import sys
import time

try:                          # normal package import (benchmarks, tests)
    from . import _locklint as _locklint
    from . import config as _config
except ImportError:           # loaded by file path: stdlib-only, no
    _locklint = None          # config, read/analyse only
    _config = None

if _locklint is not None:
    _lock = _locklint.make_rlock("ledger.module")
else:
    import threading
    _lock = threading.RLock()

SCHEMA = 1
# the package whose telemetry and goodput the digests read (by name in
# sys.modules; a file-path load has no package and reads none)
_PKG = __package__ or "mxnet_tpu_torch"
LEDGER_FILE = "ledger.jsonl"
TIER1_BUDGET_S = 870.0        # the tier-1 sweep timeout ci watches

# perf-relevant knobs folded into the provenance fingerprint: a change
# to any of these starts a NEW metric series (the number means
# something different now), exactly like switching platforms does.
PERF_KNOBS = (
    "lamb_moments_dtype", "bucket_pad_min", "remat_policy",
    "serve_slots", "serve_queue_depth", "serve_shed", "serve_buckets",
)

# direction tables, the JAX package's (tools/bench_diff.py's, the
# benches' per-row fields and the tier-1 budget fields). Lookup is by the FINAL dot-segment of a metric
# name; names not listed default to higher-is-better (throughputs).
HIGHER_BETTER = (
    "value", "tokens_per_sec", "requests_per_sec", "mfu",
    "achieved_tflops", "vs_baseline", "compile_cache_hit",
    "memory_headroom_bytes", "completed", "int8_tokens_per_sec",
    "int8_requests_per_sec", "int8_completed", "speedup",
    "native", "python", "dataloader_w1", "dataloader_w8",
    "fwd_tflops", "fwd_mxu_eff", "fwdbwd_mxu_eff", "lamb_eff_gbps",
    "matmul_ceiling_tflops", "achievable_mfu", "passed", "ok",
    "goodput_fraction", "fleet_tokens_per_sec",
    "fleet_scaling_efficiency", "single_tokens_per_sec",
    "fleet_completed",
)
LOWER_BETTER = (
    "step_p99_ms", "compile_time_s", "recompile_count",
    "input_stall_fraction", "peak_host_rss_mb", "ttft_p50_ms",
    "ttft_p99_ms", "step_skew_p99_ms", "deadline_missed", "shed",
    "rejected", "oom_recoveries", "check_findings", "requeues",
    "degraded", "int8_ttft_p50_ms", "int8_ttft_p99_ms", "pallas_ms",
    "xla_ms", "ms", "fwd_ms", "fwdbwd_ms", "lamb_apply_ms",
    "ms_per_dispatch", "tbt_p99_ms", "slo_violations", "wall_s",
    "failed", "errors", "rc", "failover_dropped_requests",
)

_enabled = False
_dir = None
_meta_paths = set()
_warned_paths = set()


# ---------------------------------------------------------------------------
# enable / disable
# ---------------------------------------------------------------------------

def enabled():
    return _enabled


def enable(ledger_dir=None):
    """Arm the ledger. Hook sites start appending run records to
    `<ledger_dir>/ledger.jsonl`; default dir from the `ledger_dir` knob
    (MXNET_TPU_LEDGER_DIR)."""
    global _enabled, _dir
    with _lock:
        if ledger_dir is None and _config is not None:
            ledger_dir = _config.get("ledger_dir")
        if not ledger_dir:
            raise ValueError("mx.ledger.enable() needs a ledger_dir "
                             "(argument or the ledger_dir knob)")
        _dir = str(ledger_dir)
        _enabled = True


def disable():
    global _enabled
    with _lock:
        _enabled = False


def reset():
    global _enabled, _dir
    with _lock:
        _enabled = False
        _dir = None
        _meta_paths.clear()
        _warned_paths.clear()


def ledger_path(ledger_dir=None):
    d = ledger_dir if ledger_dir is not None else _dir
    if not d:
        return None
    return os.path.join(str(d), LEDGER_FILE)


# ---------------------------------------------------------------------------
# append / read (torn-line tolerant both ways)
# ---------------------------------------------------------------------------

def append_record(path, rec):
    """Append one JSON record as one line. A torn final line left by a
    crashed writer is healed by starting on a fresh line; the torn
    fragment itself is skipped by readers. Returns True on success
    (I/O errors warn once per path and drop the record — a full disk
    must not fail the bench that was being measured)."""
    line = json.dumps(rec, sort_keys=True)
    with _lock:
        need_meta = path not in _meta_paths
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            prefix = ""
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    if f.tell() > 0:
                        f.seek(-1, os.SEEK_END)
                        if f.read(1) != b"\n":
                            prefix = "\n"      # heal the torn line
            except OSError:
                pass                           # fresh file
            with open(path, "a", buffering=1) as f:
                if need_meta and prefix == "" and f.tell() == 0:
                    f.write(json.dumps(
                        {"kind": "meta", "schema": SCHEMA,
                         "ts": time.time(),
                         "host": socket.gethostname(),
                         "pid": os.getpid()}, sort_keys=True) + "\n")
                f.write(prefix + line + "\n")
            _meta_paths.add(path)
            return True
        except OSError as exc:
            if path not in _warned_paths:
                _warned_paths.add(path)
                import warnings
                warnings.warn(f"mx.ledger: cannot append to {path}: "
                              f"{exc}")
            return False


def read_records(path_or_dir):
    """All well-formed records from a ledger file (or the ledger.jsonl
    inside a directory), in file order. Torn/garbage lines — a crashed
    writer's final line, a concatenated fragment — are skipped, never
    fatal."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        path = os.path.join(path_or_dir, LEDGER_FILE)
    recs = []
    try:
        f = open(path)
    except OSError:
        return recs
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------

def git_rev():
    """Short git revision of the repo this module lives in, or None."""
    try:
        import subprocess
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                __file__))),
            capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except Exception:
        return None


def config_fingerprint():
    """(hex8, knobs) over the perf-relevant knobs — the part of the
    provenance key that says 'this number was measured under these
    settings'. (None, None) when loaded standalone without config."""
    if _config is None:
        return None, None
    knobs = {}
    for name in PERF_KNOBS:
        try:
            knobs[name] = _config.get(name)
        except KeyError:
            continue
    blob = json.dumps(knobs, sort_keys=True, default=str)
    return hashlib.blake2b(blob.encode(), digest_size=4).hexdigest(), \
        knobs


def provenance_of_rows(rows):
    """(platform, devices, smoke_mode) recovered from bench rows.

    Post-PR-11 rows carry the fields explicitly; pre-PR-11 rows are
    classified from the recorded 'CPU smoke-mode' error annotation
    (same rule as tools/bench_diff.py). Unknown stays None — an
    unknown row can never share a series with a known one."""
    platform = devices = smoke = None
    for row in rows or ():
        if not isinstance(row, dict):
            continue
        if platform is None and row.get("platform") is not None:
            platform = row.get("platform")
        if devices is None and row.get("devices") is not None:
            devices = row.get("devices")
        if smoke is None and row.get("smoke_mode") is not None:
            smoke = bool(row.get("smoke_mode"))
    if platform is None or smoke is None:
        for row in rows or ():
            err = row.get("error") if isinstance(row, dict) else None
            if isinstance(err, str) and "CPU smoke-mode" in err:
                platform = platform or "cpu"
                smoke = True if smoke is None else smoke
                break
    return platform, devices, smoke


def torch_provenance():
    """(platform, devices, smoke_mode) of this process from torch:
    ("gpu", 1, False) once CUDA is initialised (the port runs on one card
    a process), else (None, None, None). Reads torch from sys.modules,
    never imports it."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            return "gpu", 1, False
    except Exception:
        pass
    return None, None, None


def build_provenance(rows=None, platform=None, devices=None,
                     smoke_mode=None, rev=None, fingerprint=None,
                     knobs=None):
    """The full provenance dict for a record. Explicit arguments win;
    otherwise platform/devices/smoke come from the rows, then from torch
    (`torch_provenance`), the rev from git, the fingerprint from the
    live config."""
    r_platform, r_devices, r_smoke = provenance_of_rows(rows)
    if platform is None:
        platform = r_platform
    if devices is None:
        devices = r_devices
    if smoke_mode is None:
        smoke_mode = r_smoke
    if platform is None:
        platform, t_devices, t_smoke = torch_provenance()
        if platform is not None:
            devices = t_devices if devices is None else devices
            smoke_mode = t_smoke if smoke_mode is None else smoke_mode
    if fingerprint is None and knobs is None:
        fingerprint, knobs = config_fingerprint()
    if rev is None:
        rev = git_rev()
    return {"platform": platform, "devices": devices,
            "smoke_mode": smoke_mode, "git_rev": rev,
            "fingerprint": fingerprint, "knobs": knobs}


def provenance_key(rec):
    """The like-provenance grouping key. Two records compare ONLY when
    every component matches — platform, device count, smoke flag and
    config fingerprint — so CPU-smoke vs TPU is not a warning but a
    different key."""
    prov = rec.get("provenance") or {}
    return "bench={}|platform={}|devices={}|smoke={}|cfg={}".format(
        rec.get("bench"), prov.get("platform"), prov.get("devices"),
        prov.get("smoke_mode"), prov.get("fingerprint"))


# ---------------------------------------------------------------------------
# metric flattening
# ---------------------------------------------------------------------------

def _row_prefix(row, index, n_rows):
    for key in ("metric", "phase", "path", "config", "kernel"):
        v = row.get(key)
        if isinstance(v, str) and v:
            return v
    return "" if n_rows == 1 else "row%d" % index


def flatten_metrics(rows):
    """{metric_name: value} across the run's rows. Multi-row benches
    prefix each row's pairing key (metric / phase / path / config);
    the generic 'value' field collapses onto the prefix itself so
    bench.py's headline metric keeps its own name."""
    out = {}
    rows = [r for r in (rows or ()) if isinstance(r, dict)]
    for i, row in enumerate(rows):
        prefix = _row_prefix(row, i, len(rows))
        for field, val in row.items():
            if isinstance(val, bool):
                val = int(val) if field in HIGHER_BETTER + LOWER_BETTER \
                    else None
            if not isinstance(val, (int, float)) or val is None:
                continue
            if field not in HIGHER_BETTER and field not in LOWER_BETTER:
                continue
            if field == "value":
                name = prefix or "value"
            else:
                name = f"{prefix}.{field}" if prefix else field
            out[name] = val
    return out


def higher_is_better(name):
    field = name.rsplit(".", 1)[-1]
    if field in LOWER_BETTER:
        return False
    return True


# ---------------------------------------------------------------------------
# telemetry digest
# ---------------------------------------------------------------------------

def telemetry_digest():
    """Compact digest of the live telemetry registry — step p50/p99,
    compile counts, mfu when non-null. Never imports telemetry (the
    ledger stays loadable without the package): reads it only when
    already in sys.modules."""
    tel = sys.modules.get(_PKG + ".telemetry")
    if tel is None:
        return None
    out = {"step_p50_ms": None, "step_p99_ms": None, "compiles": None,
           "recompiles": None, "mfu": None}
    try:
        m = tel._metrics.get("trainer_step_seconds")
        if m is not None and getattr(m, "count", 0):
            out["step_p50_ms"] = round(m.percentile(50) * 1e3, 3)
            out["step_p99_ms"] = round(m.percentile(99) * 1e3, 3)
        for src, dst in (("compile_total", "compiles"),
                         ("recompile_total", "recompiles")):
            m = tel._metrics.get(src)
            if m is not None:
                out[dst] = m.value
        m = tel._metrics.get("mfu_ratio")
        if m is not None and m.value:          # null-backed: 0 = unset
            out["mfu"] = round(m.value, 4)
    except Exception:
        return None
    if all(v is None for v in out.values()):
        return None
    return out


def goodput_digest():
    """Compact digest of the live mx.goodput accountant — the goodput
    fraction, per-category seconds, top badput cause, high-water step.
    Same no-import discipline as telemetry_digest(): read only when the
    module is already in sys.modules and armed."""
    gp = sys.modules.get(_PKG + ".goodput")
    if gp is None or not getattr(gp, "_enabled", False):
        return None
    try:
        snap = gp.snapshot()
        return {"goodput_fraction": snap.get("goodput_fraction"),
                "goodput_s": snap.get("goodput_s"),
                "badput_s": snap.get("badput_s"),
                "untracked_s": snap.get("untracked_s"),
                "top_badput_cause": snap.get("top_badput_cause"),
                "categories": snap.get("categories"),
                "hw_step": snap.get("hw_step")}
    except Exception:
        return None


# ---------------------------------------------------------------------------
# record builders / hooks
# ---------------------------------------------------------------------------

def build_run_record(bench, rows, provenance=None, ts=None, source=None,
                     label=None, digest=None):
    """A 'run' record (pure — nothing appended). `provenance` may be a
    prebuilt dict (backfill, tests); otherwise it is derived from the
    rows + live config + git."""
    if provenance is None:
        provenance = build_provenance(rows)
    if digest is None:
        digest = telemetry_digest()
        gd = goodput_digest()
        if gd is not None:
            digest = dict(digest or {})
            digest["goodput"] = gd
    ts = time.time() if ts is None else ts
    rec = {"kind": "run", "schema": SCHEMA, "bench": bench, "ts": ts,
           "iso": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)),
           "provenance": provenance,
           "metrics": flatten_metrics(rows),
           "rows": list(rows or ()),
           "digest": digest}
    if source is not None:
        rec["source"] = source
    if label is not None:
        rec["label"] = label
    return rec


def record_run(bench, rows, **kwargs):
    """The bench hook: build and append one run record. Returns the
    record, or None when the ledger is off (callers gate on enabled()
    first — this is belt and braces, not the fast path)."""
    if not _enabled:
        return None
    rec = build_run_record(bench, rows, **kwargs)
    append_record(ledger_path(), rec)
    return rec


def build_tier1_record(wall_s, passed, failed, errors=0, skipped=0,
                       slowest=None, budget_s=TIER1_BUDGET_S, ts=None,
                       provenance=None):
    """A 'tier1' record: the ci sweep's wall time against the timeout
    budget, pass/fail counts, and the top slowest test durations."""
    if provenance is None:
        provenance = build_provenance(
            platform="cpu", smoke_mode=False)
    ts = time.time() if ts is None else ts
    return {"kind": "tier1", "schema": SCHEMA, "bench": "tier1",
            "ts": ts,
            "iso": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(ts)),
            "provenance": provenance,
            "wall_s": round(float(wall_s), 1),
            "budget_s": float(budget_s),
            "passed": int(passed), "failed": int(failed),
            "errors": int(errors), "skipped": int(skipped),
            "slowest": [[name, round(float(secs), 2)]
                        for name, secs in (slowest or [])[:10]],
            "metrics": {"wall_s": round(float(wall_s), 1),
                        "passed": int(passed), "failed": int(failed),
                        "errors": int(errors)}}


def record_tier1(wall_s, passed, failed, **kwargs):
    if not _enabled:
        return None
    rec = build_tier1_record(wall_s, passed, failed, **kwargs)
    append_record(ledger_path(), rec)
    return rec


# ---------------------------------------------------------------------------
# series extraction — strictly like-provenance
# ---------------------------------------------------------------------------

def series(records):
    """{(provenance_key, metric): [point, ...]} over run/tier1 records
    in ledger order. Grouping is strictly by like-provenance: records
    with different platform / devices / smoke_mode / fingerprint land
    in DISJOINT series and are never compared. Each point is
    {"value", "ts", "label", "index"} (index = position among the
    record stream, for 'first bad run' naming)."""
    out = {}
    for idx, rec in enumerate(records):
        if rec.get("kind") not in ("run", "tier1"):
            continue
        key = provenance_key(rec)
        label = rec.get("source") or rec.get("label") \
            or (rec.get("provenance") or {}).get("git_rev") \
            or rec.get("iso") or f"#{idx}"
        for metric, value in (rec.get("metrics") or {}).items():
            if not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            out.setdefault((key, metric), []).append(
                {"value": float(value), "ts": rec.get("ts"),
                 "label": label, "index": idx})
    return out


# ---------------------------------------------------------------------------
# drift detection — windowed median + MAD
# ---------------------------------------------------------------------------

def _median(vals):
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def detect(values, higher_better=True, window=8, min_samples=3,
           z_thresh=4.0, rel_thresh=0.10, rel_floor=0.02,
           confirm_rel=0.25):
    """Per-point drift flags for one metric series.

    For each point i with at least `min_samples` predecessors, the
    baseline is the up-to-`window` immediately preceding values:
    med = median(baseline), mad = median(|v - med|). The robust scale
    is max(1.4826*mad, rel_floor*|med|) — the floor keeps a perfectly
    flat history (mad = 0) from flagging measurement noise. A point is
    flagged when its move in the BAD direction exceeds both
    z_thresh robust-sigmas and rel_thresh relative.

    Returns one dict per point: {"flag", "z", "rel", "median", "mad"}
    (all-None fields for the first min_samples points)."""
    out = []
    for i, v in enumerate(values):
        if i < min_samples:
            out.append({"flag": None, "z": None, "rel": None,
                        "median": None, "mad": None})
            continue
        base = values[max(0, i - window):i]
        med = _median(base)
        mad = _median([abs(b - med) for b in base])
        scale = max(1.4826 * mad, rel_floor * abs(med), 1e-12)
        worse = (med - v) if higher_better else (v - med)
        z = worse / scale
        rel = worse / abs(med) if med else (float("inf") if worse > 0
                                            else 0.0)
        out.append({"flag": bool(z >= z_thresh and rel >= rel_thresh),
                    "z": round(z, 3), "rel": round(rel, 4),
                    "median": med, "mad": mad})
    return out


def verdict(points, higher_better=True, **detect_kwargs):
    """The series verdict, judged at its LAST point.

    - 'insufficient': fewer than min_samples+1 points — no call.
    - 'ok': the last point is not flagged (an earlier excursion that
      recovered does not fail the gate).
    - 'confirmed': the last point is flagged AND either the move is
      large (rel >= confirm_rel) or the previous point was flagged too
      — a sustained or unmistakable regression.
    - 'suspect': the last point is flagged but small and unconfirmed —
      reported, never fatal.

    `first_bad` is the label/index of the earliest point in the
    trailing flagged streak — the first bad run."""
    min_samples = detect_kwargs.get("min_samples", 3)
    confirm_rel = detect_kwargs.pop("confirm_rel", 0.25)
    values = [p["value"] for p in points]
    if len(values) < min_samples + 1:
        return {"status": "insufficient", "first_bad": None,
                "detail": None}
    marks = detect(values, higher_better, confirm_rel=confirm_rel,
                   **detect_kwargs)
    last = marks[-1]
    if not last["flag"]:
        return {"status": "ok", "first_bad": None, "detail": last}
    first = len(marks) - 1
    while first > 0 and marks[first - 1]["flag"]:
        first -= 1
    sustained = len(marks) >= 2 and bool(marks[-2]["flag"])
    status = "confirmed" if (last["rel"] >= confirm_rel or sustained) \
        else "suspect"
    return {"status": status,
            "first_bad": {"label": points[first]["label"],
                          "index": points[first]["index"],
                          "value": points[first]["value"]},
            "detail": last}


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def gate(records, **detect_kwargs):
    """Judge every like-provenance series in the ledger.

    Returns (rc, findings): rc 0 = clean (or warn-only), 1 = at least
    one CONFIRMED regression on non-smoke provenance, 2 = nothing had
    enough history to judge. Smoke-mode series never fail the gate —
    a CPU fallback number regressing is a warning, not a block (the
    chip number is the one that matters). Each finding is
    {"key", "metric", "status", "first_bad", "severity"} with severity
    'fail' | 'warn'."""
    findings = []
    judged = 0
    failed = False
    for (key, metric), pts in sorted(series(records).items()):
        v = verdict(pts, higher_is_better(metric), **detect_kwargs)
        if v["status"] == "insufficient":
            continue
        judged += 1
        if v["status"] == "ok":
            continue
        smoke = "|smoke=True" in key
        severity = "warn"
        if v["status"] == "confirmed" and not smoke:
            severity = "fail"
            failed = True
        findings.append({"key": key, "metric": metric,
                         "status": v["status"],
                         "first_bad": v["first_bad"],
                         "detail": v["detail"],
                         "severity": severity})
    if judged == 0:
        return 2, findings
    return (1 if failed else 0), findings


# arm at import when configured, like telemetry/trace/slo
if _config is not None and _config.get("ledger_dir"):
    enable()
