"""Typed runtime knobs (counterpart of `mxnet_tpu/config.py`).

Only the knobs the port reads, each declared once with the JAX
package's type, default and environment variable (`MXNET_TPU_<NAME>`).
Precedence, as in the JAX package: `set()` > the environment variable >
the declared default. Call sites read through `get()` at use time, so a
`set()` takes effect without a restart. A `Server` constructor argument
overrides the serving knobs; `get()` gives the default when the argument
is left as None.

`describe()` and `option(name)` have the JAX package's return shapes;
`describe()` lists the knobs the port declares, not the JAX package's
whole surface.
"""
from __future__ import annotations

import os

from . import _locklint

__all__ = ["get", "set", "reset", "describe", "option"]

_lock = _locklint.make_lock("config.registry")
_options = {}
_overrides = {}


class _Option:
    __slots__ = ("name", "default", "typ", "env", "doc", "choices")

    def __init__(self, name, default, typ, env, doc, choices):
        self.name = name
        self.default = default
        self.typ = typ
        self.env = env
        self.doc = doc
        self.choices = choices


def _coerce(opt, raw):
    if opt.typ is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    val = opt.typ(raw)
    if opt.choices and val not in opt.choices:
        raise ValueError(
            f"config '{opt.name}' must be one of {opt.choices}, got {val!r}")
    return val


def _register(name, default, doc, typ=None, choices=None, env=None):
    typ = typ or (type(default) if default is not None else str)
    _options[name] = _Option(name, default, typ,
                             env or "MXNET_TPU_" + name.upper(), doc, choices)


def get(name):
    opt = _options[name]
    with _lock:
        if name in _overrides:
            return _overrides[name]
    raw = os.environ.get(opt.env)
    if raw is None:
        return opt.default
    return _coerce(opt, raw)


def set(name, value):  # noqa: A001 - mirrors mx.config.set
    opt = _options[name]
    with _lock:
        _overrides[name] = _coerce(opt, value)


def reset(name=None):
    with _lock:
        if name is None:
            _overrides.clear()
        else:
            _overrides.pop(name, None)


def describe():
    """Every declared knob: name -> {value, default, env, doc, source},
    `source` one of "set", "env" or "default"."""
    out = {}
    for name, opt in sorted(_options.items()):
        source = ("set" if name in _overrides
                  else "env" if os.environ.get(opt.env) is not None
                  else "default")
        out[name] = {"value": get(name), "default": opt.default,
                     "env": opt.env, "doc": opt.doc, "source": source}
    return out


def option(name):
    """The declaration record of knob `name` (name, default, typ, env,
    doc, choices)."""
    return _options[name]


_register(
    "dataloader_timeout", 300.0,
    "Seconds the process-worker DataLoader waits with no batch arriving "
    "before declaring the workers deadlocked (a CUDA call inside a "
    "forked worker). 0 disables the watchdog.")
_register(
    "trainer_async_fence_every", 0,
    "Fence ShardedTrainer.step every N steps (wait for the step's work on "
    "the card) to bound how far dispatch runs ahead of the device. 0 "
    "(default) never fences on the hot path: the fence then only happens "
    "on an explicit .item()/asscalar() or when telemetry/nan_sentinel "
    "(which fence) are enabled. step_async never fences.")
_register(
    "device_prefetch_depth", 2,
    "Batches dataflow.prefetch_to_mesh stages onto the device ahead of "
    "the consumer (the host-to-device copy overlaps device compute). Also "
    "the depth the Estimator uses when fit() is handed a gluon "
    "DataLoader. 0 disables device-side prefetch in the estimator.")
_register(
    "bucket_pad_min", 32,
    "Smallest bucket a varlen axis rounds up to under the default "
    "power-of-two policy; explicit bucket lists override it.")
_register(
    "fault_inject", "",
    "resilience fault-injection spec (comma-separated), in the JAX "
    "package's grammar. The port arms the serving kinds: "
    "'slow_client:200' (the request stream consumer stalls 200 ms per "
    "token — scheduler throughput must not care), 'burst:8@step:3' (the "
    "server fires its on_burst hook with 8 at scheduler step 3 — a "
    "deterministic load spike) and 'cancel@req:2' (cancel request 2 at "
    "the next scheduler step; @step:N picks the step); the trainer kinds "
    "'sigterm@step:5' (SIGTERM after step 5: the preemption path), "
    "'kill@step:3' (SIGKILL after step 3: rank death), "
    "'corrupt_ckpt@step:4' (flip bytes in that step's checkpoint after "
    "its manifest is written: restore must detect it) and 'oom@step:3' "
    "(a synthetic out-of-memory at the dispatch of step 3, before the "
    "step touches any state: drives the oom_recover ladder). The other "
    "kinds parse but nothing in the port fires them yet.")
_register(
    "retry_max_attempts", 3,
    "Total tries resilience.RetryPolicy makes on a retryable transient "
    "fault (a serving dispatch). 1 disables retries.")
_register(
    "retry_backoff_s", 0.5,
    "Base backoff before the first RetryPolicy retry; doubles per "
    "attempt (exponential), jittered +-25%.")
_register(
    "retry_max_backoff_s", 30.0,
    "Upper bound on a single RetryPolicy backoff sleep, whatever the "
    "attempt count.")
_register(
    "device_bytes_limit", 0,
    "Device memory capacity (bytes) the memsafe budget check compares "
    "predicted peaks against. 0 (default) reads the card's total memory "
    "(torch.cuda.mem_get_info; none on the CPU); a positive value "
    "overrides — tests simulate any capacity this way.")
_register(
    "memory_headroom_warn", 0.1,
    "Fraction of device capacity below which the memsafe budget check "
    "prints a memory-headroom warning (once per executable). 0 disables "
    "the warning (the hard budget check still raises on a predicted "
    "overrun).")
_register(
    "serve_slots", 4,
    "Decode batch slots per KV-cache bucket in the continuous-batching "
    "scheduler: each active bucket runs one batched step over this many "
    "request slots.")
_register(
    "serve_queue_depth", 64,
    "Bound on the serving admission queue. A submit beyond it triggers "
    "the serve_shed load-shedding policy instead of growing the queue "
    "without limit.")
_register(
    "serve_shed", "reject", choices=("reject", "oldest"),
    doc="Load-shedding policy when the bounded queue is full: 'reject' "
        "turns the NEW request away (503-style verdict), 'oldest' "
        "displaces the longest-waiting queued request in favor of the "
        "newcomer.")
_register(
    "serve_deadline_ms", 0.0,
    "Default per-request deadline, in milliseconds from submit "
    "(per-request deadline_ms overrides). Expired requests are evicted "
    "between decode steps — mid-generation — and their KV pages "
    "reclaimed; requests that expire while still queued are dropped "
    "with the same 504-style verdict. 0 (default) sets no deadline.")
_register(
    "serve_min_new_tokens", 1,
    "Floor for the degradation ladder's shrink rung: under memory "
    "pressure a request's max_new_tokens may be clamped down to the "
    "largest KV bucket that fits, but never below this many new tokens "
    "— beyond that the ladder moves to evict-and-requeue, then "
    "rejection.")
_register(
    "serve_buckets", "",
    "Comma-separated total-length (prompt + max_new_tokens) buckets for "
    "the serving KV caches, e.g. '64,128,256'. Empty (default) uses "
    "power-of-two buckets floored at bucket_pad_min and capped at the "
    "model's max_length.")
_register(
    "pages", "off", choices=("off", "on"),
    doc="Paged KV serving. 'off' (default) keeps the server on its dense "
        "per-bucket slot caches. 'on' replaces them with a block-granular "
        "refcounted page pool plus a content-hashed prefix tree: shared "
        "prompt prefixes prefill once, prompts prefill in chunks of "
        "pages_prefill_chunk tokens per dispatch, and a drafter model "
        "(Server(drafter=...)) adds exact-greedy speculative decoding. "
        "Emitted tokens equal pages=off's.")
_register(
    "pages_page_size", 16,
    "Tokens per KV page. Paged buckets round up to a page multiple (and "
    "the servable max_length rounds down to one), so a bucket's gathered "
    "KV equals the dense cache's shape exactly.")
_register(
    "pages_pool_pages", 0,
    "Data pages in the page pool (one scratch page per slot is added on "
    "top). 0 (default) sizes the pool to slots * max_length/page_size — "
    "the dense scheduler's worst-case KV footprint. Admission under an "
    "exhausted pool walks the degradation ladder: evict unreferenced "
    "prefix-tree leaves, shrink, evict-and-requeue, reject.")
_register(
    "pages_prefill_chunk", 8,
    "Prompt tokens per batched-prefill dispatch under pages=on (C "
    "one-token steps in one dispatch, each equal to feeding the tokens "
    "singly).")
_register(
    "pages_spec_k", 4,
    "Draft tokens per speculative decoding round (pages=on with a "
    "drafter). The drafter chains k greedy proposals, the target "
    "verifies all of them plus the bonus token in one k+1-token chunk, "
    "and exact acceptance keeps the longest agreeing prefix — the "
    "emitted stream stays equal to plain greedy decode, so k only "
    "trades dispatch count against wasted draft work.")
_register(
    "lamb_moments_dtype", "float32", choices=("float32", "bfloat16"),
    doc="Storage dtype for fused-LAMB moment buffers. 'bfloat16' halves "
        "the moments' memory and cuts the LAMB passes' bytes by a third "
        "(they are bandwidth-bound); the math stays float32 and the "
        "stored moments round through bf16 before the trust-ratio norms. "
        "Off by default.")
_register(
    "resilience", False,
    "Arm resilience at import: the SIGTERM/SIGINT preemption handler "
    "(finish the in-flight step, write a final checkpoint, exit the "
    "distinct EXIT_PREEMPTED code 83), periodic verified checkpoints "
    "(checkpoint_dir / checkpoint_every_n_steps), auto-resume (resume "
    "knob) and the fault_inject harness. Off by default: the trainer "
    "hook is one module-bool check, no signal handler is installed, and "
    "save_states/load_states write and read no manifest. "
    "resilience.install() arms at run time.")
_register(
    "checkpoint_dir", "",
    "Base directory for resilience's managed checkpoints (<dir>/step_<n>/ "
    "with an atomically renamed manifest.json carrying per-file size and "
    "CRC32, the step and the trainer fingerprint). Used by the "
    "ShardedTrainer periodic-checkpoint hook, the preemption final save "
    "and auto-resume. Empty disables managed checkpoints.")
_register(
    "checkpoint_every_n_steps", 0,
    "Save a managed checkpoint every N completed ShardedTrainer steps "
    "(needs checkpoint_dir and resilience enabled). 0 disables periodic "
    "saves; the preemption final save still fires.")
_register(
    "checkpoint_keep", 3,
    "Managed checkpoints kept under checkpoint_dir (keep-last-N; older "
    "ones and stale *.tmp-* leftovers of killed saves are removed after "
    "each save). <=0 keeps everything.")
_register(
    "resume", "",
    "Auto-resume policy for a fresh ShardedTrainer while resilience is "
    "enabled: 'auto' restores the newest checkpoint under checkpoint_dir "
    "that passes checksum and fingerprint verification (falling back "
    "past torn or corrupt ones), an explicit path restores that "
    "checkpoint, '' (default) starts fresh.")
_register(
    "remat_policy", "", choices=("", "none", "dots_saveable", "layers",
                                 "full"),
    doc="Default rematerialization policy of every block "
        "(Block.remat(policy=...) overrides per block). In increasing "
        "memory savings and recompute cost: 'none' saves every "
        "intermediate; 'dots_saveable' keeps the GEMMs' outputs and "
        "recomputes the rest (torch.utils.checkpoint with a selective "
        "policy); 'layers' checkpoints each layer (activation memory O(1) "
        "in depth; what the per-model remat=True flag means); 'full' "
        "also checkpoints the whole stack, so only its inputs survive "
        "the forward. Empty (default) defers to per-block and per-model "
        "settings.")
_register(
    "oom_recover", "off", choices=("off", "auto"),
    doc="Out-of-memory recovery at the ShardedTrainer step boundary. "
        "'off' (default) fails fast. 'auto' catches a device "
        "out-of-memory (torch.cuda.OutOfMemoryError, the budget check's "
        "MemoryBudgetError, the oom fault's SimulatedResourceExhausted) "
        "raised before the optimizer touched any state, and walks the "
        "degradation ladder: the remat policy one rung up, then (where "
        "there are data replicas; never on one card) optimizer-state "
        "sharding, then gradient accumulation x2 while the batch "
        "divides; it retries the step after each rung.")

# -- the observability layer (telemetry, trace, diagnostics, inspect) ----
_register(
    "telemetry", False,
    "Enable the mx.telemetry metrics registry and event stream at import. "
    "Off by default: every instrumentation site then reduces to a single "
    "module-bool check. mx.telemetry.enable()/disable() toggle at "
    "runtime.")
_register(
    "telemetry_jsonl_path", "",
    "When set, telemetry events are appended to this JSONL file every "
    "telemetry_flush_interval seconds and a final metrics snapshot line is "
    "written at process exit. Empty disables auto-flush; "
    "mx.telemetry.dump_jsonl(path) still works.")
_register(
    "telemetry_flush_interval", 5.0,
    "Seconds between auto-flushes of buffered telemetry events to "
    "telemetry_jsonl_path. Checked on event emission (no flush thread).")
_register(
    "diagnostics", False,
    "Arm mx.diagnostics at import: flight recorder, crash post-mortem "
    "writer (sys.excepthook + atexit + faulthandler), and — when "
    "watchdog_deadline_s > 0 — the hang watchdog. Off by default: every "
    "recording site then reduces to a single module-bool check and no "
    "ring buffer or watchdog thread exists. mx.diagnostics.install() "
    "arms at runtime.")
_register(
    "diagnostics_dir", "diagnostics",
    "Base directory for per-rank diagnostic artifacts: "
    "<dir>/<rank>/postmortem.json, faulthandler.log, "
    "watchdog_stacks.txt.")
_register(
    "diagnostics_ring_size", 256,
    "Flight-recorder capacity: the last N step/compile records kept in "
    "the in-memory ring buffer and written into postmortem.json.")
_register(
    "watchdog_deadline_s", 0.0,
    "Seconds without a completed step before the mx.diagnostics watchdog "
    "fires (names the last-entered scope, dumps all-thread stacks and a "
    "post-mortem, then re-arms on the next step). 0 disables the "
    "watchdog thread entirely.")
_register(
    "nan_sentinel", False,
    "Opt-in NaN/Inf sentinel: trainers host-fetch and finiteness-check "
    "the loss (ShardedTrainer) or global grad-norm (gluon Trainer) each "
    "step; a non-finite value writes a post-mortem and raises "
    "mx.diagnostics.NonFiniteError instead of silently corrupting the "
    "run. Works with diagnostics off (the dump then has an empty ring). "
    "Costs one device sync per step.")
_register(
    "trace", "off", choices=("off", "on"),
    doc="mx.trace step tracing. 'off' (default): every hook site "
        "(ShardedTrainer dispatch/fence, block compile, checkpoint save, "
        "serving rounds) reduces to one module-bool check — no span "
        "buffer, no recorder calls. 'on' records host-side spans tagged "
        "(rank, step) for every trace_sample_every-th step, wraps "
        "sampled steps in a torch.profiler record_function range so a "
        "profile of the card carries the same step id, and runs the "
        "step-skew probe.")
_register(
    "trace_dir", "",
    "Base directory for mx.trace span files: each rank appends its "
    "sampled spans and skew probes to <dir>/<rank>/trace.jsonl (meta "
    "line first, carrying the rank's wall-clock epoch). Empty keeps "
    "spans in memory only (bounded buffer; mx.trace.flush(path) still "
    "works).")
_register(
    "trace_sample_every", 1,
    "Record mx.trace spans for every N-th step (and every N-th record "
    "of step-less streams). 1 traces everything; raise it for always-on "
    "tracing so the span volume and the sampled-step fence cost shrink "
    "by N. Compile and checkpoint spans are always recorded.")
_register(
    "trace_skew_every", 16,
    "Run the mx.trace step-skew probe every N SAMPLED steps: the rank "
    "wall-stamps its arrival at the step boundary, feeding the "
    "step_skew_seconds / straggler_rank telemetry gauges and a "
    "flight-ring 'trace' entry. In one process the probe reports this "
    "rank alone. 0 disables the probe (spans still record).")
_register(
    "inspect", False,
    "Enable mx.inspect at import: the first step at each new signature "
    "counts its FLOPs (torch.utils.flop_counter plus the formulas of the "
    "hand-written kernels) and the device bytes it touched, and keeps a "
    "CostRecord (flops, bytes, peak memory, MFU). Off by default: every "
    "hook site then reduces to a single module-bool check. Trainers "
    "fence each step while enabled so recorded step time is device "
    "time.")
_register(
    "inspect_dir", "",
    "When set, mx.inspect writes its registry to <dir>/<rank>/inspect.json "
    "at process exit and refreshes it periodically during the run. Empty "
    "keeps the registry in memory only; mx.inspect.dump(path) still "
    "works.")
_register(
    "peak_flops", 0.0,
    "Per-card peak FLOP/s used for MFU and roofline classification. 0 "
    "(default) looks the card up by torch.cuda.get_device_name() "
    "(mx.inspect's table: dense bf16 peaks); set explicitly for cards "
    "the table does not know or for non-bf16 workloads. When neither "
    "yields a value (the CPU), MFU is reported null, never 0 or inf.")
_register(
    "check_threads", False, env="MXNET_TPU_CHECK_THREADS",
    doc="tsan-lite mode (read by _locklint.py at import, also directly "
        "from the env var): instrumented-module locks become "
        "order-recording CheckedLocks — an acquisition that closes a "
        "cycle in the lock-order graph raises LockOrderError naming both "
        "acquisition stacks, and guarded shared structures assert their "
        "lock is held on mutation. Off (default): the factories return "
        "plain threading primitives, zero overhead.")
_register(
    "goodput", "off", choices=("off", "on"),
    doc="mx.goodput wall-clock accounting. 'off' (default): every hook "
        "site (trainer step and first step at a signature, checkpoint "
        "save/restore, the OOM ladder, the serving scheduler loop) "
        "reduces to one module-bool check — no accountant state. 'on' "
        "classifies every second of run wall-clock into exhaustive, "
        "non-overlapping categories (goodput: step, serve_decode; "
        "badput: compile, checkpoint, OOM recovery, rollback replay, "
        "serve idle/degraded) with a step-id high-water mark, so steps "
        "trained again after a rollback or restart count as replay. "
        "tools/goodput_report.py merges the rank files.")
_register(
    "goodput_dir", "",
    "Base directory for mx.goodput interval files: each rank appends its "
    "classified intervals to <dir>/<rank>/goodput.jsonl (meta line "
    "first, torn-line tolerant). A relaunched rank recovers its step-id "
    "high-water mark from the existing file. Empty (default) accounts in "
    "memory only.")
_register(
    "guard", False,
    "Arm mx.guard at import: per-rank liveness heartbeats "
    "(diagnostics_dir/<rank>/heartbeat.json), the step deadline "
    "(collective_timeout_s) and the SDC digest vote (sdc_check_every). "
    "Off (default): every hook site reduces to a single module-bool "
    "check — no heartbeat record, no deadline thread, no digest.")
_register(
    "heartbeat_timeout_s", 60.0,
    "Seconds without a fresh heartbeat before a rank is considered "
    "stuck (read by a supervisor polling the heartbeat files). Also "
    "paces the heartbeat file write: at most once per timeout/4, capped "
    "at 1 s.")
_register(
    "collective_timeout_s", 0.0,
    "mx.guard deadline on the step boundary: when no step completes "
    "within this many seconds (first step onward; first steps at a new "
    "signature and checkpoint writes suspend the clock), the rank dumps "
    "a post-mortem naming the suspected dead peer and exits "
    "EXIT_PEER_LOST (86). 0 (default) runs no deadline thread.")
_register(
    "sdc_check_every", 0,
    "Run the mx.guard silent-data-corruption digest vote every N "
    "completed trainer steps: blake2b over each parameter's bytes in "
    "declaration order (one host copy of the parameters), exchanged "
    "across launcher ranks and majority-voted; a mismatch rolls back to "
    "the last verified checkpoint. 0 (default) disables.")
_register(
    "slo", "off", choices=("off", "on"),
    doc="mx.slo per-request serving observability. 'off' (default): "
        "every serve.py hook site reduces to one module-bool check — no "
        "journal object. 'on' journals every request's event timeline, "
        "classifies each terminated request against the slo_* "
        "objectives, feeds the burn-rate gauges and tail-samples full "
        "journals into slo_dir/<rank>/access.jsonl "
        "(tools/slo_report.py renders them).")
_register(
    "slo_dir", "",
    "Base directory for mx.slo exemplar journals: <dir>/<rank>/"
    "access.jsonl (meta line first). Empty (default) classifies and "
    "serves live stats only.")
_register(
    "slo_ttft_ms", 0.0,
    "SLO objective: client-visible time-to-first-token budget per "
    "request, in milliseconds. 0 (default) disables the objective.")
_register(
    "slo_tbt_ms", 0.0,
    "SLO objective: worst time-between-tokens budget per request, in "
    "milliseconds. 0 (default) disables the objective.")
_register(
    "slo_availability", 0.999,
    "SLO objective: target fraction of non-cancelled requests that must "
    "terminate 'completed'; the error budget is 1 - target.")
_register(
    "slo_burn_alert", 2.0,
    "Burn-rate alert threshold for mx.slo: a window whose error-budget "
    "burn rate reaches this multiple of the sustainable rate fires an "
    "alert (once per excursion).")
_register(
    "slo_window_fast_s", 300.0,
    "Fast burn-rate window for mx.slo, in seconds (default 5 min).")
_register(
    "slo_window_slow_s", 3600.0,
    "Slow burn-rate window for mx.slo, in seconds (default 1 h).")
_register(
    "slo_sample_every", 10,
    "mx.slo healthy-exemplar sampling: persist every N-th classified "
    "request's journal even when it met every objective. 0 persists only "
    "the tail.")
_register(
    "check", "off", choices=("off", "warn", "error"),
    doc="mx.check analysis mode. 'off' (default): the cache-miss hook "
        "sites (a hybridized block's first call at a key, the trainer's "
        "first step at a signature, the server's paged construction) "
        "reduce to one module-bool check. 'warn' lints each recorded "
        "first call (large captured constants, donation misses, bf16 -> "
        "f32 promotions, retrace hazards, degenerate paging) and reports "
        "to stderr, check_findings_total{rule=...} and "
        "check_dir/<rank>/check.json; 'error' raises CheckError.")
_register(
    "check_dir", "",
    "When set, mx.check writes its findings to <dir>/<rank>/check.json at "
    "process exit and after each new finding (tools/check_graph.py reads "
    "them). Empty keeps findings in memory.")
_register(
    "check_large_const_bytes", 1 << 20,
    "mx.check threshold: a tensor an op of the recorded call reads that "
    "is not an argument, a parameter or buffer, or a value made inside "
    "the call, at or above this many bytes, fires 'large-constant'. "
    "<=0 disables the rule.")
_register(
    "check_promotion_min_bytes", 1 << 20,
    "mx.check threshold: a bf16/f16 -> f32/f64 conversion whose output is "
    "at or above this many bytes, in a block whose parameters are "
    "lower-precision, fires 'dtype-promotion'. <=0 disables the rule.")
_register(
    "check_replicated_min_bytes", 64 << 20,
    "mx.check threshold for 'degenerate-sharding' (replicated params or "
    "batch on a data mesh of more than one device; never on one card). "
    "<=0 disables the rule.")
_register(
    "check_donation_min_bytes", 1 << 20,
    "mx.check threshold for 'donation-miss': trainer state at or above "
    "this many bytes that a step replaces with a new allocation instead "
    "of updating in place. <=0 disables the storage comparison (the "
    "donate=False detector still fires).")
_register(
    "check_retrace_limit", 4,
    "mx.check: distinct values of one signature component (an input-shape "
    "axis, or a learning rate) seen for one block or trainer before "
    "'retrace-hazard' fires. <=0 disables the rule.")
_register(
    "scope", "off", choices=("off", "on"),
    doc="mx.scope live introspection. 'off' (default): the trainer step "
        "hook reduces to one module-bool check — no HTTP thread, no "
        "socket. 'on' serves /healthz, /metrics (Prometheus text of "
        "mx.telemetry), /statusz (step rate, flight ring, memsafe, live "
        "servers' stats, slo, goodput, guard), /tracez and "
        "/profilez?steps=N (a torch.profiler capture of the next N "
        "steps) on scope_port.")
_register(
    "scope_port", 8917,
    "TCP port the mx.scope server binds (127.0.0.1). 0 picks an "
    "ephemeral port (read back with mx.scope.port()).")
_register(
    "serve", False,
    "Arm mx.serve instrumentation at import: `serve.note_dispatch` counts "
    "every batched dispatch of the serving scheduler. Off by default: the "
    "hook reduces to a single module-bool check. Constructing a "
    "serve.Server arms it regardless.")
# the fleet knobs' defaults: one table, which fleet.py's router half
# also reads when the launcher loads it without this package
from ._fleet_defaults import DEFAULTS as _FLEET  # noqa: E402

_register(
    "fleet", _FLEET["fleet"], choices=("off", "on"),
    doc="mx.fleet replicated serving. 'off' (default) is the zero-"
        "overhead fast path: no replica endpoint, no router, no fleet "
        "section in mx.scope statusz — every hook site reduces to one "
        "module-bool check. 'on' arms mx.fleet at import (read from the "
        "environment), as constructing a fleet.ReplicaEndpoint or "
        "running `python -m mxnet_tpu_torch.fleet` does: its section "
        "appears in mx.scope statusz. The router itself is stdlib-only "
        "and run by `python mxnet_tpu_torch/launch.py --serve-replicas "
        "N`.")
_register(
    "fleet_port", _FLEET["fleet_port"],
    "Base port for mx.fleet: the router's front door listens here and "
    "replica R serves its generation endpoint on port+1+R (the same "
    "base+1+rank layout as scope_port, on a separate base so the two "
    "gangs of listeners never collide).")
_register(
    "fleet_retry_max", _FLEET["fleet_retry_max"],
    "Per-request failover budget in the mx.fleet router: a request "
    "whose replica dies mid-stream (or answers a retriable overload "
    "verdict) is re-submitted to a surviving replica at most this many "
    "times — with a `skip` high-water mark so tokens already delivered "
    "are never re-sent — before the router returns a 503.")
_register(
    "fleet_health_interval_ms", _FLEET["fleet_health_interval_ms"],
    "mx.fleet router health-poll cadence: every interval the router "
    "fetches each replica's /healthz liveness and /statusz placement "
    "payload (queue depth, slot occupancy, TTFT percentiles, memsafe "
    "admission hints) with a hard per-fetch timeout, so routing "
    "decisions ride data no staler than one interval.")
_register(
    "fleet_stall_timeout_ms", _FLEET["fleet_stall_timeout_ms"],
    "mx.fleet router per-read stall bound on an in-flight generation "
    "stream: a replica that stops producing tokens for this long "
    "(wedged-but-alive — the wedge_replica drill) is treated as dead and "
    "the request fails over to a survivor. 0 disables. A replica "
    "sends a keep-alive line every quarter of this bound while its "
    "scheduler steps and the request has no new token, so a request "
    "that waits in a busy replica's queue is not taken for a wedge.")
_register(
    "fleet_drain_grace_s", _FLEET["fleet_drain_grace_s"],
    "Zero-drop drain budget: a SIGTERMed replica stops admitting, then "
    "finishes in-flight requests for up to this many seconds; whatever "
    "is still running at expiry is cancelled with a retriable verdict so "
    "the router requeues it on a survivor (replay skips already-streamed "
    "tokens). Then the process exits via the resilience preemption path "
    "(exit code 83).")
_register(
    "fleet_autoscale", _FLEET["fleet_autoscale"], choices=("off", "on"),
    doc="mx.fleet queue-wait autoscaling. 'on' grows the replica count "
        "when every healthy replica's published p99 queue wait stays "
        "above fleet_autoscale_p99_ms for a full fleet_autoscale_window_s, "
        "and shrinks when the fleet sits idle (zero queued, negligible "
        "queue wait) for the same window — clamped to [--min-workers, "
        "--max-replicas] by the launcher.")
_register(
    "fleet_autoscale_p99_ms", _FLEET["fleet_autoscale_p99_ms"],
    "Sustained p99 queue-wait threshold (milliseconds) above which the "
    "mx.fleet router asks the supervisor for one more replica; "
    "scale-down arms below one quarter of this value.")
_register(
    "fleet_autoscale_window_s", _FLEET["fleet_autoscale_window_s"],
    "How long the mx.fleet autoscale pressure signal must persist before "
    "a scale event fires — hysteresis so one burst or one idle poll "
    "cannot flap the replica count.")
_register(
    "ledger_dir", "",
    "Base directory for the mx.ledger cross-run performance ledger: "
    "`ledger.record_run` and `ledger.record_tier1` append one "
    "provenance-keyed record per run to <dir>/ledger.jsonl (append-only, "
    "torn-line tolerant). Empty (default) is the zero-overhead fast path "
    "— every hook site reduces to one module-bool check and makes zero "
    "record calls. Render, backfill and gate the history with "
    "tools/ledger_report.py, which reads the port's records unchanged.")
_register(
    "ledger_gate", "error", choices=("warn", "error"),
    doc="mx.ledger trend-gate severity: 'error' (default) exits nonzero "
        "when the drift detector CONFIRMS a regression in a "
        "like-provenance metric series (same platform, device count, "
        "smoke flag and config fingerprint — a CPU number never gates a "
        "GPU number); 'warn' reports the same verdicts but always exits "
        "zero. Smoke-mode series and unconfirmed 'suspect' drifts only "
        "ever warn, whatever this knob says.")
