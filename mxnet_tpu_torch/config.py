"""Typed runtime knobs (counterpart of `mxnet_tpu/config.py`).

Only the knobs the port reads, each declared once with the JAX
package's type, default and environment variable (`MXNET_TPU_<NAME>`).
Precedence, as in the JAX package: `set()` > the environment variable >
the declared default. Call sites read through `get()` at use time, so a
`set()` takes effect without a restart. A `Server` constructor argument
overrides the serving knobs; `get()` gives the default when the argument
is left as None.
"""
from __future__ import annotations

import os
import threading

__all__ = ["get", "set", "reset"]

_lock = threading.Lock()
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


def _register(name, default, doc, typ=None, choices=None):
    typ = typ or (type(default) if default is not None else str)
    _options[name] = _Option(name, default, typ, "MXNET_TPU_" + name.upper(),
                             doc, choices)


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
