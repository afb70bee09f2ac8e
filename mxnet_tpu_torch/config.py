"""Defaults of the serving knobs (counterpart of `mxnet_tpu/config.py`).

Only the knobs the serving slice reads, with the JAX package's defaults.
A `Server` constructor argument overrides each one; `get()` gives the
default when the argument is left as None. The JAX package's `set()`
and `MXNET_TPU_<NAME>` environment layers are not ported: no caller of
the port needs them yet.
"""
from __future__ import annotations

__all__ = ["get"]

_DEFAULTS = {
    # decode batch slots per KV-cache bucket
    "serve_slots": 4,
    # bound on the admission queue; a submit beyond it triggers serve_shed
    "serve_queue_depth": 64,
    # 'reject' turns the new request away, 'oldest' displaces the longest
    # waiter (503-style verdicts)
    "serve_shed": "reject",
    # comma-separated total-length buckets; empty: powers of two floored
    # at bucket_pad_min
    "serve_buckets": "",
    "bucket_pad_min": 32,
    # 'on' serves from the refcounted page pool with prefix reuse and
    # chunked prefill
    "pages": "off",
    "pages_page_size": 16,
    # data pages in the pool (0: slots * max_length / page_size)
    "pages_pool_pages": 0,
    # prompt tokens per batched-prefill dispatch under pages="on"
    "pages_prefill_chunk": 8,
}


def get(name):
    return _DEFAULTS[name]
