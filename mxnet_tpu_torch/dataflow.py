"""Shape bucketing (the part of `mxnet_tpu/dataflow.py` the server
reads)."""
from __future__ import annotations

import math

from . import config as _config

__all__ = ["bucket_length"]


def bucket_length(length, buckets="pow2", floor=None):
    """The bucket a raw length rounds up to. `buckets` is a sorted
    sequence of sizes or "pow2" (next power of two, floored at `floor`,
    default the `bucket_pad_min` knob). Lengths above the largest
    configured bucket keep their raw size."""
    length = int(length)
    if buckets == "pow2":
        if floor is None:
            floor = max(1, int(_config.get("bucket_pad_min")))
        return max(int(floor),
                   1 << max(0, math.ceil(math.log2(max(length, 1)))))
    for b in buckets:
        if b >= length:
            return int(b)
    return length
