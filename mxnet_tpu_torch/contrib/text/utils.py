"""Text token-counting utilities (reference:
python/mxnet/contrib/text/utils.py `count_tokens_from_str`)."""
from __future__ import annotations

import collections
import re


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Count tokens in a delimited string, returning (or updating) a
    `collections.Counter` keyed by token."""
    source_str = filter(
        None, re.split(token_delim + "|" + seq_delim, source_str))
    if to_lower:
        source_str = (t.lower() for t in source_str)
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(source_str)
    return counter
