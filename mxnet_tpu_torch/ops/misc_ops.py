"""CTC loss (counterpart of `ctc_loss` in `mxnet_tpu/ops/misc_ops.py`;
the other ops of that module are not in the port yet).

The JAX op runs the log-space alpha recursion as a `lax.scan`, not a
Pallas kernel, so here it is ATen's `ctc_loss` (its own CUDA kernels on
the card) over a float32 log-softmax, as the JAX op normalises. ATen
reads the lengths on the host, one copy a call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["ctc_loss"]

# the JAX op's stand-in for -inf is -1e30, so a label that no alignment
# can emit within the frames costs 1e30 there, not inf
INFEASIBLE = 1e30


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist Temporal Classification loss: (N,) negative
    log-likelihoods of `label` (N, L) under `data` (T, N, C), unnormalised
    activations (softmax applied here).

    blank_label 'first': blank 0, real labels 1..C-1, padding 0; 'last':
    blank C-1, padding -1. Label lengths are `label_lengths` with
    `use_label_lengths`, else the labels that are not padding; data
    lengths are `data_lengths` with `use_data_lengths`, else T.

    A label that needs more frames than its data has (its length plus
    its repeats) costs 1e30, the JAX op's value. Its gradient is 0 here
    (ATen's `zero_infinity`); the JAX op differentiates through its
    -1e30 stand-in, which gives a finite gradient that means nothing."""
    T, N, C = data.shape
    logp = torch.log_softmax(data.float(), -1)
    label = label.to(device=data.device, dtype=torch.int64)
    blank = 0 if blank_label == "first" else C - 1
    pad = 0 if blank_label == "first" else -1
    if use_label_lengths and label_lengths is not None:
        llen = label_lengths.to(device=data.device, dtype=torch.int64)
    else:
        llen = (label != pad).sum(1)
    if use_data_lengths and data_lengths is not None:
        dlen = data_lengths.to(device=data.device, dtype=torch.int64)
    else:
        dlen = torch.full((N,), T, dtype=torch.int64, device=data.device)
    loss = tF.ctc_loss(logp, label, dlen, llen, blank=blank,
                       reduction="none", zero_infinity=True)
    inner = torch.arange(1, label.shape[1], device=data.device) < llen[:, None]
    repeats = ((label[:, 1:] == label[:, :-1]) & inner).sum(1)
    return torch.where(llen + repeats > dlen, INFEASIBLE, loss)
