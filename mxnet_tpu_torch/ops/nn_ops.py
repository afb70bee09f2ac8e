"""The neural-network ops of the port (counterpart of
`mxnet_tpu/ops/nn_ops.py`).

Plain PyTorch on tensors, with the JAX package's numerics where they
are a choice: LayerNorm statistics in float32 with the normalized value
cast back to the input dtype BEFORE gamma/beta; gelu is the tanh
approximation (`jax.nn.gelu`'s default); dropout is inverted (kept
values scaled by 1/(1-p)) and draws from the device stream of
`mxnet_tpu_torch.random`. Attention goes through the hand-written flash
kernels (`cuda_ops.flash_attention`), whose attention dropout is keyed
by a seed from the host stream.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .. import random as _random
from ..cuda_ops.flash_attention import flash_attention

__all__ = ["fully_connected", "gelu", "activation", "dropout", "embedding",
           "layer_norm", "split_heads", "fused_self_attention"]


def fully_connected(data, weight, bias=None, flatten=True):
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return tF.linear(x, weight, bias)


def gelu(data):
    return tF.gelu(data, approximate="tanh")


_ACTIVATIONS = {"tanh": torch.tanh, "gelu": gelu, "relu": torch.relu}


def activation(data, act_type):
    """`Activation(data, act_type)` for the act types the port's models
    and quantized layers use (tanh, gelu, relu)."""
    if act_type not in _ACTIVATIONS:
        raise NotImplementedError(
            f"activation {act_type!r} is not in the port (have "
            f"{sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[act_type](data)


def dropout(data, p=0.5, training=False):
    """Inverted dropout: identity outside training or when p <= 0; else
    each element is kept with probability 1-p and scaled by 1/(1-p). The
    mask draws from the device stream of `mxnet_tpu_torch.random`."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=_random.generator(data.device),
                      device=data.device) < keep
    return torch.where(mask, data / keep, 0.0).to(data.dtype)


def embedding(data, weight):
    return tF.embedding(data.long(), weight)


def layer_norm(data, gamma, beta, eps=1e-5):
    """Normalize over the last axis. torch computes the statistics in
    float32 for every input dtype and rounds the normalized value to the
    input dtype; gamma/beta (float32 masters) are applied after, in the
    input dtype, as the JAX package does."""
    out = tF.layer_norm(data, data.shape[-1:], eps=eps)
    return torch.addcmul(beta.to(data.dtype), out, gamma.to(data.dtype))


def split_heads(qkv, num_heads):
    """(B, L, 3E) fused projection -> contiguous q, k, v (B, H, L, D),
    in one copy."""
    B, L, E3 = qkv.shape
    return qkv.reshape(B, L, 3, num_heads, E3 // 3 // num_heads) \
        .permute(2, 0, 3, 1, 4).contiguous().unbind(0)


def fused_self_attention(qkv, mask=None, num_heads=1, causal=False,
                         dropout=0.0, training=False):
    """Self-attention from a fused QKV projection (B, L, 3E) -> (B, L, E)
    through the flash kernels. `dropout` is attention-probability dropout,
    active only in training: each call draws a fresh 64-bit seed from the
    host stream (no sync with the card). Sequence parallelism is not in
    the port."""
    B, L, E3 = qkv.shape
    H = num_heads
    D = E3 // 3 // H
    q, k, v = split_heads(qkv, H)
    seed = _random.next_seed() if (training and dropout > 0.0) else None
    out = flash_attention(q, k, v, mask=mask, causal=causal, dropout=dropout,
                          seed=seed)
    return out.transpose(1, 2).reshape(B, L, H * D)
