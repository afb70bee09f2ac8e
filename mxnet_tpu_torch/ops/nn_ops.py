"""The neural-network ops of the serving slice (counterpart of
`mxnet_tpu/ops/nn_ops.py`).

Plain PyTorch on tensors, with the JAX package's numerics where they
are a choice: LayerNorm statistics in float32 with the normalized value
cast back to the input dtype BEFORE gamma/beta; gelu is the tanh
approximation (`jax.nn.gelu`'s default). Attention goes through the
hand-written flash forward kernel (`cuda_ops.flash_attention`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ..cuda_ops.flash_attention import flash_attention

__all__ = ["fully_connected", "gelu", "embedding", "layer_norm",
           "split_heads", "fused_self_attention"]


def fully_connected(data, weight, bias=None, flatten=True):
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return tF.linear(x, weight, bias)


def gelu(data):
    return tF.gelu(data, approximate="tanh")


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


def fused_self_attention(qkv, mask=None, num_heads=1, causal=False):
    """Self-attention from a fused QKV projection (B, L, 3E) -> (B, L, E)
    through the flash forward kernel. Inference only: attention dropout
    and sequence parallelism arrive with later slices."""
    B, L, E3 = qkv.shape
    H = num_heads
    D = E3 // 3 // H
    q, k, v = split_heads(qkv, H)
    out = flash_attention(q, k, v, mask=mask, causal=causal)
    return out.transpose(1, 2).reshape(B, L, H * D)
