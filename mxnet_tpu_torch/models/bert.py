"""The part of `mxnet_tpu/models/bert.py` the GPT family needs: the
fused-QKV self-attention block and the position-table slice. The rest
of BERT (encoder, pretraining heads) arrives with the training slice."""
from __future__ import annotations

from ..gluon import HybridBlock, nn
from ..ops import nn_ops


class BERTAttention(HybridBlock):
    """Self-attention with a fused QKV projection and the flash forward
    kernel; `causal=True` makes it the GPT decoder block's attention.
    Inference only: `dropout` (attention-probability dropout) applies in
    training, which this slice does not run."""

    def __init__(self, units, num_heads, dropout=0.0, dtype="float32",
                 causal=False):
        super().__init__()
        self._units = units
        self._num_heads = num_heads
        self._dropout = dropout
        self._causal = causal
        self.qkv = nn.Dense(3 * units, in_units=units, flatten=False,
                            dtype=dtype, weight_initializer="xavier")
        self.proj = nn.Dense(units, in_units=units, flatten=False,
                             dtype=dtype, weight_initializer="xavier")

    def forward(self, x, mask=None):
        # x: (B, L, E); mask: (B, L) 1 = valid
        out = nn_ops.fused_self_attention(self.qkv(x), mask,
                                          num_heads=self._num_heads,
                                          causal=self._causal)
        return self.proj(out)


def _positions(position_embed, L):
    """The first L rows of the position table (raises past its end)."""
    max_len = position_embed.shape[0]
    if L > max_len:
        raise ValueError(f"sequence length {L} exceeds max_length {max_len}")
    return position_embed[:L]
