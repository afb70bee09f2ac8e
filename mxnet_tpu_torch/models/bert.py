"""BERT (counterpart of `mxnet_tpu/models/bert.py`): the encoder, the
pretraining heads (MLM + NSP) and their loss, GluonNLP's fine-tuning
heads (`BERTForQuestionAnswering` with `bert_qa_loss` for SQuAD,
`BERTClassifier` for GLUE), and the fused-QKV self-attention block the
GPT family shares.

Attention runs the hand-written flash kernels (forward and backward,
attention-probability dropout in the kernels); the rest is plain
PyTorch: GEMMs, embeddings, LayerNorm, elementwise. The MLM head gathers
the masked positions BEFORE the vocabulary product, so the (B, P, V)
logits, not (B, L, V), are computed, and decodes with the word embedding
(tied, no weight of its own) plus a separate `mlm_bias`. Parameter paths
are the JAX package's `collect_params()` paths.

The encoder stack runs under the remat policy (`memsafe.POLICIES`):
`Block.remat(policy)` on the model, else the `remat_policy` knob, else
the config's `remat` (True is the "layers" alias, a policy name is
itself). "layers" runs each encoder layer under `torch.utils.checkpoint`
(`_remat.remat_call`): only a layer's (x, mask) boundary outlives the
forward, and the backward recomputes the rest; "dots_saveable" also
keeps the GEMMs' outputs; "full" adds one checkpoint around the whole
stack. The recomputation replays the port's random streams
(`random.get_state` / `set_state`), so it draws the hidden dropout masks
and attention-dropout seeds of the first forward, and leaves the
streams where they stood. Remat applies where autograd records (a
training step), as the JAX package applies it only inside a trace.

Differences from the JAX package: PyTorch runs eagerly, so the configs'
`scan_layers` (a compile-time choice) has no effect; `seq_parallel` is
not in the port and raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from .. import context
from ..gluon import HybridBlock, nn
from ..gluon.block import training
from ..gluon.parameter import Parameter
from ..ndarray.ndarray import NDArray, tensor_args
from ..ops import nn_ops
from .. import memsafe as _memsafe
from ._remat import remat_policy, stack_call


def bert_base_config(**overrides):
    cfg = dict(vocab_size=30522, units=768, hidden_size=3072, num_layers=12,
               num_heads=12, max_length=512, type_vocab_size=2, dropout=0.1,
               attn_dropout=None, seq_parallel=False, dtype="float32",
               remat=False, scan_layers=False)
    cfg.update(overrides)
    return cfg


def bert_large_config(**overrides):
    """BERT-large: 24 layers of 1024 units, 16 heads, per-layer remat."""
    cfg = bert_base_config(units=1024, hidden_size=4096, num_layers=24,
                           num_heads=16, remat=True, scan_layers=True)
    cfg.update(overrides)
    return cfg


def bert_tiny_config(**overrides):
    """Test-scale config."""
    cfg = bert_base_config(vocab_size=128, units=64, hidden_size=128,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    cfg.update(overrides)
    return cfg


class BERTAttention(HybridBlock):
    """Self-attention with a fused QKV projection and the flash kernels;
    `causal=True` makes it the GPT decoder block's attention. `dropout`
    is attention-probability dropout, applied in training mode."""

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
                                          causal=self._causal,
                                          dropout=self._dropout,
                                          training=training(self))
        return self.proj(out)


class BERTEncoderLayer(HybridBlock):
    """Post-LN encoder layer: attention -> dropout -> +res -> LN, then
    gelu FFN -> dropout -> +res -> LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 dtype="float32", attn_dropout=None):
        super().__init__()
        self.attention = BERTAttention(
            units, num_heads,
            dropout if attn_dropout is None else attn_dropout, dtype)
        self.attn_ln = nn.LayerNorm(in_channels=units)
        self.ffn_in = nn.Dense(hidden_size, in_units=units, flatten=False,
                               dtype=dtype, weight_initializer="xavier")
        self.ffn_out = nn.Dense(units, in_units=hidden_size, flatten=False,
                                dtype=dtype, weight_initializer="xavier")
        self.ffn_ln = nn.LayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        attn = self.attention(x, mask)
        if self.dropout:
            attn = self.dropout(attn)
        x = self.attn_ln(x + attn)
        h = self.ffn_out(nn_ops.activation(self.ffn_in(x), "gelu"))
        if self.dropout:
            h = self.dropout(h)
        return self.ffn_ln(x + h)


def _positions(position_embed, L):
    """The first L rows of the position table (raises past its end)."""
    max_len = position_embed.shape[0]
    if L > max_len:
        raise ValueError(f"sequence length {L} exceeds max_length {max_len}")
    return position_embed[:L]


class BERTModel(HybridBlock):
    """Embeddings + encoder stack + pooler. Returns (sequence output
    (B, L, E), pooled first-token output (B, E))."""

    # remat policies route here (`Block.remat`, the `remat_policy` knob):
    # the layer stack checkpoints per layer, not the whole block
    _remat_handles_policy = True

    def __init__(self, vocab_size, units, hidden_size, num_layers, num_heads,
                 max_length=512, type_vocab_size=2, dropout=0.1,
                 attn_dropout=None, seq_parallel=False, dtype="float32",
                 remat=False, scan_layers=False):
        super().__init__()
        if seq_parallel:
            raise NotImplementedError(
                "sequence parallelism is not in the port")
        self._remat = remat_policy(remat)
        self.word_embed = nn.Embedding(vocab_size, units, dtype=dtype,
                                       weight_initializer="xavier")
        self.token_type_embed = nn.Embedding(type_vocab_size, units,
                                             dtype=dtype,
                                             weight_initializer="xavier")
        self.position_embed = Parameter("position_weight",
                                        (max_length, units), dtype, "xavier")
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(BERTEncoderLayer(units, hidden_size, num_heads,
                                             dropout, dtype,
                                             attn_dropout=attn_dropout))
        self.pooler = nn.Dense(units, in_units=units, flatten=False,
                               activation="tanh", dtype=dtype,
                               weight_initializer="xavier")

    def forward(self, inputs, token_types=None, valid_length=None):
        L = inputs.shape[1]
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(x + _positions(self.position_embed, L)[None])
        if self.embed_dropout:
            x = self.embed_dropout(x)
        mask = None
        if valid_length is not None:
            mask = torch.arange(L, device=x.device)[None, :] \
                < valid_length.to(x.device).long()[:, None]
        x = stack_call(self.layers, x, mask, _memsafe.effective_policy(
            self._remat_policy, self._remat))
        return x, self.pooler(x[:, 0])


class BERTForPretraining(HybridBlock):
    """MLM + NSP heads over `BERTModel`.

    `device=None` builds the parameters on the card (raising when there
    is none); pass `device="cpu"` to build them on the CPU."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        units, vocab = cfg["units"], cfg["vocab_size"]
        with context.resolve(device):
            self.bert = BERTModel(**cfg)
            self.mlm_transform = nn.Dense(units, in_units=units,
                                          flatten=False, dtype=cfg["dtype"],
                                          weight_initializer="xavier")
            self.mlm_ln = nn.LayerNorm(in_channels=units)
            # the decoder is tied to the word embedding; its bias is not
            self.mlm_bias = Parameter("mlm_bias", (vocab,), "float32",
                                      "zeros")
            self.nsp = nn.Dense(2, in_units=units, dtype=cfg["dtype"],
                                weight_initializer="xavier")

    @property
    def device(self):
        return self.bert.word_embed.weight.device

    def forward(self, inputs, token_types, valid_length, masked_positions):
        """Returns (mlm_scores (B, P, V), nsp_scores (B, 2)); the scores
        are float32 (the float32 `mlm_bias` promotes them, as in the JAX
        package)."""
        seq, pooled = self.bert(inputs, token_types, valid_length)
        idx = masked_positions.to(seq.device).long()
        gathered = torch.gather(
            seq, 1, idx[..., None].expand(-1, -1, seq.shape[-1]))
        h = self.mlm_ln(nn_ops.activation(self.mlm_transform(gathered),
                                          "gelu"))
        scores = torch.matmul(h, self.bert.word_embed.weight.t()) \
            + self.mlm_bias
        return scores, self.nsp(pooled)


class BERTForQuestionAnswering(HybridBlock):
    """SQuAD span extraction over `BERTModel` (reference: GluonNLP's
    BertForQA, `scripts/bert/finetune_squad.py`): one Dense `span`
    projects each token to (start, end) logits.

    `device=None` builds the parameters on the card (raising when there
    is none) or in the entered context; pass `device="cpu"` to build
    them on the CPU."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        with context.resolve(device):
            self.bert = BERTModel(**cfg)
            self.span = nn.Dense(2, in_units=cfg["units"], flatten=False,
                                 dtype=cfg["dtype"],
                                 weight_initializer="xavier")

    def forward(self, inputs, token_types, valid_length=None):
        """Returns (start_logits (B, L), end_logits (B, L)); positions at
        or past `valid_length` get -1e9, so a softmax ignores padding."""
        seq, _ = self.bert(inputs, token_types, valid_length)
        logits = self.span(seq)                       # (B, L, 2)
        start, end = logits[..., 0], logits[..., 1]
        if valid_length is not None:
            L = logits.shape[1]
            live = torch.arange(L, device=logits.device)[None, :] \
                < valid_length.to(logits.device).long()[:, None]
            start = torch.where(live, start, -1e9)
            end = torch.where(live, end, -1e9)
        return start, end


def bert_qa_loss(start_logits, end_logits, start_positions, end_positions):
    """The mean of the start and end cross-entropies of the gold
    positions, in float32 (reference: `finetune_squad.py`'s loss).
    Tensors, NDArrays or numpy arrays (`tensor_args`); an NDArray among
    the logits gives an NDArray loss."""
    nd_in = isinstance(start_logits, NDArray) or isinstance(end_logits,
                                                            NDArray)
    start_logits, end_logits, start_positions, end_positions = tensor_args(
        start_logits, end_logits, start_positions, end_positions)

    def one(lg, pos):
        logp = tF.log_softmax(lg.float(), -1)
        return -torch.gather(logp, 1, pos.long()[:, None]).mean()

    loss = (one(start_logits, start_positions)
            + one(end_logits, end_positions)) / 2
    return NDArray(loss) if nd_in else loss


class BERTClassifier(HybridBlock):
    """Sentence (pair) classification over the pooled output (reference:
    GluonNLP's BERTClassifier, `finetune_classifier.py`): dropout, then
    the Dense `classifier`. `device` as `BERTForQuestionAnswering`'s."""

    def __init__(self, cfg, num_classes=2, dropout=0.1, device=None):
        super().__init__()
        self.cfg = cfg
        with context.resolve(device):
            self.bert = BERTModel(**cfg)
            self.dropout = nn.Dropout(dropout) if dropout else None
            self.classifier = nn.Dense(num_classes, in_units=cfg["units"],
                                       dtype=cfg["dtype"],
                                       weight_initializer="xavier")

    def forward(self, inputs, token_types, valid_length=None):
        _, pooled = self.bert(inputs, token_types, valid_length)
        if self.dropout is not None:
            pooled = self.dropout(pooled)
        return self.classifier(pooled)


def bert_pretrain_loss(mlm_scores, nsp_scores, mlm_labels, mlm_weights,
                       nsp_labels):
    """Pretraining loss: the weighted mean MLM cross-entropy over the
    masked positions (weights 1 for real positions) plus the mean NSP
    cross-entropy, in float32. mlm_scores (B,P,V), mlm_labels (B,P),
    mlm_weights (B,P), nsp_labels (B,): tensors, NDArrays (as
    `ShardedTrainer` gives them) or numpy arrays (`tensor_args`)."""
    mlm_scores, nsp_scores, mlm_labels, mlm_weights, nsp_labels = \
        tensor_args(mlm_scores, nsp_scores, mlm_labels, mlm_weights,
                    nsp_labels)
    logp = tF.log_softmax(mlm_scores.float(), -1)
    nll = -torch.gather(logp, -1, mlm_labels.long()[..., None])[..., 0]
    w = mlm_weights.float()
    mlm = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    nlogp = tF.log_softmax(nsp_scores.float(), -1)
    nsp = -torch.gather(nlogp, -1, nsp_labels.long()[:, None]).mean()
    return mlm + nsp


def make_synthetic_batch(cfg, batch_size, seq_len, num_masked=20, seed=0):
    """Deterministic synthetic pretraining batch of numpy arrays (the JAX
    package's generator, draw for draw)."""
    rng = np.random.RandomState(seed)
    V = cfg["vocab_size"]
    return dict(
        input_ids=rng.randint(0, V, (batch_size, seq_len)).astype(np.int32),
        token_types=(rng.rand(batch_size, seq_len) > 0.5).astype(np.int32),
        valid_length=np.full((batch_size,), seq_len, np.int32),
        masked_positions=np.stack(
            [rng.choice(seq_len, num_masked, replace=False)
             for _ in range(batch_size)]).astype(np.int32),
        mlm_labels=rng.randint(0, V, (batch_size, num_masked)).astype(np.int32),
        mlm_weights=np.ones((batch_size, num_masked), np.float32),
        nsp_labels=rng.randint(0, 2, (batch_size,)).astype(np.int32),
    )
