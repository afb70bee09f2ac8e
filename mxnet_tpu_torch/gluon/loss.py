"""Loss blocks (counterpart of `mxnet_tpu/gluon/loss.py`): `Loss`,
`L2Loss`, `L1Loss`, `SoftmaxCrossEntropyLoss` (alias `SoftmaxCELoss`),
`SigmoidBinaryCrossEntropyLoss` (alias `SigmoidBCELoss`), `KLDivLoss`,
`HuberLoss`, `HingeLoss`, `SquaredHingeLoss`, `LogisticLoss`,
`TripletLoss`, `CosineEmbeddingLoss` and `CTCLoss`.

Each returns one loss per sample: the elementwise loss, weighted
(`_apply_weighting`: times `sample_weight` when given, times the block's
`weight` when it is not 1), then averaged over every axis but
`batch_axis` (TripletLoss, CosineEmbeddingLoss and CTCLoss are one value
a sample already). The trainer reduces that to its mean (`call_loss`).
The losses of the training paths (L2, L1, softmax cross-entropy, CTC)
run `forward` on tensors; the others are the JAX package's
`hybrid_forward` over the registry's ops."""
from __future__ import annotations

import torch

from ..ops import misc_ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        """Mean over every axis but the batch axis."""
        batch = self._batch_axis % loss.dim()
        dims = [d for d in range(loss.dim()) if d != batch]
        return loss.mean(dim=dims) if dims else loss


class L2Loss(Loss):
    """weight / 2 · (label - pred)², averaged over the non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._batch_mean(loss)


class L1Loss(Loss):
    """weight · |label - pred|, averaged over the non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """-log_softmax(pred)[label] along `axis` (`sparse_label`: integer
    labels, which may arrive as floats and are clipped into range as the
    JAX package's `pick` clips them), or -Σ label · log_softmax(pred)
    with dense labels; `from_logits` takes pred as log-probabilities."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse_label:
            idx = label.long().clamp(0, pred.shape[self._axis] - 1)
            loss = -torch.gather(pred, self._axis,
                                 idx.unsqueeze(self._axis)) \
                .squeeze(self._axis)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of sigmoid(pred) (the stable log-sum-exp form),
    or of pred itself with `from_sigmoid`; `pos_weight` weighs the
    positive term."""

    def __init__(self, from_sigmoid=False, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(shape=pred.shape)
        if not self._from_sigmoid:
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
            if pos_weight is not None:
                loss = loss + (F.Activation(-F.abs(pred), act_type="softrelu")
                               + F.relu(-pred)) * label * (pos_weight - 1)
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(F.log(pred + eps) * label * pos_weight
                         + F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _weighted(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


def _weighted(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


class KLDivLoss(Loss):
    """label · (log label - pred); pred log-probabilities unless
    `from_logits` is False (then log_softmax is applied)."""

    def __init__(self, from_logits=True, axis=-1, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _weighted(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    """|d| - rho/2 where |d| > rho, else d^2 / (2 rho)."""

    def __init__(self, rho=1.0, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.abs(label.reshape(shape=pred.shape) - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _weighted(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.relu(self._margin - pred * label.reshape(shape=pred.shape))
        loss = _weighted(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        loss = F.square(F.relu(
            self._margin - pred * label.reshape(shape=pred.shape)))
        loss = _weighted(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    """Logistic loss of pred against labels in {-1, 1} ("signed") or
    {0, 1} ("binary")."""

    def __init__(self, weight=1.0, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(shape=pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + \
            F.Activation(-F.abs(pred), act_type="softrelu")
        loss = _weighted(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    """relu(|pred - positive|^2 - |pred - negative|^2 + margin)."""

    def __init__(self, margin=1, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        pos = F.sum(F.square(pred - positive), axis=self._batch_axis,
                    exclude=True)
        neg = F.sum(F.square(pred - negative), axis=self._batch_axis,
                    exclude=True)
        loss = F.relu(pos - neg + self._margin)
        return _weighted(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """1 - cos where label is 1, else relu(cos - margin)."""

    def __init__(self, weight=1.0, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + 1e-12)
        label = label.reshape(shape=cos.shape)
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _weighted(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist Temporal Classification loss (`ops.misc_ops.ctc_loss`,
    blank 0): pred unnormalised activations in `layout` 'NTC' or 'TNC',
    label (classes 1..C-1, 0-padded) in `label_layout` 'NT' or 'TN';
    `pred_lengths` and `label_lengths` are used when given."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC") or label_layout not in ("NT", "TN"):
            raise ValueError(f"CTCLoss layouts {layout!r}, {label_layout!r}")
        self._layout = layout
        super().__init__(weight, label_layout.find("N"))

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = misc_ops.ctc_loss(
            pred, label, pred_lengths, label_lengths,
            use_data_lengths=pred_lengths is not None,
            use_label_lengths=label_lengths is not None, blank_label="first")
        return _apply_weighting(loss, self._weight, sample_weight)
