"""Loss blocks (counterpart of `mxnet_tpu/gluon/loss.py`): `Loss`,
`L2Loss`, `L1Loss`, `SoftmaxCrossEntropyLoss` (alias `SoftmaxCELoss`)
and `CTCLoss`.

Each returns one loss per sample: the elementwise loss, weighted
(`_apply_weighting`: times `sample_weight` when given, times the block's
`weight` when it is not 1), then averaged over every axis but
`batch_axis`. The trainer reduces that to its mean (`call_loss`)."""
from __future__ import annotations

import torch

from ..ops import misc_ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis):
        super().__init__()
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
