"""Evaluation metrics (counterpart of `mxnet_tpu/metric.py`, copied;
reference: `python/mxnet/metric.py`).

Updated on host from output NDArrays or tensors (lists of either) — a
sync point, same as the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Registry
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "Perplexity", "Loss", "PearsonCorrelation",
           "CompositeEvalMetric", "CustomMetric", "create", "np_metric",
           "VOC07MApMetric", "BLEU"]

_registry = Registry("metric")
register = _registry.register


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _registry.get(metric)(*args, **kwargs)


def _as_np(x):
    """A host numpy copy of an NDArray or a tensor (bfloat16 comes back
    as float32, which holds it exactly), else np.asarray."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(x)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        name = _as_list(name)
        value = _as_list(value)
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register("acc")
@register("accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _as_np(pred)
            label = _as_np(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(self.axis)
            pred = pred.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register("top_k_accuracy")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _as_np(pred)
            label = _as_np(label).astype("int32").reshape(-1)
            topk = np.argsort(-pred, axis=-1)[:, :self.top_k]
            self.sum_metric += (topk == label[:, None]).any(-1).sum()
            self.num_inst += len(label)


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self.tp = self.fp = self.fn = 0

    def reset(self):
        super().reset()
        if hasattr(self, "tp"):
            self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _as_np(pred)
            label = _as_np(label).reshape(-1).astype("int32")
            if pred.ndim > 1:
                pred = pred.argmax(-1)
            pred = pred.reshape(-1).astype("int32")
            self.tp += ((pred == 1) & (label == 1)).sum()
            self.fp += ((pred == 1) & (label == 0)).sum()
            self.fn += ((pred == 0) & (label == 1)).sum()
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        rec = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += np.abs(label.reshape(pred.shape) - pred).mean() * len(pred)
            self.num_inst += len(pred)


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += ((label.reshape(pred.shape) - pred) ** 2).mean() * len(pred)
            self.num_inst += len(pred)


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.sqrt(self.sum_metric / self.num_inst))


@register("ce")
@register("cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_np(label).ravel().astype("int64")
            pred = _as_np(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += (-np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register("perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _as_np(label).ravel().astype("int64")
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            prob = pred[np.arange(label.shape[0]), label]
            logp = -np.log(prob + self.eps)
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                logp = logp[keep]
            self.sum_metric += logp.sum()
            self.num_inst += logp.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _as_np(pred)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels, self._preds = [], []

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_as_np(label).ravel())
            self._preds.append(_as_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        l = np.concatenate(self._labels)
        p = np.concatenate(self._preds)
        return self.name, float(np.corrcoef(l, p)[0, 1])


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names += _as_list(n)
            values += _as_list(v)
        return names, values


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            val = self._feval(_as_np(label), _as_np(pred))
            if isinstance(val, tuple):
                s, n = val
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += val
                self.num_inst += 1


def np_metric(numpy_feval, name="custom", allow_extra_outputs=False):
    return CustomMetric(numpy_feval, name, allow_extra_outputs)


@register("voc_map")
@register("voc07map")
class VOC07MApMetric(EvalMetric):
    """Pascal VOC 2007 11-point interpolated mean average precision
    (reference: GluonCV `utils/metrics/voc_detection.py` VOC07MApMetric).

    update(labels, preds):
      preds:  (B, N, 6) rows [class_id, score, x1, y1, x2, y2]; rows with
              score < 0 are ignored (box_nms suppression marker).
      labels: (B, G, 5) rows [class_id, x1, y1, x2, y2]; class_id < 0 pads.
    """

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP"):
        self.iou_thresh = iou_thresh
        self.class_names = class_names
        super().__init__(name)

    def reset(self):
        super().reset()
        self._records = {}          # cid -> list of (score, is_tp)
        self._npos = {}             # cid -> gt count

    @staticmethod
    def _iou(box, gts):
        ix = np.maximum(0, np.minimum(box[2], gts[:, 2]) -
                         np.maximum(box[0], gts[:, 0]))
        iy = np.maximum(0, np.minimum(box[3], gts[:, 3]) -
                         np.maximum(box[1], gts[:, 1]))
        inter = ix * iy
        a = max(0.0, (box[2] - box[0])) * max(0.0, (box[3] - box[1]))
        b = np.maximum(0, gts[:, 2] - gts[:, 0]) * \
            np.maximum(0, gts[:, 3] - gts[:, 1])
        return inter / np.maximum(a + b - inter, 1e-12)

    def update(self, labels, preds):
        # list-of-NDArrays convention (Module.update_metric): consume pairs
        if isinstance(labels, (list, tuple)) or isinstance(preds, (list, tuple)):
            for lab, prd in zip(_as_list(labels), _as_list(preds)):
                self.update(lab, prd)
            return
        labels = _as_np(labels)
        preds = _as_np(preds)
        for b in range(len(preds)):
            gt = labels[b]
            gt = gt[gt[:, 0] >= 0]
            for cid in set(gt[:, 0].astype(int)):
                self._npos[cid] = self._npos.get(cid, 0) + \
                    int((gt[:, 0].astype(int) == cid).sum())
            det = preds[b]
            det = det[det[:, 1] >= 0]
            det = det[np.argsort(-det[:, 1])]
            used = np.zeros(len(gt), bool)
            for row in det:
                cid = int(row[0])
                cls_mask = gt[:, 0].astype(int) == cid
                tp = False
                if cls_mask.any():
                    ious = self._iou(row[2:6], gt[cls_mask, 1:5])
                    j = int(np.argmax(ious))
                    gidx = np.nonzero(cls_mask)[0][j]
                    if ious[j] >= self.iou_thresh and not used[gidx]:
                        used[gidx] = True
                        tp = True
                self._records.setdefault(cid, []).append((float(row[1]), tp))
        self.num_inst = 1           # get() reports the computed mAP directly

    def get(self):
        aps = []
        for cid, npos in self._npos.items():
            recs = sorted(self._records.get(cid, []), key=lambda r: -r[0])
            tps = np.asarray([tp for _, tp in recs], bool)
            if len(tps) == 0:
                aps.append(0.0)
                continue
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(~tps)
            recall = tp_cum / max(npos, 1)
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
            # VOC07 11-point interpolation
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if (recall >= t).any() else 0.0
                ap += p / 11.0
            aps.append(float(ap))
        if not aps:
            return self.name, float("nan")
        return self.name, float(np.mean(aps))


@register("bleu")
class BLEU(EvalMetric):
    """Corpus BLEU-N with brevity penalty (reference behavior:
    gluon-nlp scripts/nmt/bleu.py `compute_bleu`, the NMT quality metric).

    `update(labels, preds)`: one reference and one hypothesis per sentence,
    each a 1-D sequence of token ids (or a list of them). Counts accumulate
    across updates; `get()` returns the CORPUS score (not an average of
    sentence scores). `smooth` adds +1 smoothing (Lin & Och) to orders with
    zero matches — without it any zero n-gram count makes the score 0."""

    def __init__(self, max_n=4, smooth=False, name="bleu", **kwargs):
        self.max_n = int(max_n)
        self.smooth = smooth
        super().__init__(name, **kwargs)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._match = [0] * getattr(self, "max_n", 4)
        self._total = [0] * getattr(self, "max_n", 4)
        self._hyp_len = 0
        self._ref_len = 0

    @staticmethod
    def _ngrams(seq, n):
        counts = {}
        for i in range(len(seq) - n + 1):
            g = tuple(seq[i:i + n])
            counts[g] = counts.get(g, 0) + 1
        return counts

    def update(self, labels, preds):
        for ref, hyp in zip(_as_list(labels), _as_list(preds)):
            ref = [int(t) for t in _as_np(ref).reshape(-1)]
            hyp = [int(t) for t in _as_np(hyp).reshape(-1)]
            self._hyp_len += len(hyp)
            self._ref_len += len(ref)
            for n in range(1, self.max_n + 1):
                h = self._ngrams(hyp, n)
                r = self._ngrams(ref, n)
                self._match[n - 1] += sum(min(c, r.get(g, 0))
                                          for g, c in h.items())
                self._total[n - 1] += max(len(hyp) - n + 1, 0)
            self.num_inst += 1

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        import math
        log_p = 0.0
        for m, t in zip(self._match, self._total):
            if self.smooth:
                m, t = m + 1, t + 1
            if m == 0 or t == 0:
                return self.name, 0.0
            log_p += math.log(m / t) / self.max_n
        bp = 1.0 if self._hyp_len >= self._ref_len else math.exp(
            1.0 - self._ref_len / max(self._hyp_len, 1))
        return self.name, bp * math.exp(log_p)
