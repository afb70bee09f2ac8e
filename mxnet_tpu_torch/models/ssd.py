"""SSD detection (counterpart of `mxnet_tpu/models/ssd.py`; reference:
GluonCV SSD with the MultiBoxTarget/NMS ops of `src/operator/contrib/`).

`SSD` has the JAX package's layers and parameter paths (`stem.0.weight`,
`stages.2.4.gamma`, `cls_heads.3.bias`, ...), so weights carry across by
name; its forward gives (cls_preds (B, N, C+1), box_preds (B, N, 4),
feat_sizes). `generate_anchors` is the JAX package's host-side numpy.
`multibox_target`, `non_max_suppression` and `MultiBoxLoss` take tensors
or NDArrays (NDArray in, NDArray out; `multibox_target`'s anchors as a
tensor or an NDArray) and run on tensors, vectorised
over the batch:
  * matching keeps the JAX code's one scatter with duplicates (`forced`
    of a padding row lands on anchor 0): the later gt's value wins, as
    XLA:CPU applies the updates in order;
  * hard-negative mining ranks by a double stable argsort, as
    `jnp.argsort` does;
  * `non_max_suppression` runs the greedy loop on the hand-written kernel
    of `cuda_ops/box_nms.py`, where only the first topk sorted rows may
    suppress and IoU is SSD's `_iou` (areas not clamped at 0).

`device=None` builds the model on the card (raising when there is none);
`device="cpu"` builds it on the CPU.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .. import context
from ..cuda_ops.box_nms import box_nms_keep, pair_iou
from ..gluon import HybridBlock, nn
from ..ndarray.ndarray import NDArray, _unwrap, tensor_args

__all__ = ["SSD", "generate_anchors", "multibox_target", "non_max_suppression",
           "MultiBoxLoss"]


def generate_anchors(feat_sizes, image_size=300,
                     sizes=((0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
                            (0.54, 0.619), (0.71, 0.79), (0.88, 0.961)),
                     ratios=((1, 2, 0.5),) * 6):
    """Returns (N, 4) center-size anchors in [0,1] coords (numpy)."""
    anchors = []
    for (fh, fw), size, ratio in zip(feat_sizes, sizes, ratios):
        for i, j in itertools.product(range(fh), range(fw)):
            cy, cx = (i + 0.5) / fh, (j + 0.5) / fw
            s0, s1 = size[0], size[1]
            anchors.append([cx, cy, s0, s0])
            anchors.append([cx, cy, math.sqrt(s0 * s1), math.sqrt(s0 * s1)])
            for r in ratio:
                if r == 1:
                    continue
                sr = math.sqrt(r)
                anchors.append([cx, cy, s0 * sr, s0 / sr])
    return np.asarray(anchors, np.float32)


def _corner(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def multibox_target(anchors, gt_boxes, gt_labels, iou_thresh=0.5):
    """Match anchors to ground truth (reference: MultiBoxTarget).

    anchors (N,4) center-size; gt_boxes (B,M,4) corner, padded with -1;
    gt_labels (B,M) padded with -1: tensors, NDArrays or numpy arrays
    (`tensor_args`). Returns cls_targets (B,N) [0=bg], box_targets
    (B,N,4), box_mask (B,N,1)."""
    nd_in = isinstance(gt_boxes, NDArray)
    gtb, gtl, anchors = tensor_args(gt_boxes, gt_labels, anchors)
    anchors_c = _corner(anchors)
    N = anchors.shape[0]
    B, M = gtl.shape
    dev = gtb.device
    valid = gtl >= 0
    iou = pair_iou(anchors_c, gtb, clamp_area=False)   # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, 0.0)
    best_gt = torch.argmax(iou, dim=2)                 # (B, N)
    best_iou = iou.amax(dim=2)
    matched = best_iou >= iou_thresh
    # force-match: each gt's best anchor. A padding row's column is all 0,
    # so its best anchor is 0 and it writes False there; on a slot that
    # several rows write, the last row's value wins (the JAX scatter's
    # order on XLA:CPU)
    best_anchor = torch.argmax(iou, dim=1)             # (B, M)
    rows = torch.arange(M, device=dev).expand(B, M)
    last = torch.full((B, N), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce(1, best_anchor, rows, "amax")
    forced = torch.gather(valid, 1, last.clamp(min=0)) & (last >= 0)
    matched = matched | forced
    gt_for_anchor = torch.gather(gtb, 1, best_gt[..., None].expand(-1, -1,
                                                                   4))
    lbl = torch.where(matched, torch.gather(gtl, 1, best_gt) + 1,
                      0)                               # 0 = background
    # encode (reference MultiBoxTarget variances 0.1/0.2)
    gw = gt_for_anchor[..., 2] - gt_for_anchor[..., 0]
    gh = gt_for_anchor[..., 3] - gt_for_anchor[..., 1]
    gx = (gt_for_anchor[..., 0] + gt_for_anchor[..., 2]) / 2
    gy = (gt_for_anchor[..., 1] + gt_for_anchor[..., 3]) / 2
    tx = (gx - anchors[:, 0]) / anchors[:, 2] / 0.1
    ty = (gy - anchors[:, 1]) / anchors[:, 3] / 0.1
    tw = torch.log(torch.clamp(gw, min=1e-6) / anchors[:, 2]) / 0.2
    th = torch.log(torch.clamp(gh, min=1e-6) / anchors[:, 3]) / 0.2
    box_t = torch.stack([tx, ty, tw, th], -1) * matched[..., None]
    out = (lbl, box_t, matched[..., None].float())
    return tuple(NDArray(o) for o in out) if nd_in else out


def non_max_suppression(boxes, scores, iou_thresh=0.45, topk=100):
    """Greedy NMS in which only the first topk score-sorted rows may
    suppress, static shapes: boxes (N,4) corner, scores (N,) (tensors,
    NDArrays or numpy arrays, `tensor_args`). Returns
    (topk indices, topk scores); suppressed entries get score -1."""
    nd_in = isinstance(boxes, NDArray)
    boxes, scores = (t.float() for t in tensor_args(boxes, scores))
    N = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    s = scores[order]
    keep = box_nms_keep(b[None].contiguous(),
                        torch.ones((1, N), dtype=torch.bool,
                                   device=b.device),
                        None, iou_thresh, n_suppressors=min(N, topk),
                        clamp_area=False)[0]
    s = torch.where(keep, s, -1.0)
    k = min(topk, N)
    # lax.top_k: descending, the lower index first among ties
    top_i = torch.argsort(-s, stable=True)[:k]
    # int32 indices, as `lax.top_k` gives them
    out = (order[top_i].to(torch.int32), s[top_i])
    return tuple(NDArray(o) for o in out) if nd_in else out


class SSD(HybridBlock):
    """SSD with a ResNet-ish backbone and multi-scale heads."""

    def __init__(self, num_classes=20, num_anchors_per_pos=4,
                 channels=(64, 128, 256, 512), device=None):
        super().__init__()
        self.num_classes = num_classes
        self._na = num_anchors_per_pos
        with context.resolve(device):
            self.stem = nn.HybridSequential()
            self.stem.add(nn.Conv2D(channels[0], 3, 2, 1, activation="relu"),
                          nn.BatchNorm())
            self.stages = nn.HybridSequential()
            self.cls_heads = nn.HybridSequential()
            self.box_heads = nn.HybridSequential()
            for c in channels:
                stage = nn.HybridSequential()
                stage.add(nn.Conv2D(c, 3, 2, 1, use_bias=False),
                          nn.BatchNorm(), nn.Activation("relu"),
                          nn.Conv2D(c, 3, 1, 1, use_bias=False),
                          nn.BatchNorm(), nn.Activation("relu"))
                self.stages.add(stage)
                self.cls_heads.add(
                    nn.Conv2D(self._na * (num_classes + 1), 3, 1, 1))
                self.box_heads.add(nn.Conv2D(self._na * 4, 3, 1, 1))

    def forward(self, x):
        """Returns (cls_preds (B,N,C+1), box_preds (B,N,4), feat_sizes)."""
        x = self.stem(x)
        cls_out, box_out, feat_sizes = [], [], []
        for stage, ch, bh in zip(self.stages, self.cls_heads,
                                 self.box_heads):
            x = stage(x)
            feat_sizes.append(tuple(x.shape[2:]))
            B = x.shape[0]
            cls_out.append(ch(x).permute(0, 2, 3, 1)
                           .reshape(B, -1, self.num_classes + 1))
            box_out.append(bh(x).permute(0, 2, 3, 1).reshape(B, -1, 4))
        return torch.cat(cls_out, 1), torch.cat(box_out, 1), feat_sizes


class MultiBoxLoss:
    """SSD loss: softmax CE (with hard negative mining 3:1) + smooth-L1,
    in float32. NDArray predictions give an NDArray loss."""

    def __init__(self, neg_ratio=3.0):
        self.neg_ratio = neg_ratio

    def __call__(self, cls_preds, box_preds, cls_targets, box_targets,
                 box_mask):
        nd_in = isinstance(cls_preds, NDArray)
        cp, bp, ct, bt, bm = (_unwrap(x) for x in (cls_preds, box_preds,
                                                   cls_targets, box_targets,
                                                   box_mask))
        logp = torch.log_softmax(cp.float(), -1)
        ct = ct.long()
        nll = -torch.gather(logp, -1, ct[..., None])[..., 0]     # (B,N)
        pos = ct > 0
        n_pos = torch.clamp(pos.sum(1), min=1)
        # hard negative mining: top (neg_ratio * n_pos) negatives by loss
        neg_loss = torch.where(pos, float("-inf"), nll)
        rank = torch.argsort(torch.argsort(-neg_loss, dim=1, stable=True),
                             dim=1, stable=True)
        neg = rank < (self.neg_ratio * n_pos)[:, None]
        cls_loss = torch.sum(nll * (pos | neg), 1) / n_pos
        diff = torch.abs(bp.float() - bt.float()) * bm
        sl1 = torch.where(diff < 1, 0.5 * diff * diff, diff - 0.5)
        box_loss = torch.sum(sl1, (1, 2)) / n_pos
        loss = torch.mean(cls_loss + box_loss)
        return NDArray(loss) if nd_in else loss
