"""YOLOv3-tiny (counterpart of `mxnet_tpu/models/yolo.py`; reference:
GluonCV `gluoncv/model_zoo/yolo/yolo3.py` and the detection ops).

`YOLOv3Tiny` has the JAX package's layers and parameter paths
(`body.0.0.weight`, `head13.1.bias`, ...), so weights carry across by
name. `yolo_targets`, `yolo_loss` and `decode_predictions` take NDArrays
(or tensors) and give NDArrays (tensors), as the JAX package's do; their
interior runs on tensors:
  * gt boxes arrive padded to a fixed count (label -1 rows are padding);
    target assignment is one scatter over the whole batch, no loop per
    image. Where two gts land on one (cell, anchor) the later gt's
    targets win, as XLA:CPU's scatter applies the JAX `.set` updates in
    order (tests/test_torch_yolo.py makes them collide);
  * the loss computes in float32 whatever the heads' dtype;
  * decode ends in `ops.detection_ops.box_nms`, whose greedy loop is the
    hand-written kernel of `cuda_ops/box_nms.py`.

Anchors follow the upstream yolov3-tiny config scaled by `image_size/416`.
`device=None` builds the model on the card (raising when there is none);
`device="cpu"` builds it on the CPU. The convolutions and BatchNorms take
their input channels at the first forward, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import context
from ..gluon import HybridBlock, nn
from ..ndarray.ndarray import NDArray, _unwrap, tensor_args
from ..ops import detection_ops

__all__ = ["YOLOv3Tiny", "yolo_targets", "yolo_loss", "decode_predictions",
           "decode_rows"]


def _conv_bn_leaky(channels, kernel=3, stride=1, pad=None):
    pad = (kernel - 1) // 2 if pad is None else pad
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels, kernel, stride, pad, use_bias=False),
            nn.BatchNorm(), nn.LeakyReLU(0.1))
    return blk


class YOLOv3Tiny(HybridBlock):
    """Two-scale tiny YOLOv3. forward -> list of (B, H, W, A, 5+C) raw
    heads, coarse scale first (strides image_size/8 apart by factor 2)."""

    def __init__(self, num_classes=20, image_size=416, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size
        s = image_size / 416.0
        self.anchors = [
            np.asarray([[81, 82], [135, 169], [344, 319]], np.float32) * s,
            np.asarray([[10, 14], [23, 27], [37, 58]], np.float32) * s,
        ]
        self.strides = [image_size // 13 if image_size % 13 == 0 else 32,
                        image_size // 26 if image_size % 26 == 0 else 16]
        self.na = 3
        self._anchor_cache = {}
        c = num_classes + 5
        with context.resolve(device):
            self.body = nn.HybridSequential()      # -> stride 16 feature
            for ch in (16, 32, 64, 128, 256):
                self.body.add(_conv_bn_leaky(ch))
                if ch != 256:
                    self.body.add(nn.MaxPool2D(2, 2))
            self.pool5 = nn.MaxPool2D(2, 2)        # -> stride 32
            self.conv6 = _conv_bn_leaky(512)
            self.conv7 = _conv_bn_leaky(256, kernel=1, pad=0)
            self.head13 = nn.HybridSequential()
            self.head13.add(_conv_bn_leaky(512), nn.Conv2D(self.na * c, 1))
            self.up_conv = _conv_bn_leaky(128, kernel=1, pad=0)
            self.head26 = nn.HybridSequential()
            self.head26.add(_conv_bn_leaky(256), nn.Conv2D(self.na * c, 1))

    def anchor_tensor(self, device):
        """`anchors` of both scales as one (2 * na, 2) float32 tensor on
        `device`, made once a device: a copy from host memory at every
        call would wait for the card's queue to drain."""
        dev = torch.device(device)
        t = self._anchor_cache.get(dev)
        if t is None:
            t = self._anchor_cache[dev] = torch.from_numpy(
                np.concatenate(self.anchors, 0)).to(dev)
        return t

    def forward(self, x):
        c = self.num_classes + 5
        f16 = self.body(x)                     # (B, 256, H/16, W/16)
        f32 = self.conv7(self.conv6(self.pool5(f16)))
        p13 = self.head13(f32)
        up = self.up_conv(f32)
        up = up.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        p26 = self.head26(torch.cat([up, f16], dim=1))
        outs = []
        for p in (p13, p26):
            B, _, H, W = p.shape
            outs.append(p.reshape(B, self.na, c, H, W)
                        .permute(0, 3, 4, 1, 2))  # (B,H,W,A,5+C)
        return outs


def yolo_targets(model, gt_boxes, gt_labels):
    """Static-shape target assignment. gt_boxes (B, G, 4) corner format in
    image coords, gt_labels (B, G) with -1 padding. Each gt is assigned to
    its best-IoU anchor (by wh overlap, upstream rule) at the cell holding
    the box center. Returns per scale: dict of obj (B,H,W,A),
    xy (B,H,W,A,2) in-cell offsets, wh (B,H,W,A,2) log-scales,
    cls (B,H,W,A) int32; NDArrays when the boxes are one. Numpy boxes
    and labels go to the model's device (`tensor_args`)."""
    nd_in = isinstance(gt_boxes, NDArray)
    boxes, labels = tensor_args(gt_boxes, gt_labels,
                                device=next(model.parameters()).device)
    boxes, labels = boxes.float(), labels.to(torch.int32)
    dev = boxes.device
    B, G, _ = boxes.shape
    sizes = [model.image_size // s for s in model.strides]
    all_anchors = model.anchor_tensor(dev)
    valid = labels >= 0
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-3)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-3)
    # wh IoU against every anchor (both centered at origin)
    aw, ah = all_anchors[:, 0], all_anchors[:, 1]
    inter = torch.minimum(w[..., None], aw) * torch.minimum(h[..., None], ah)
    union = w[..., None] * h[..., None] + aw * ah - inter
    best = torch.argmax(inter / union, dim=-1)            # (B, G)
    scale_of = best // model.na
    anchor_of = best % model.na
    # the scatter's winner among gts on one slot: the last (highest
    # index), by an amax of the gt's number
    gt_no = torch.arange(B * G, device=dev).reshape(B, G)
    img = torch.arange(B, device=dev)[:, None]

    out = []
    for si, S in enumerate(sizes):
        stride = model.strides[si]
        gx = torch.clamp((cx / stride).to(torch.int32), 0, S - 1)
        gy = torch.clamp((cy / stride).to(torch.int32), 0, S - 1)
        on = valid & (scale_of == si)
        anc = all_anchors[si * model.na:(si + 1) * model.na]
        offx = cx / stride - gx
        offy = cy / stride - gy
        lw = torch.log(torch.clamp(w / anc[anchor_of, 0], min=1e-6))
        lh = torch.log(torch.clamp(h / anc[anchor_of, 1], min=1e-6))
        n_slots = B * S * S * model.na
        # gts not on this scale go to the spare slot n_slots (the JAX
        # scatter's mode="drop"), cut off below
        slot = ((img * S + gy) * S + gx) * model.na + anchor_of
        slot = torch.where(on, slot, n_slots)
        win = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, slot.reshape(-1), gt_no.reshape(-1), "amax")
        win = win[:n_slots]
        hit = win >= 0
        src = torch.clamp(win, min=0)
        shape = (B, S, S, model.na)
        xy = torch.stack([offx, offy], -1).reshape(-1, 2)[src]
        wh = torch.stack([lw, lh], -1).reshape(-1, 2)[src]
        out.append({
            "obj": hit.float().reshape(shape),
            "xy": torch.where(hit[:, None], xy, 0.0).reshape(shape + (2,)),
            "wh": torch.where(hit[:, None], wh, 0.0).reshape(shape + (2,)),
            "cls": torch.where(hit, labels.reshape(-1)[src], 0)
            .reshape(shape)})
    if nd_in:
        out = [{k: NDArray(v) for k, v in t.items()} for t in out]
    return out


def _bce(logit, target):
    return torch.maximum(logit, torch.zeros_like(logit)) - logit * target \
        + torch.log1p(torch.exp(-torch.abs(logit)))


def yolo_loss(preds, targets, num_classes):
    """GluonCV YOLOV3Loss shape: sigmoid-BCE for center + objectness +
    class, L2 for log-scale wh, all masked to assigned anchors; float32
    whatever the heads' dtype. NDArray heads give an NDArray loss."""
    nd_in = isinstance(preds[0], NDArray)
    total = None
    for p, t in zip(preds, targets):
        p = _unwrap(p).float()
        tobj, txy, twh, tcls = (_unwrap(t[k]) for k in ("obj", "xy", "wh", "cls"))
        obj_loss = _bce(p[..., 4], tobj).mean()
        mask = tobj[..., None]
        denom = torch.clamp(tobj.sum(), min=1.0)
        xy_loss = (_bce(p[..., 0:2], txy) * mask).sum() / denom
        wh_loss = (torch.square(p[..., 2:4] - twh) * mask).sum() / denom
        cls_1h = (tcls[..., None] == torch.arange(num_classes,
                                                  device=p.device)).float()
        cls_loss = (_bce(p[..., 5:], cls_1h) * mask).sum() / denom
        part = obj_loss + xy_loss + 0.5 * wh_loss + cls_loss
        total = part if total is None else total + part
    return NDArray(total) if nd_in else total


def decode_rows(model, preds):
    """Raw heads -> (B, N, 6) float32 rows [class_id, score, x1, y1, x2,
    y2] before NMS (tensors), the first half of `decode_predictions`."""
    parts = []
    for si, (p, stride) in enumerate(zip(preds, model.strides)):
        p = _unwrap(p).float()
        B, H, W, A, _ = p.shape
        dev = p.device
        anchors = model.anchor_tensor(dev)[si * A:(si + 1) * A]
        gx = torch.arange(W, device=dev)[None, None, :, None]
        gy = torch.arange(H, device=dev)[None, :, None, None]
        cx = (torch.sigmoid(p[..., 0]) + gx) * stride
        cy = (torch.sigmoid(p[..., 1]) + gy) * stride
        pw = torch.exp(torch.clamp(p[..., 2], -8, 8)) * anchors[:, 0]
        ph = torch.exp(torch.clamp(p[..., 3], -8, 8)) * anchors[:, 1]
        obj = torch.sigmoid(p[..., 4])
        cls = torch.sigmoid(p[..., 5:])
        score = obj[..., None] * cls                       # (B,H,W,A,C)
        cid = torch.argmax(score, -1).float()
        sc = score.amax(-1)
        boxes = torch.stack([cx - pw / 2, cy - ph / 2,
                             cx + pw / 2, cy + ph / 2], -1)
        rows = torch.cat([cid[..., None], sc[..., None], boxes], -1)
        parts.append(rows.reshape(B, -1, 6))
    return torch.cat(parts, dim=1)


def decode_predictions(model, preds, conf_thresh=0.1, nms_thresh=0.45,
                       topk=100):
    """Raw heads -> (B, N, 6) rows [class_id, score, x1, y1, x2, y2] after
    per-class NMS (static shape; suppressed rows have score -1)."""
    out = detection_ops.box_nms(
        decode_rows(model, preds), overlap_thresh=nms_thresh,
        valid_thresh=conf_thresh, topk=topk, coord_start=2, score_index=1,
        id_index=0)
    return NDArray(out) if isinstance(preds[0], NDArray) else out
