"""Detection operators (counterpart of `mxnet_tpu/ops/detection_ops.py`):
`box_iou`, `box_nms`, `roi_align`, the SSD MultiBox family
(`multibox_prior`, `multibox_target`, `multibox_detection`),
`roi_pooling`, `adaptive_avg_pooling` and `proposal`, as plain torch
functions on tensors with the JAX package's static shapes and numerics.

NMS marks suppressed rows with score -1 in place of compaction, so no
output shape depends on the data. Its greedy loop is the one kernel here
(`cuda_ops.box_nms.box_nms_keep`, one thread block an image, which stops
at an image's topk-th survivor); the stable sort, the valid mask, top-k
and the score rewrite are torch.

Where the JAX code's numerics are a choice, the port keeps them: sorts
are stable (`jnp.argsort`, `lax.top_k`: the lower index first among
ties), argmax takes the first maximum, a scatter with `mode="drop"`
sends the rows it drops to a spare slot that is cut off afterwards
(never clamped onto a real row), `.at[...].max` is
`scatter_reduce("amax")`, and divisions keep their `max(..., 1e-12)`
guards in the same order of operations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cuda_ops.box_nms import box_nms_keep, pair_iou

__all__ = ["box_iou", "box_nms", "roi_align", "multibox_prior",
           "multibox_target", "multibox_detection", "roi_pooling",
           "adaptive_avg_pooling", "proposal"]


def _to_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU (reference `_contrib_box_iou`)."""
    return pair_iou(_to_corner(lhs.float(), format),
                    _to_corner(rhs.float(), format))


def _sort_desc(key):
    """`jnp.argsort(-key)` along the last axis: stable, so ties keep
    their index order."""
    return torch.argsort(-key, dim=-1, stable=True)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """Non-maximum suppression (reference `_contrib_box_nms`).

    data: (..., N, K) rows [.., score at score_index, coords at
    coord_start:coord_start+4, optional class id at id_index]. Suppressed /
    invalid rows keep their coords but get score -1 (reference semantics);
    rows are returned sorted by descending score. topk limits how many
    survivors keep a score."""
    d = data.float()
    batch_shape = d.shape[:-2]
    N, K = d.shape[-2:]
    d2 = d.reshape(-1, N, K)
    scores = d2[..., score_index]
    valid = scores > valid_thresh
    order = _sort_desc(torch.where(valid, scores, float("-inf")))
    rows = torch.gather(d2, 1, order[..., None].expand(-1, -1, K))
    scores = rows[..., score_index]
    valid = scores > valid_thresh
    boxes = _to_corner(rows[..., coord_start:coord_start + 4], in_format)
    ids = None
    if id_index >= 0 and not force_suppress:
        ids = rows[..., id_index].contiguous()
    # topk: the first topk survivors keep their score (the kernel stops at
    # an image's topk-th)
    keep = box_nms_keep(boxes.contiguous(), valid, ids, overlap_thresh,
                        max_keep=topk if topk is not None and topk > 0
                        else None)
    out = rows.clone()
    out[..., score_index] = torch.where(keep, scores, -1.0)
    return out.reshape(batch_shape + (N, K)).to(data.dtype)


def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False):
    """ROIAlign (reference `_contrib_ROIAlign`, Mask R-CNN style: NO pixel
    shift, bilinear-sampled grid points averaged per output bin).

    data: (B, C, H, W); rois: (R, 5) [batch_idx, x1, y1, x2, y2] in image
    coords. Returns (R, C, PH, PW). A negative batch_idx yields zeros
    (the reference uses that for padded rois)."""
    if position_sensitive:
        raise NotImplementedError("position_sensitive ROIAlign")
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    PH, PW = pooled_size
    B, C, H, W = data.shape
    x = data.float()
    r = rois.float()
    R = r.shape[0]
    S = int(sample_ratio) if sample_ratio and sample_ratio > 0 else 2
    dev = x.device
    bidx = r[:, 0].to(torch.int32)
    x1, y1, x2, y2 = (r[:, k] * spatial_scale for k in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w, bin_h = rw / PW, rh / PH
    # S x S sample points per bin, bilinear each, then averaged
    sy = y1[:, None] + (torch.arange(PH * S, device=dev) + 0.5) \
        * (bin_h / S)[:, None]                               # (R, PH*S)
    sx = x1[:, None] + (torch.arange(PW * S, device=dev) + 0.5) \
        * (bin_w / S)[:, None]                               # (R, PW*S)
    sy = torch.clamp(sy, 0.0, H - 1.0)
    sx = torch.clamp(sx, 0.0, W - 1.0)
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    y1i = torch.clamp(y0 + 1, max=H - 1)
    x1i = torch.clamp(x0 + 1, max=W - 1)
    wy = (sy - y0)[:, :, None, None]                         # (R, PH*S, 1, 1)
    wx = (sx - x0)[:, None, :, None]                         # (R, 1, PW*S, 1)
    img = x[torch.clamp(bidx, min=0).long()]                 # (R, C, H, W)
    ri = torch.arange(R, device=dev)[:, None, None]

    def corner(yy, xx):                            # (R, PH*S, PW*S, C)
        return img[ri, :, yy[:, :, None], xx[:, None, :]]

    val = (corner(y0, x0) * (1 - wy) * (1 - wx)
           + corner(y0, x1i) * (1 - wy) * wx
           + corner(y1i, x0) * wy * (1 - wx)
           + corner(y1i, x1i) * wy * wx)
    pooled = val.permute(0, 3, 1, 2).reshape(R, C, PH, S, PW, S) \
        .mean(dim=(3, 5))
    pooled = torch.where((bidx >= 0)[:, None, None, None], pooled, 0.0)
    return pooled.to(data.dtype)


# ---------------------------------------------------------------------------
# SSD MultiBox family (reference src/operator/contrib/multibox_prior.cc,
# multibox_target.cc, multibox_detection.cc)
# ---------------------------------------------------------------------------

def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor generation. `data` supplies the feature-map shape (B,C,H,W);
    anchors are normalized corner boxes, (1, H*W*A, 4) with
    A = len(sizes) + len(ratios) - 1: (size_i, ratio_0) for all sizes plus
    (size_0, ratio_j) for j>0 — the reference's combination rule."""
    _, _, H, W = data.shape
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    wh = [(s * float(np.sqrt(ratios[0])), s / float(np.sqrt(ratios[0])))
          for s in sizes]
    wh += [(sizes[0] * float(np.sqrt(r)), sizes[0] / float(np.sqrt(r)))
           for r in ratios[1:]]
    wh = torch.tensor(wh, dtype=torch.float32, device=dev)   # (A, 2)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")           # (H, W)
    centers = torch.stack([gx, gy], -1).reshape(-1, 1, 2)    # (HW, 1, 2)
    half = wh[None, :, :] / 2.0                              # (1, A, 2)
    boxes = torch.cat([centers - half, centers + half], -1)
    boxes = boxes.reshape(1, -1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes


def _encode_offsets(anchors, matched, variances):
    """(cx,cy,w,h) offset encoding of matched gt boxes vs anchors, both
    corner-format (..., 4)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = torch.clamp(matched[..., 2] - matched[..., 0], min=1e-12)
    gh = torch.clamp(matched[..., 3] - matched[..., 1], min=1e-12)
    gcx = (matched[..., 0] + matched[..., 2]) / 2
    gcy = (matched[..., 1] + matched[..., 3]) / 2
    v0, v1, v2, v3 = variances
    return torch.stack([(gcx - acx) / torch.clamp(aw, min=1e-12) / v0,
                        (gcy - acy) / torch.clamp(ah, min=1e-12) / v1,
                        torch.log(gw / torch.clamp(aw, min=1e-12)) / v2,
                        torch.log(gh / torch.clamp(ah, min=1e-12)) / v3], -1)


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor↔gt matching + offset encoding. anchor (1,A,4) corner;
    label (B,M,5) rows [cls, x1, y1, x2, y2] with cls<0 padding;
    cls_pred (B, num_cls+1, A) used only for hard-negative mining.
    Returns (box_target (B,A*4), box_mask (B,A*4), cls_target (B,A));
    cls_target is matched-class+1 with 0 = background, ignore_label for
    mined-away negatives. Vectorised over the batch."""
    anc = anchor.reshape(-1, 4).float()                      # (A, 4)
    A = anc.shape[0]
    lab = label.float()
    cpred = cls_pred.float()
    B, M, _ = lab.shape
    dev = anc.device
    gt_valid = lab[..., 0] >= 0                              # (B, M)
    gt_boxes = lab[..., 1:5]
    iou = pair_iou(anc, gt_boxes)                            # (B, A, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    # stage 1: each valid gt claims its best anchor (bipartite). Padding
    # rows go to the spare slot A, cut off below (the JAX scatter's
    # mode="drop"); duplicate claims on one anchor take the highest gt
    # index (`.at[].max`).
    best_anchor = torch.argmax(iou, dim=1)                   # (B, M)
    safe_idx = torch.where(gt_valid, best_anchor, A)
    gt_no = torch.arange(M, device=dev).expand(B, M)
    forced_gt = torch.zeros((B, A + 1), dtype=torch.int64, device=dev) \
        .scatter_reduce(1, safe_idx, gt_no, "amax")[:, :A]
    forced = torch.zeros((B, A + 1), dtype=torch.bool, device=dev) \
        .scatter(1, safe_idx, True)[:, :A]
    # stage 2: remaining anchors match their best gt above threshold
    best_gt = torch.argmax(iou, dim=2)                       # (B, A)
    best_iou = iou.amax(dim=2)
    thresh_pos = best_iou >= overlap_threshold
    pos = forced | thresh_pos
    gt_idx = torch.where(forced, forced_gt, best_gt)
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    target = _encode_offsets(anc, matched, variances)
    mask = pos[..., None].float()
    cls_t = torch.where(pos, torch.gather(lab[..., 0], 1, gt_idx) + 1.0,
                        0.0)
    if negative_mining_ratio > 0:
        # near-positives (IoU >= negative_mining_thresh but below
        # overlap_threshold) are excluded from mining entirely
        # (reference rule) — neither positive nor trainable background
        mineable = (cls_t == 0) & (best_iou < negative_mining_thresh)
        # hardness of a negative = its max non-background class score
        hardness = torch.where(mineable, cpred[:, 1:].amax(dim=1),
                               float("-inf"))
        n_neg = torch.clamp(negative_mining_ratio * pos.sum(1).float(),
                            min=float(minimum_negative_samples)) \
            .to(torch.int32)
        order = _sort_desc(hardness)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(B, A))
        keep_neg = (rank < n_neg[:, None]) & (hardness > float("-inf"))
        cls_t = torch.where((cls_t == 0) & ~keep_neg, float(ignore_label),
                            cls_t)
    return ((target * mask).reshape(B, -1),
            mask[..., 0].repeat_interleave(4, dim=1), cls_t)


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode + NMS. cls_prob (B, num_cls+1, A), loc_pred (B, A*4),
    anchor (1, A, 4) -> (B, A, 6) rows [class_id, score, x1, y1, x2, y2];
    suppressed/background rows get class_id -1 (reference semantics)."""
    anc = anchor.reshape(-1, 4).float()
    A = anc.shape[0]
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    v0, v1, v2, v3 = variances
    # best non-background class per anchor
    cp = cls_prob.float().transpose(1, 2)                    # (B, A, C+1)
    masked = cp.clone()
    masked[..., background_id] = float("-inf")
    cls_id = torch.argmax(masked, dim=2)
    score = masked.amax(dim=2)
    d = loc_pred.float().reshape(-1, A, 4)
    cx = d[..., 0] * v0 * aw + acx
    cy = d[..., 1] * v1 * ah + acy
    w = torch.exp(d[..., 2] * v2) * aw
    h = torch.exp(d[..., 3] * v3) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    keep = score > threshold
    out_id = torch.where(keep, cls_id.float()
                         - (cls_id > background_id).float(), -1.0)
    det = torch.cat([out_id[..., None],
                     torch.where(keep, score, -1.0)[..., None], boxes], -1)
    out = box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  force_suppress=force_suppress)
    # box_nms only rewrites the score column; the documented contract is
    # that suppressed rows ALSO carry class_id -1
    out[..., 0] = torch.where(out[..., 1] < 0, -1.0, out[..., 0])
    return out


def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max ROI pooling (reference src/operator/roi_pooling.cc): integer bin
    boundaries (round + floor/ceil), max over each bin. data (B,C,H,W),
    rois (R,5) [batch_idx, x1, y1, x2, y2] image coords -> (R,C,PH,PW)."""
    if isinstance(pooled_size, int):
        pooled_size = (pooled_size, pooled_size)
    PH, PW = pooled_size
    B, C, H, W = data.shape
    x = data.float()
    r = rois.float()
    dev = x.device
    bidx = r[:, 0].to(torch.int32)
    x1, y1, x2, y2 = (torch.round(r[:, k] * spatial_scale)
                      for k in range(1, 5))
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)[:, None]
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)[:, None]
    ph = torch.arange(PH, dtype=torch.float32, device=dev)
    pw = torch.arange(PW, dtype=torch.float32, device=dev)
    hs = torch.floor(ph * rh / PH) + y1[:, None]             # (R, PH)
    he = torch.ceil((ph + 1) * rh / PH) + y1[:, None]
    ws = torch.floor(pw * rw / PW) + x1[:, None]
    we = torch.ceil((pw + 1) * rw / PW) + x1[:, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    my = (ys >= hs[..., None]) & (ys < he[..., None])        # (R, PH, H)
    mx = (xs >= ws[..., None]) & (xs < we[..., None])        # (R, PW, W)
    img = x[torch.clamp(bidx, min=0).long()]                 # (R, C, H, W)
    # separable masked max: rows, then columns
    tmp = torch.where(my[:, None, :, :, None], img[:, :, None],
                      float("-inf")).amax(dim=3)             # (R, C, PH, W)
    pooled = torch.where(mx[:, None, None], tmp[:, :, :, None],
                         float("-inf")).amax(dim=4)          # (R, C, PH, PW)
    pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    pooled = torch.where((bidx >= 0)[:, None, None, None], pooled, 0.0)
    return pooled.to(data.dtype)


def adaptive_avg_pooling(data, output_size=(1, 1)):
    """Adaptive average pooling (reference
    src/operator/contrib/adaptive_avg_pooling.cc): bin i spans
    [floor(i*H/OH), ceil((i+1)*H/OH)), as two products with bin-mean
    matrices."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    OH, OW = output_size
    B, C, H, W = data.shape

    def bin_matrix(n_in, n_out):
        m = np.zeros((n_out, n_in), np.float32)
        for i in range(n_out):
            s = int(np.floor(i * n_in / n_out))
            e = int(np.ceil((i + 1) * n_in / n_out))
            m[i, s:e] = 1.0 / (e - s)
        return torch.from_numpy(m).to(data.device)

    my = bin_matrix(H, OH)
    mx = bin_matrix(W, OW)
    tmp = torch.einsum("oh,bchw->bcow", my, data.float())
    out = torch.einsum("pw,bcow->bcop", mx, tmp)
    return out.to(data.dtype)


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposal generation (reference
    src/operator/contrib/proposal.cc / multi_proposal.cc), static-shape:
    anchors at every feature cell, bbox-delta decode, clip to image,
    min-size filter, top-pre_nms by fg score, greedy NMS, then the first
    rpn_post_nms_top_n survivors (zero-padded when fewer). Output
    (B*post, 5) rows [batch_idx, x1, y1, x2, y2] (+ (B*post, 1) scores if
    output_score)."""
    if iou_loss:
        raise NotImplementedError(
            "proposal: iou_loss decode is not supported; silently applying "
            "the standard delta decode would corrupt proposals")
    B, A2, H, W = cls_prob.shape
    A = len(scales) * len(ratios)
    dev = cls_prob.device
    base = float(feature_stride)
    anchors = []
    for r in ratios:
        for s in scales:
            ws = base * s * float(np.sqrt(1.0 / r))
            hs = base * s * float(np.sqrt(r))
            anchors.append([-(ws - 1) / 2, -(hs - 1) / 2,
                            (ws - 1) / 2, (hs - 1) / 2])
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)  # (A, 4)
    sy = torch.arange(H, dtype=torch.float32, device=dev) * base
    sx = torch.arange(W, dtype=torch.float32, device=dev) * base
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
    all_anc = (anc[None] + shifts).reshape(-1, 4)            # (HWA, 4)
    N = all_anc.shape[0]
    topn = min(rpn_pre_nms_top_n, N) if rpn_pre_nms_top_n > 0 else N
    cp = cls_prob.float()
    bp = bbox_pred.float()
    info = im_info.float()

    scores = cp[:, A:].permute(0, 2, 3, 1).reshape(B, -1)    # fg (B, HWA)
    deltas = bp.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    aw = all_anc[:, 2] - all_anc[:, 0] + 1.0
    ah = all_anc[:, 3] - all_anc[:, 1] + 1.0
    acx = all_anc[:, 0] + 0.5 * (aw - 1)
    acy = all_anc[:, 1] + 0.5 * (ah - 1)
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * ah
    boxes = torch.stack([cx - 0.5 * (w - 1), cy - 0.5 * (h - 1),
                         cx + 0.5 * (w - 1), cy + 0.5 * (h - 1)], -1)
    im_h, im_w = info[:, 0:1], info[:, 1:2]
    boxes = torch.stack([torch.clamp(boxes[..., 0], torch.zeros_like(im_w),
                                     im_w - 1),
                         torch.clamp(boxes[..., 1], torch.zeros_like(im_h),
                                     im_h - 1),
                         torch.clamp(boxes[..., 2], torch.zeros_like(im_w),
                                     im_w - 1),
                         torch.clamp(boxes[..., 3], torch.zeros_like(im_h),
                                     im_h - 1)], -1)
    min_sz = rpn_min_size * info[:, 2:3]
    ok = ((boxes[..., 2] - boxes[..., 0] + 1 >= min_sz)
          & (boxes[..., 3] - boxes[..., 1] + 1 >= min_sz))
    scores = torch.where(ok, scores, -1.0)
    # lax.top_k: descending, the lower index first among ties
    top_i = _sort_desc(scores)[:, :topn]
    top_s = torch.gather(scores, 1, top_i)
    rows = torch.cat([torch.zeros((B, topn, 1), device=dev),
                      top_s[..., None],
                      torch.gather(boxes, 1, top_i[..., None].expand(-1, -1,
                                                                     4))],
                     -1)
    kept = box_nms(rows, overlap_thresh=threshold, valid_thresh=0.0,
                   topk=rpn_post_nms_top_n, coord_start=2, score_index=1,
                   id_index=-1, force_suppress=True)
    # survivors first (already score-sorted by box_nms); pad to the
    # fixed rpn_post_nms_top_n rows when fewer candidates exist
    alive = kept[..., 1] > 0
    order = torch.argsort((~alive).to(torch.uint8), dim=1, stable=True)
    sel = torch.gather(kept, 1, order[..., None].expand(-1, -1, 6))
    if sel.shape[1] < rpn_post_nms_top_n:
        sel = torch.nn.functional.pad(
            sel, (0, 0, 0, rpn_post_nms_top_n - sel.shape[1]))
    sel = sel[:, :rpn_post_nms_top_n]
    rois = sel[..., 2:6]
    rscores = torch.where(sel[..., 1] > 0, sel[..., 1], 0.0)
    bidx = torch.arange(B, dtype=torch.float32, device=dev) \
        .repeat_interleave(rpn_post_nms_top_n)
    flat = torch.cat([bidx[:, None], rois.reshape(-1, 4)], dim=1)
    if output_score:
        return flat, rscores.reshape(-1, 1)
    return flat
