"""Greedy non-maximum suppression: the keep mask of score-sorted boxes.

Not the port of a Pallas kernel. The JAX package suppresses with a
`lax.fori_loop` over the N candidate rows (`mxnet_tpu/ops/
detection_ops.py:84` `box_nms`, `mxnet_tpu/models/ssd.py:125`
`non_max_suppression`), a loop it keeps on the device inside jit. Eager
PyTorch would run it as N rounds of launches from the host, so the loop
is the hand-written kernel of `csrc/box_nms.cu` (one thread block an
image, walking its rows in chunks: a cross test against the rows kept
so far, a chunk suppression bitmask, one in-order scan a chunk).

`box_nms_keep(boxes, valid, ids, overlap_thresh, n_suppressors,
clamp_area, max_keep)` takes (B, N, 4) float32 corner boxes already
sorted by descending score, a (B, N) bool valid mask and optional (B,
N) float32 class ids, and returns the (B, N) bool keep mask of the JAX
loop:

    keep = valid
    for i in range(min(N, n_suppressors)):
        if keep[i] and valid[i]:
            keep[j] = False for every j > i with iou(i, j) > overlap_thresh
                           (with ids: and ids[i] == ids[j])

cut to its first `max_keep` survivors when given (`keep & (rank <
max_keep)`, rank = cumsum(keep) - 1: `box_nms`'s top-k), so the kernel
stops at an image's max_keep-th survivor. `n_suppressors` is N for
`box_nms` and min(N, topk) for SSD's `non_max_suppression`, whose loop
lets only the first topk rows suppress (and which takes no max_keep:
its top-k ranks scores, not survivors). IoU is `_corner_iou`'s
(`pair_iou`); `clamp_area=False` is SSD's `_iou`, which does not clamp
the areas at 0. The callers do the rest in torch: the stable sort, the
valid mask, top-k and the score rewrite.

For CUDA tensors it launches the kernel; for CPU tensors it runs the
plain version, `box_nms_keep_reference`: the JAX loop row by row, one
(B, N) IoU row at a time (never the (N, N) matrix: 3.6 GB an image at
SSD300's 30,120 anchors), then the cut. Any other device raises.
`launches` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["box_nms_keep", "box_nms_keep_reference", "pair_iou"]

launches = 0


def pair_iou(a, b, clamp_area=True):
    """IoU of corner boxes a (..., M, 4) and b (..., N, 4) -> (..., M, N),
    `_corner_iou`'s formula in its order of operations (areas clamped at
    0 unless `clamp_area` is False, as SSD's `_iou`)."""
    ax1, ay1, ax2, ay2 = a.unsqueeze(-2).unbind(-1)          # (..., M, 1)
    bx1, by1, bx2, by2 = b.unsqueeze(-3).unbind(-1)          # (..., 1, N)
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0.0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0.0)
    inter = ix * iy
    wa, ha, wb, hb = ax2 - ax1, ay2 - ay1, bx2 - bx1, by2 - by1
    if clamp_area:
        wa, ha, wb, hb = (t.clamp(min=0.0) for t in (wa, ha, wb, hb))
    return inter / (wa * ha + wb * hb - inter).clamp(min=1e-12)


def box_nms_keep_reference(boxes, valid, ids=None, overlap_thresh=0.5,
                           n_suppressors=None, clamp_area=True,
                           max_keep=None):
    """The plain version: the JAX loop, one IoU row a step, then the cut
    to `max_keep` survivors. Rows after the last valid row of every
    image cannot suppress (their keep is False from the start), so the
    loop stops there."""
    B, N, _ = boxes.shape
    keep = valid.clone()
    n = N if n_suppressors is None else max(min(int(n_suppressors), N), 0)
    any_valid = valid.any(0).nonzero()
    stop = min(n, int(any_valid[-1]) + 1) if len(any_valid) else 0
    later = torch.arange(N, device=boxes.device)
    for i in range(stop):
        alive = keep[:, i] & valid[:, i]
        iou = pair_iou(boxes[:, i:i + 1], boxes, clamp_area)[:, 0]
        if ids is not None:
            iou = torch.where(ids[:, i:i + 1] == ids, iou, 0.0)
        keep &= ~((iou > overlap_thresh) & (later > i) & alive[:, None])
    if max_keep is not None:
        keep &= keep.cumsum(-1) <= max_keep
    return keep


_fns = {}


def _entry(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[name] = fn
    return fn


def _check(boxes, valid, ids):
    """Raise unless the kernel can take these tensors."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.dtype != torch.float32:
        raise ValueError(f"box_nms_keep: boxes are {tuple(boxes.shape)} "
                         f"{boxes.dtype}, expected (B, N, 4) float32")
    B, N, _ = boxes.shape
    want = [("valid", valid, torch.bool)]
    if ids is not None:
        want.append(("ids", ids, torch.float32))
    for name, t, dtype in want:
        if tuple(t.shape) != (B, N) or t.dtype != dtype:
            raise ValueError(f"box_nms_keep: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected ({B}, {N}) {dtype}")
        if t.device != boxes.device:
            raise ValueError(f"box_nms_keep: {name} on {t.device}, boxes "
                             f"on {boxes.device}")
    if B * N >= 2 ** 31:
        raise ValueError(f"box_nms_keep: {B} x {N} rows exceed the "
                         "kernel's int32 row count")


def box_nms_keep(boxes, valid, ids=None, overlap_thresh=0.5,
                 n_suppressors=None, clamp_area=True, max_keep=None):
    """The (B, N) bool keep mask of greedy NMS over score-sorted (B, N,
    4) corner boxes, cut to the first `max_keep` survivors of each image
    when given (see the module docstring)."""
    if max_keep is not None and max_keep < 0:
        raise ValueError(f"box_nms_keep: max_keep {max_keep} < 0")
    if boxes.device.type == "cpu":
        return box_nms_keep_reference(boxes, valid, ids, overlap_thresh,
                                      n_suppressors, clamp_area, max_keep)
    if boxes.device.type != "cuda":
        raise ValueError(f"box_nms_keep: unsupported device {boxes.device}")
    _check(boxes, valid, ids)
    B, N, _ = boxes.shape
    if B * N == 0:
        return valid.clone()
    n = N if n_suppressors is None else max(min(int(n_suppressors), N), 0)
    mk = -1 if max_keep is None else min(int(max_keep), N)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:                 # the kernel reads float4s
        boxes = boxes.clone()
    # bool tensors are one byte an element, 0 or 1: the kernel reads and
    # writes them as uint8
    valid = valid.contiguous()
    ids = None if ids is None else ids.contiguous()
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    # the kept list past what shared memory holds: (box, area and id) of
    # up to min(n_suppressors, max_keep) rows an image
    cap = n if mk < 0 else min(n, mk)
    scratch = torch.empty(B * cap * 6, dtype=torch.float32,
                          device=boxes.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    err = _entry("mx_box_nms_keep",
                 [p, p, p, p, p, i, i, ctypes.c_float, i, i, i, p])(
        boxes.data_ptr(), valid.data_ptr(),
        None if ids is None else ids.data_ptr(), keep.data_ptr(),
        scratch.data_ptr(), B, N, float(overlap_thresh), n, mk,
        int(bool(clamp_area)), torch.cuda.current_stream(boxes.device)
        .cuda_stream)
    _build.check(err, "box_nms_keep")
    if _build.cost_tally is not None:
        _build.tally(0, boxes, valid, ids, keep)
    global launches
    launches += 1
    return keep
