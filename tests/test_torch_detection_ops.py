"""PyTorch port, `ops/detection_ops.py` against the JAX package's
`mxnet_tpu/ops/detection_ops.py` on the CPU, from the same seeded numpy
inputs: box_iou (corner and center), box_nms (force_suppress x topk x
id_index x valid_thresh, batched, with tied scores), multibox_prior,
multibox_target (padding rows, negative mining), multibox_detection,
roi_align, roi_pooling, adaptive_avg_pooling and proposal; and the
`nd` contrib names (`nd._contrib_box_nms`, `nd.contrib.box_nms`, ...).

Tolerances: outputs that are selections, orders, masks or integer
arithmetic are equal; float arithmetic within 1e-6: sums and products
run in another order in the two frameworks (roi_align's bin means,
adaptive pooling's products), XLA:CPU contracts a multiply-add into one
FMA and approximates exp and log otherwise than torch (a few float32
ulps in multibox_detection's boxes, multibox_target's offsets and
proposal's boxes)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import detection_ops as dj

from mxnet_tpu_torch import nd
from mxnet_tpu_torch.cuda_ops import box_nms as bn
from mxnet_tpu_torch.ops import detection_ops as dt

TOL = 1e-6


def _rows(rng, B, N, n_cls=3, ties=False):
    xy = rng.rand(B, N, 2) * 4
    wh = rng.rand(B, N, 2) * 2 + 0.1
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.rand(B, N)
    if ties:                                     # blocks of equal scores
        scores = np.round(scores * 4) / 4
    ids = rng.randint(0, n_cls, (B, N))
    return np.concatenate([ids[..., None], scores[..., None], boxes],
                          -1).astype(np.float32)


def _j(fn, *arrays, **kw):
    """The JAX op under jit: one compilation instead of one per op."""
    out = jax.jit(functools.partial(fn, **kw))(*[jnp.asarray(a)
                                                 for a in arrays])
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _t(fn, *arrays, **kw):
    out = fn(*[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(0)
    a = (rng.rand(2, 5, 4) * 3).astype(np.float32)
    b = (rng.rand(2, 7, 4) * 3).astype(np.float32)
    a[0, 0] = [2, 2, 1, 1]                       # an inverted box: area 0
    np.testing.assert_array_equal(_t(dt.box_iou, a, b, format=fmt),
                                  _j(dj.box_iou, a, b, format=fmt))


@pytest.mark.parametrize("valid_thresh", [0.0, 0.4])
@pytest.mark.parametrize("id_index", [-1, 0])
@pytest.mark.parametrize("topk", [-1, 3, 100])
@pytest.mark.parametrize("force", [False, True])
def test_box_nms(force, topk, id_index, valid_thresh):
    rng = np.random.RandomState(1)
    data = _rows(rng, 3, 24, ties=True)          # batched, tied scores
    kw = dict(overlap_thresh=0.3, valid_thresh=valid_thresh, topk=topk,
              coord_start=2, score_index=1, id_index=id_index,
              force_suppress=force)
    got = _t(dt.box_nms, data, **kw)
    np.testing.assert_array_equal(got, _j(dj.box_nms, data, **kw))
    assert (got[..., 1] < 0).any() and (got[..., 1] > 0).any()


def test_box_nms_center_format_and_batch_dims():
    rng = np.random.RandomState(2)
    data = _rows(rng, 6, 10).reshape(2, 3, 10, 6)
    data[..., 4:6] -= data[..., 2:4]             # (cx, cy, w, h)-like
    kw = dict(overlap_thresh=0.2, in_format="center", id_index=0)
    np.testing.assert_array_equal(_t(dt.box_nms, data, **kw),
                                  _j(dj.box_nms, data, **kw))


def _greedy_loop(d, iou, valid, thresh, n_sup, with_ids):
    """The keep mask of the JAX loop, row by row in numpy."""
    want = valid.copy()
    B, N = want.shape
    for b in range(B):
        for i in range(N if n_sup is None else n_sup):
            if not want[b, i]:
                continue
            for j in range(i + 1, N):
                same = not with_ids or d[b, i, 0] == d[b, j, 0]
                if (iou[b, i, j] if same else 0.0) > thresh:
                    want[b, j] = False
    return want


def test_box_nms_keep_reference_is_the_loop():
    """The plain keep mask equals a row-by-row loop in numpy, with
    n_suppressors cutting who may suppress (SSD's topk loop)."""
    rng = np.random.RandomState(3)
    d = _rows(rng, 2, 30)
    boxes = torch.from_numpy(d[..., 2:6].copy())
    valid = torch.from_numpy(d[..., 1] > 0.2)
    ids = torch.from_numpy(d[..., 0].copy())
    iou = bn.pair_iou(boxes, boxes).numpy()
    for n_sup, with_ids in ((None, True), (5, False), (0, True)):
        got = bn.box_nms_keep(boxes, valid, ids if with_ids else None, 0.25,
                              n_sup).numpy()
        np.testing.assert_array_equal(
            got, _greedy_loop(d, iou, d[..., 1] > 0.2, 0.25, n_sup,
                              with_ids))


@pytest.mark.parametrize("thresh", [0.25, -0.5])
@pytest.mark.parametrize("with_ids", [True, False])
@pytest.mark.parametrize("max_keep", [0, 1, 5, 30, 1000])
def test_box_nms_keep_reference_cuts_at_max_keep(max_keep, with_ids,
                                                 thresh):
    """With max_keep, the plain keep mask is the numpy loop's cut to its
    first max_keep survivors (rank = cumsum - 1 < max_keep), for a cut
    below, at and past the survivors (N = 30), and with a negative
    threshold (rows of other classes compare as IoU 0: suppressed)."""
    rng = np.random.RandomState(4)
    d = _rows(rng, 3, 30)
    d[1, :, 1] = 0.0                             # an image with none valid
    boxes = torch.from_numpy(d[..., 2:6].copy())
    valid = d[..., 1] > 0.2
    ids = torch.from_numpy(d[..., 0].copy()) if with_ids else None
    loop = _greedy_loop(d, bn.pair_iou(boxes, boxes).numpy(), valid,
                        thresh, None, with_ids)
    want = loop & (np.cumsum(loop, -1) - 1 < max_keep)
    for fn in (bn.box_nms_keep, bn.box_nms_keep_reference):
        got = fn(boxes, torch.from_numpy(valid), ids, thresh,
                 max_keep=max_keep).numpy()
        np.testing.assert_array_equal(got, want)
    if thresh > 0 and max_keep == 5:
        assert (want.sum(-1) == [5, 0, 5]).all() and loop.sum() > 10
    with pytest.raises(ValueError, match="max_keep"):
        bn.box_nms_keep(boxes, torch.from_numpy(valid), ids, max_keep=-1)


def test_multibox_prior():
    data = np.zeros((1, 3, 3, 4), np.float32)
    for kw in (dict(sizes=(0.5, 0.25), ratios=(1.0, 2.0, 0.5)),
               dict(sizes=(0.3,), ratios=(1.0,), clip=True,
                    steps=(0.2, 0.3), offsets=(0.25, 0.75))):
        np.testing.assert_array_equal(_t(dt.multibox_prior, data, **kw),
                                      _j(dj.multibox_prior, data, **kw))


def _multibox_inputs(rng, B=3, M=4, C=3):
    anchors = dj.multibox_prior(jnp.zeros((1, 3, 4, 4)), sizes=(0.3, 0.15),
                                ratios=(1.0, 2.0, 0.5))
    anchors = np.asarray(anchors)
    A = anchors.shape[1]
    label = np.full((B, M, 5), -1.0, np.float32)
    for b in range(B):
        for m in range(rng.randint(1, M)):       # padding rows after
            xy = rng.rand(2) * 0.6
            wh = rng.rand(2) * 0.3 + 0.05
            label[b, m] = [rng.randint(0, C), *xy, *(xy + wh)]
    cls_pred = rng.randn(B, C + 1, A).astype(np.float32)
    return anchors, label, cls_pred


@pytest.mark.parametrize("mining", [-1.0, 3.0])
def test_multibox_target(mining):
    rng = np.random.RandomState(4)
    anchors, label, cls_pred = _multibox_inputs(rng)
    kw = dict(negative_mining_ratio=mining, minimum_negative_samples=2,
              overlap_threshold=0.4)
    got = _t(dt.multibox_target, anchors, label, cls_pred, **kw)
    want = _j(dj.multibox_target, anchors, label, cls_pred, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[2], want[2])
    if mining > 0:
        assert (got[2] == -1).any()


def test_multibox_target_padding_rows_do_not_clobber():
    """tests/unittest/test_misc_ops.py's case: padding argmaxes land on
    anchor 0 and must be dropped, not scattered."""
    anchors = np.array([[[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 1.0, 1.0]]],
                       np.float32)
    gt = np.array([[[1.0, 0.0, 0.0, 0.2, 0.9], [-1.0, 0, 0, 0, 0],
                    [-1.0, 0, 0, 0, 0]]], np.float32)
    cls_pred = np.zeros((1, 3, 2), np.float32)
    got = _t(dt.multibox_target, anchors, gt, cls_pred)
    want = _j(dj.multibox_target, anchors, gt, cls_pred)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0, 0] == 2.0 and got[1][0, :4].sum() == 4.0


def test_argmax_ties_take_the_first_index():
    """Ties in both argmaxes of multibox_target: gt 0 overlaps anchors 0
    and 1 equally (its claim goes to anchor 0, the first); gts 1 and 2
    are the same box, so anchor 3 matches both equally above the
    threshold (gt 1, the first, wins) while both claim anchor 2 in stage
    1 (the highest index, gt 2, wins: `.at[].max`)."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.0, 1.0, 0.5],
                         [0.0, 0.5, 0.5, 1.0], [0.0, 0.5, 0.55, 1.0]]],
                       np.float32)
    gt = np.array([[[0.0, 0.25, 0.0, 0.75, 0.5], [1.0, 0.0, 0.5, 0.5, 1.0],
                    [2.0, 0.0, 0.5, 0.5, 1.0]]], np.float32)
    cls_pred = np.zeros((1, 4, 4), np.float32)
    got = _t(dt.multibox_target, anchors, gt, cls_pred)
    want = _j(dj.multibox_target, anchors, gt, cls_pred)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2][0], [1.0, 0.0, 3.0, 2.0])


@pytest.mark.parametrize("force,topk", [(False, -1), (True, 5), (False, 5)])
def test_multibox_detection(force, topk):
    rng = np.random.RandomState(5)
    anchors, _, _ = _multibox_inputs(rng)
    A = anchors.shape[1]
    logits = rng.randn(2, 4, A).astype(np.float32)
    cls_prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(2, A * 4) * 0.5).astype(np.float32)
    kw = dict(threshold=0.3, nms_threshold=0.4, force_suppress=force,
              nms_topk=topk)
    got = _t(dt.multibox_detection, cls_prob, loc, anchors, **kw)
    want = _j(dj.multibox_detection, cls_prob, loc, anchors, **kw)
    # ids and scores are selections; the boxes come from exp and a
    # multiply-add, which XLA:CPU contracts and approximates otherwise
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()


def _feature_and_rois(rng):
    data = rng.randn(2, 3, 9, 11).astype(np.float32)
    rois = np.array([[0, 1.5, 2.0, 7.2, 6.1], [1, 0, 0, 10, 8],
                     [1, 3.3, 4.4, 3.9, 4.9], [-1, 1, 1, 4, 4],
                     [0, 8.0, 6.0, 30.0, 20.0]], np.float32)
    return data, rois


@pytest.mark.parametrize("kw", [dict(pooled_size=(3, 2)),
                                dict(pooled_size=2, spatial_scale=0.5,
                                     sample_ratio=3)])
def test_roi_align(kw):
    data, rois = _feature_and_rois(np.random.RandomState(6))
    np.testing.assert_allclose(_t(dt.roi_align, data, rois, **kw),
                               _j(dj.roi_align, data, rois, **kw),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [dict(pooled_size=(3, 2)),
                                dict(pooled_size=4, spatial_scale=0.5)])
def test_roi_pooling(kw):
    data, rois = _feature_and_rois(np.random.RandomState(7))
    np.testing.assert_array_equal(_t(dt.roi_pooling, data, rois, **kw),
                                  _j(dj.roi_pooling, data, rois, **kw))


@pytest.mark.parametrize("size", [(1, 1), (4, 3), 5])
def test_adaptive_avg_pooling(size):
    data = np.random.RandomState(8).randn(2, 3, 9, 11).astype(np.float32)
    np.testing.assert_allclose(
        _t(dt.adaptive_avg_pooling, data, output_size=size),
        _j(dj.adaptive_avg_pooling, data, output_size=size),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("output_score", [False, True])
def test_proposal(output_score):
    rng = np.random.RandomState(9)
    B, H, W, A = 2, 4, 5, 6
    cls_prob = rng.rand(B, 2 * A, H, W).astype(np.float32)
    cls_prob[0, A:A + 2] = 0.5                   # tied foreground scores
    bbox = (rng.randn(B, 4 * A, H, W) * 0.2).astype(np.float32)
    im_info = np.array([[60, 70, 1.0], [50, 80, 0.5]], np.float32)
    kw = dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=20, threshold=0.5,
              rpn_min_size=4, scales=(2, 4), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=output_score)
    got = _t(dt.proposal, cls_prob, bbox, im_info, **kw)
    want = _j(dj.proposal, cls_prob, bbox, im_info, **kw)
    for g, w in zip(got if output_score else [got],
                    want if output_score else [want]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_nd_contrib_names():
    """The registry names and `nd.contrib.<op>` reach the ops, NDArray
    in and out, with the JAX keyword names (the JAX package's
    `nd._contrib_*` run the same functions as `_j` here)."""
    rng = np.random.RandomState(10)
    data = _rows(rng, 2, 12)
    kw = dict(overlap_thresh=0.3, topk=4, id_index=0)
    want = _j(dj.box_nms, data, **kw)
    for fn in (nd._contrib_box_nms, nd.contrib.box_nms):
        got = fn(nd.array(data, ctx="cpu"), **kw)
        assert isinstance(got, nd.NDArray)
        np.testing.assert_array_equal(got.asnumpy(), want)
    a = (rng.rand(3, 4) * 2).astype(np.float32)
    np.testing.assert_array_equal(
        nd.contrib.box_iou(nd.array(a, ctx="cpu"), nd.array(a, ctx="cpu"),
                           format="center").asnumpy(),
        _j(dj.box_iou, a, a, format="center"))
    anchors, label, cls_pred = _multibox_inputs(rng)
    got = nd._contrib_MultiBoxTarget(*[nd.array(x, ctx="cpu") for x in
                                       (anchors, label, cls_pred)],
                                     negative_mining_ratio=3.0)
    want = _j(dj.multibox_target, anchors, label, cls_pred,
              negative_mining_ratio=3.0)
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w, rtol=TOL, atol=TOL)
    feat = nd.zeros((1, 2, 3, 3), ctx="cpu")
    assert nd.contrib.MultiBoxPrior(feat, sizes=(0.5,)).shape == (1, 9, 4)
    assert nd._contrib_AdaptiveAvgPooling2D(
        feat, output_size=1).shape == (1, 2, 1, 1)
    data, rois = _feature_and_rois(rng)
    for name, ref in (("ROIPooling", dj.roi_pooling),
                      ("_contrib_ROIAlign", dj.roi_align)):
        got = getattr(nd, name)(nd.array(data, ctx="cpu"),
                                nd.array(rois, ctx="cpu"), pooled_size=2)
        np.testing.assert_allclose(got.asnumpy(),
                                   _j(ref, data, rois, pooled_size=2),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError):
        nd._contrib_not_an_op
    with pytest.raises(AttributeError):
        nd.contrib.not_an_op
