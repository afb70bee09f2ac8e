"""PyTorch port, `metric.py` against the JAX package's `mxnet_tpu/metric.py`
on the same inputs: every metric class (and `create` by registry name,
list and callable), fed numpy arrays to the JAX one and the port's
NDArrays, tensors and lists of either; and tests/train/test_yolo.py's
VOC07 mAP hand cases. Both compute on the host in numpy, so the values
are equal (float64 sums of the same numbers in the same order)."""
import numpy as np
import pytest
import torch

from mxnet_tpu import metric as mj

from mxnet_tpu_torch import metric as mt
from mxnet_tpu_torch import nd

_rng = np.random.RandomState(0)
_PROBS = _rng.dirichlet(np.ones(5), size=12).astype(np.float32)
_CLS = _rng.randint(0, 5, 12).astype(np.float32)
_REG = _rng.randn(12).astype(np.float32)
_REG_T = (_REG + 0.3 * _rng.randn(12)).astype(np.float32)
_BIN = _rng.rand(12, 2).astype(np.float32)
_BIN_T = _rng.randint(0, 2, 12).astype(np.float32)

_CASES = [
    ("acc", {}, _CLS, _PROBS),
    ("top_k_accuracy", {"top_k": 3}, _CLS, _PROBS),
    ("f1", {}, _BIN_T, _BIN),
    ("mae", {}, _REG_T, _REG),
    ("mse", {}, _REG_T, _REG),
    ("rmse", {}, _REG_T, _REG),
    ("ce", {}, _CLS, _PROBS),
    ("perplexity", {"ignore_label": 2}, _CLS, _PROBS),
    ("loss", {}, None, _REG ** 2),
    ("pearsonr", {}, _REG_T, _REG),
]


def _feed(kind, a):
    if a is None:
        return None
    if kind == "nd":
        return nd.array(a, ctx="cpu")
    if kind == "tensor":
        return torch.from_numpy(a.copy())
    return [nd.array(a, ctx="cpu")]


@pytest.mark.parametrize("kind", ["nd", "tensor", "list"])
@pytest.mark.parametrize("name,kw,label,pred", _CASES,
                         ids=[c[0] for c in _CASES])
def test_metric_matches_jax(name, kw, label, pred, kind):
    want = mj.create(name, **kw)
    got = mt.create(name, **kw)
    assert type(got).__name__ == type(want).__name__
    for half in (slice(0, 6), slice(6, 12)):
        lab = None if label is None else label[half]
        want.update(None if lab is None else [lab], [pred[half]])
        got.update(_feed(kind, lab), _feed(kind, pred[half]))
    assert got.get() == pytest.approx(want.get(), rel=1e-12)
    assert got.get_name_value() == pytest.approx(want.get_name_value())
    got.reset()
    want.reset()
    n_got, v_got = got.get()
    assert n_got == want.get()[0] and (np.isnan(v_got) or name == "f1")


def test_composite_custom_and_bleu_match_jax():
    def feval(label, pred):
        return float(np.abs(label - pred).sum()), label.size

    for make in (lambda m: m.create(["acc", "ce"]),
                 lambda m: m.create(feval, name="l1"),
                 lambda m: m.np_metric(lambda l, p: float((l == p).mean()))):
        want, got = make(mj), make(mt)
        want.update([_CLS], [_PROBS if "acc" in str(want) else _CLS])
        got.update([nd.array(_CLS, ctx="cpu")],
                   [nd.array(_PROBS if "acc" in str(got) else _CLS,
                             ctx="cpu")])
        assert got.get() == want.get()
    refs = [np.array([1, 2, 3, 4, 5, 6]), np.array([7, 8, 9, 10])]
    hyps = [np.array([1, 2, 3, 4, 6, 6]), np.array([7, 8, 9])]
    for smooth in (False, True):
        want = mj.BLEU(smooth=smooth)
        got = mt.BLEU(smooth=smooth)
        want.update(refs, hyps)
        got.update([torch.from_numpy(r) for r in refs],
                   [nd.array(h, ctx="cpu") for h in hyps])
        assert got.get() == want.get()


def test_voc_map_hand_cases():
    """tests/train/test_yolo.py's cases on the port: one tp, a duplicate
    and a miss give 6/11; a perfect detector 1; suppressed rows (score
    < 0) are ignored; NDArray lists are consumed pairwise."""
    labels = np.asarray([[[0, 0, 0, 10, 10], [0, 20, 20, 30, 30],
                          [-1, 0, 0, 0, 0]]], np.float32)
    preds = np.asarray([[[0, 0.9, 0, 0, 10, 10], [0, 0.8, 1, 1, 10, 10],
                         [0, 0.7, 50, 50, 60, 60]]], np.float32)
    for m in (mt.VOC07MApMetric(iou_thresh=0.5), mj.VOC07MApMetric()):
        m.update(labels, preds)
        np.testing.assert_allclose(m.get()[1], 6 / 11, atol=1e-6)
    m2 = mt.VOC07MApMetric()
    m2.update(torch.from_numpy(labels), torch.from_numpy(np.asarray(
        [[[0, 0.9, 0, 0, 10, 10], [0, 0.8, 20, 20, 30, 30],
          [-1, -1, 0, 0, 0, 0]]], np.float32)))
    assert m2.get()[1] == pytest.approx(1.0)
    m3 = mt.VOC07MApMetric()
    m3.update([nd.array([[[1, 0, 0, 10, 10]]], ctx="cpu")],
              [nd.array([[[1, -1.0, 0, 0, 10, 10], [1, 0.9, 0, 0, 10, 10]]],
                        ctx="cpu")])
    assert m3.get()[1] == pytest.approx(1.0)
    assert "voc07map" in mt._registry and "voc_map" in mt._registry


def test_voc_map_matches_jax_on_random_detections():
    rng = np.random.RandomState(3)
    labels = np.full((4, 5, 5), -1.0, np.float32)
    preds = np.zeros((4, 12, 6), np.float32)
    for b in range(4):
        for g in range(rng.randint(1, 5)):
            xy = rng.rand(2) * 40
            labels[b, g] = [rng.randint(0, 3), *xy, *(xy + 5 + 10 *
                                                      rng.rand(2))]
        for d in range(12):
            xy = rng.rand(2) * 40
            preds[b, d] = [rng.randint(0, 3), rng.rand() * 1.2 - 0.2, *xy,
                           *(xy + 5 + 10 * rng.rand(2))]
        preds[b, :3, 2:] = labels[b, :3, 1:] + rng.rand(3, 4)
        preds[b, :3, 0] = labels[b, :3, 0]
    want, got = mj.VOC07MApMetric(), mt.VOC07MApMetric()
    want.update(labels, preds)
    got.update(nd.array(labels, ctx="cpu"), torch.from_numpy(preds))
    assert got.get() == want.get()
    assert 0.0 < got.get()[1] < 1.0
