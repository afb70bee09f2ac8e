"""PyTorch port, BERT's fine-tuning heads against the JAX package on the
CPU: `BERTForQuestionAnswering` with `bert_qa_loss` (SQuAD) and
`BERTClassifier` (GLUE) at `bert_tiny_config()` (float32, dropout 0),
the port's weights carried from the JAX model by name
(`weights.load_named_arrays`), the same numpy inputs.

* QA: start and end logits within 1e-5 (absolute, float32), the masked
  positions (at or past `valid_length`) equal -1e9 in both packages,
  `bert_qa_loss` within 1e-5, and every gradient read through the
  MXNet accessor `p.grad()` within 1e-5 of the JAX package's, but the
  position embedding's (the JAX package's eager BERT reads it outside
  its tape: zero there; ROADMAP.md "The oracle is red");
* three `adamw` steps through `gluon.Trainer` at lr 1e-4 (position
  embedding frozen on both sides): losses within 1e-5, parameters
  within lr / 2 (Adam moves an element whose gradient is near zero by
  up to lr, whichever way float32 rounding tips it);
* the classifier (dropout 0, as both packages draw other masks): logits
  within 1e-5, and its gradients by `p.grad()`.
* `bert_qa_loss` takes NDArrays, tensors or numpy arrays alike;
* the classifier at BERT-base's widths (1 layer) through three `adamw`
  steps at GLUE's lr 5e-5 without a warm-up: losses within 1e-5, and in
  both packages the loss after the first step is above the first
  (Adam's first step moves every weight by about lr and overshoots from
  random weights; `chip_smoke.py` phase 52 warms the learning rate up
  as GluonNLP's `finetune_classifier.py` does).
"""
import numpy as np
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu.models import bert as bert_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import bert as bert_t

CPU = mxt.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)
POS = "bert.position_embed"


def _inputs(B=3, L=16, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 128, (B, L)).astype(np.int32)
    types = np.zeros((B, L), np.int32)
    types[:, L // 2:] = 1
    valid = np.asarray([L, L - 4, L - 7][:B], np.int32)
    start = np.asarray([1, 3, 0][:B], np.int32)
    end = np.asarray([2, 5, 6][:B], np.int32)
    return ids, types, valid, start, end


def _pair(make_j, make_t, seed=0):
    jm = make_j(bert_j.bert_tiny_config())
    mx.random.seed(seed)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    tm = make_t(bert_t.bert_tiny_config())
    weights.load_named_arrays(tm, arrays)
    return jm, tm


def _qa_pair():
    return _pair(bert_j.BERTForQuestionAnswering,
                 lambda cfg: bert_t.BERTForQuestionAnswering(cfg,
                                                             device="cpu"))


def test_qa_logits_masks_loss_and_grads_match_jax():
    jm, tm = _qa_pair()
    ids, types, valid, sp, ep = _inputs()
    with ag_j.record():
        sj, ej = jm(nd_j.array(ids), nd_j.array(types), nd_j.array(valid))
        lj = bert_j.bert_qa_loss(sj, ej, nd_j.array(sp), nd_j.array(ep))
    lj.backward()
    with ag_t.record():
        st, et = tm(nd_t.array(ids, ctx=CPU), nd_t.array(types, ctx=CPU),
                    nd_t.array(valid, ctx=CPU))
        lt = bert_t.bert_qa_loss(st, et, nd_t.array(sp, ctx=CPU),
                                 nd_t.array(ep, ctx=CPU))
    lt.backward()
    for got, want in ((st, sj), (et, ej)):
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
        live = np.arange(16)[None, :] < valid[:, None]
        assert (got.asnumpy()[~live] == -1e9).all()
        assert (want.asnumpy()[~live] == -1e9).all()
        assert (got.asnumpy()[live] > -1e8).all()
    np.testing.assert_allclose(lt.asscalar(), lj.asscalar(), **TOL)
    for k, p in tm.collect_params().items():
        if k != POS:
            np.testing.assert_allclose(
                p.grad().asnumpy(), jm.collect_params()[k].grad().asnumpy(),
                err_msg=k, **TOL)
    assert np.abs(tm.span.weight.grad().asnumpy()).sum() > 0
    assert not jm.collect_params()[POS].grad().asnumpy().any()


def test_qa_adamw_steps_through_gluon_trainer_match_jax():
    jm, tm = _qa_pair()
    ids, types, valid, sp, ep = _inputs(seed=1)
    opt = {"learning_rate": 1e-4, "wd": 0.01}
    losses = {}
    for pkg, model, nd, ag, gluon, bert, kw in (
            ("jax", jm, nd_j, ag_j, gluon_j, bert_j, {}),
            ("port", tm, nd_t, ag_t, gluon_t, bert_t, {"ctx": CPU})):
        model.collect_params()[POS].grad_req = "null"
        trainer = gluon.Trainer(model.collect_params(), "adamw", dict(opt))
        arrays = [nd.array(a, **kw) for a in (ids, types, valid, sp, ep)]
        out = []
        for _ in range(3):
            with ag.record():
                s, e = model(*arrays[:3])
                loss = bert.bert_qa_loss(s, e, *arrays[3:])
            loss.backward()
            trainer.step(1)
            out.append(float(loss.asscalar()))
        losses[pkg] = out
    np.testing.assert_allclose(losses["port"], losses["jax"], **TOL)
    assert losses["port"][-1] < losses["port"][0]
    # Adam moves an element by up to lr a step whatever its gradient's
    # size, so float32 rounding of a near-zero gradient (LayerNorm betas)
    # moves it otherwise: parameters within lr / 2
    for k, p in tm.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jm.collect_params()[k].data().asnumpy(),
                                   err_msg=k, rtol=1e-5,
                                   atol=opt["learning_rate"] / 2)


def test_classifier_logits_and_grads_match_jax():
    jm, tm = _pair(lambda cfg: bert_j.BERTClassifier(cfg, num_classes=3,
                                                     dropout=0.0),
                   lambda cfg: bert_t.BERTClassifier(cfg, num_classes=3,
                                                     dropout=0.0,
                                                     device="cpu"), seed=2)
    ids, types, valid, _, _ = _inputs(seed=2)
    with ag_j.record():
        oj = jm(nd_j.array(ids), nd_j.array(types), nd_j.array(valid))
        (oj * oj).sum().backward()
    with ag_t.record():
        ot = tm(nd_t.array(ids, ctx=CPU), nd_t.array(types, ctx=CPU),
                nd_t.array(valid, ctx=CPU))
        (ot * ot).sum().backward()
    assert ot.shape == (3, 3)
    np.testing.assert_allclose(ot.asnumpy(), oj.asnumpy(), **TOL)
    for k in ("classifier.weight", "classifier.bias", "bert.pooler.weight"):
        np.testing.assert_allclose(
            tm.collect_params()[k].grad().asnumpy(),
            jm.collect_params()[k].grad().asnumpy(), err_msg=k, **TOL)


def test_qa_loss_takes_ndarrays_tensors_and_numpy():
    rs = np.random.RandomState(3)
    s, e = rs.randn(4, 10).astype(np.float32), rs.randn(4, 10).astype(
        np.float32)
    sp, ep = np.asarray([0, 2, 9, 4]), np.asarray([1, 2, 9, 7])
    want = float(bert_j.bert_qa_loss(nd_j.array(s), nd_j.array(e),
                                     nd_j.array(sp), nd_j.array(ep))
                 .asscalar())
    got_np = bert_t.bert_qa_loss(torch.tensor(s), e, sp, ep)
    got_nd = bert_t.bert_qa_loss(nd_t.array(s, ctx=CPU),
                                 nd_t.array(e, ctx=CPU), sp, ep)
    assert isinstance(got_np, torch.Tensor) and got_np.dtype == torch.float32
    assert isinstance(got_nd, nd_t.NDArray)
    np.testing.assert_allclose(float(got_np), want, rtol=1e-6)
    np.testing.assert_allclose(got_nd.asscalar(), want, rtol=1e-6)
    with mxt.cpu():
        np.testing.assert_allclose(float(bert_t.bert_qa_loss(s, e, sp, ep)),
                                   want, rtol=1e-6)


def test_classifier_adamw_overshoot_at_bert_base_widths_matches_jax():
    B, L = 8, 32
    jm = bert_j.BERTClassifier(bert_j.bert_base_config(num_layers=1,
                                                       dropout=0.0),
                               num_classes=2, dropout=0.0)
    mx.random.seed(0)
    jm.initialize()
    tm = bert_t.BERTClassifier(bert_t.bert_base_config(num_layers=1,
                                                       dropout=0.0),
                               num_classes=2, dropout=0.0, device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    rs = np.random.RandomState(4)
    valid = rs.randint(L // 2, L + 1, B).astype(np.int32)
    pos = np.arange(L)[None]
    ids = rs.randint(1, 30522, (B, L)).astype(np.int32)
    ids[pos >= valid[:, None]] = 0
    types = ((pos > 4) & (pos < valid[:, None])).astype(np.int32)
    labels = rs.randint(0, 2, B).astype(np.int32)
    losses = {}
    for pkg, model, nd, ag, gluon, kw in (
            ("jax", jm, nd_j, ag_j, gluon_j, {}),
            ("port", tm, nd_t, ag_t, gluon_t, {"ctx": CPU})):
        model.collect_params()[POS].grad_req = "null"
        trainer = gluon.Trainer(model.collect_params(), "adamw",
                                {"learning_rate": 5e-5, "wd": 0.01})
        arrays = [nd.array(a, **kw) for a in (ids, types, valid, labels)]
        ce = gluon.loss.SoftmaxCrossEntropyLoss()
        out = []
        for _ in range(3):
            with ag.record():
                loss = ce(model(*arrays[:3]), arrays[3]).mean()
            loss.backward()
            trainer.step(1)
            out.append(float(loss.asscalar()))
        losses[pkg] = out
    np.testing.assert_allclose(losses["port"], losses["jax"], **TOL)
    assert losses["jax"][1] > losses["jax"][0], losses
    assert losses["port"][1] > losses["port"][0], losses
