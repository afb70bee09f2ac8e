"""PyTorch port, the optimizer ops by MXNet name and the seventeen
optimizers against the JAX package on the CPU, from the same seeded
numpy inputs.

* Each of the 23 registrations of `ops/optimizer_ops.py`, called as
  `nd.<name>` on both packages: every output within 1e-6 (relative and
  absolute, float32); the `out=` form writes into the given NDArray.
* Each optimizer by name: 3 `update`s through NDArrays from the same
  weight and gradients, weight and state within 1e-6 of the JAX
  package's (SGLD draws noise from another stream, so it is held as
  `test_sgld_samples_around_mode` holds it: stable, near the mode, and
  stochastic). LAMB's update runs on the port's LAMB passes in
  `FusedLamb`'s flat layout (their plain versions here).
* A 2-layer BERT trained eagerly with `gluon.Trainer(..., "lamb")`
  (`autograd.record()`, `backward`, `step`) for 3 steps against the JAX
  package's eager loop: losses and parameters within 1e-5. The position
  embedding is frozen on both sides: the JAX package's eager forward
  reads it outside its tape (`mxnet_tpu/models/bert.py:277`), so its
  gradient there is zero, while the port's is the true one (ROADMAP.md,
  "The oracle is red"); the test writes that down too.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import optimizer as opt_j
from mxnet_tpu.models import bert as bert_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import optimizer as opt_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.cuda_ops import fused_update
from mxnet_tpu_torch.models import bert as bert_t

CPU = mxt.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


def _arrays(n, shape=(5, 4), seed=0, positive=()):
    rng = np.random.RandomState(seed)
    out = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    for i in positive:
        out[i] = np.abs(out[i]) + 0.1
    return out


# name -> (array inputs, indices made positive, keyword arguments)
OPS = {
    "sgd_update": (2, (), dict(lr=0.1, wd=0.01, clip_gradient=0.5)),
    "sgd_mom_update": (3, (), dict(lr=0.1, momentum=0.9, wd=0.01)),
    "nag_mom_update": (3, (), dict(lr=0.1, momentum=0.9, rescale_grad=0.5)),
    "adam_update": (4, (3,), dict(lr=0.01, wd=0.01, clip_gradient=1.0)),
    "adamw_update": (4, (3,), dict(lr=0.01, eta=0.5, wd=0.1)),
    "rmsprop_update": (3, (2,), dict(lr=0.01, gamma1=0.9, clip_weights=0.8)),
    "rmspropalex_update": (5, (2,), dict(lr=0.01, gamma1=0.9, gamma2=0.8)),
    "ftrl_update": (4, (3,), dict(lr=0.1, lamda1=0.01, wd=0.01)),
    "signsgd_update": (2, (), dict(lr=0.1, wd=0.01)),
    "signum_update": (3, (), dict(lr=0.1, momentum=0.9, wd_lh=0.01)),
    "lamb_update_phase1": (4, (3,), dict(t=3, wd=0.01)),
    "lamb_update": (4, (3,), dict(lr=0.01, t=2, wd=0.01, upper_bound=5.0)),
    "adagrad_update": (3, (2,), dict(lr=0.1, wd=0.01)),
    "mp_sgd_update": (3, (), dict(lr=0.1, wd=0.01)),
    "mp_sgd_mom_update": (4, (), dict(lr=0.1, momentum=0.9, wd=0.01)),
    "multi_sum_sq": (3, (), {}),
    "multi_sgd_update": (4, (), dict(lrs=(0.1, 0.2), wds=(0.0, 0.01))),
    "multi_sgd_mom_update": (6, (), dict(momentum=0.9, lrs=(0.1, 0.2),
                                         wds=(0.01, 0.0))),
    "multi_mp_sgd_update": (6, (), dict(lrs=(0.1, 0.2), wds=(0.01, 0.0))),
    "multi_mp_sgd_mom_update": (8, (), dict(momentum=0.9, lrs=(0.1, 0.2),
                                            wds=(0.0, 0.01))),
    "all_finite": (1, (), {}),
    "multi_all_finite": (3, (), {}),
}


def _outs(res):
    return [r.asnumpy() for r in (res if isinstance(res, (tuple, list))
                                  else (res,))]


@pytest.mark.parametrize("name", list(OPS))
def test_optimizer_op_by_name(name):
    n, positive, kw = OPS[name]
    ins = _arrays(n, positive=positive)
    got = _outs(getattr(nd_t, name)(*[nd_t.array(a, ctx=CPU) for a in ins],
                                    **kw))
    ref = _outs(getattr(nd_j, name)(*[nd_j.array(a) for a in ins], **kw))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, **TOL)


def test_lamb_phase2_and_finite_probes():
    w, u = _arrays(2, seed=1)
    for r1, r2 in ((2.0, 3.0), (0.0, 3.0), (2.0, 0.0)):
        args = (w, u, np.float32(r1), np.float32(r2))
        got = nd_t.lamb_update_phase2(*[nd_t.array(a, ctx=CPU)
                                        for a in args], lr=0.1,
                                      lower_bound=0.5)
        ref = nd_j.lamb_update_phase2(*[nd_j.array(a) for a in args],
                                      lr=0.1, lower_bound=0.5)
        np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **TOL)
    bad = np.array([1.0, np.nan], np.float32)
    assert nd_t.all_finite(nd_t.array(bad, ctx=CPU)).asscalar() == 0.0
    assert nd_t.multi_all_finite(nd_t.array(w, ctx=CPU),
                                 nd_t.array(bad, ctx=CPU)).asscalar() == 0.0


def test_out_writes_in_place_and_sym_reaches_the_ops():
    w, g = _arrays(2, seed=2)
    weight = nd_t.array(w, ctx=CPU)
    res = nd_t.sgd_update(weight, nd_t.array(g, ctx=CPU), lr=0.1,
                          out=weight)
    assert res is weight
    np.testing.assert_allclose(weight.asnumpy(), w - 0.1 * g, **TOL)
    from mxnet_tpu_torch import symbol as sym_t
    s = sym_t.sgd_update(sym_t.var("w"), sym_t.var("g"), lr=0.1)
    ex = s.bind(CPU, {"w": nd_t.array(w, ctx=CPU),
                      "g": nd_t.array(g, ctx=CPU)})
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), w - 0.1 * g, **TOL)


# -- the optimizers -----------------------------------------------------------

OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("nag", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adamw", dict(learning_rate=0.01, wd=0.1)),
    ("lamb", dict(learning_rate=0.01, wd=0.01, upper_bound=10.0)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, clip_gradient=1.0)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("ftrl", dict(learning_rate=0.1, wd=0.01)),
    ("signum", dict(learning_rate=0.01, wd_lh=0.01)),
    ("signsgd", dict(learning_rate=0.01)),
    ("lars", dict(learning_rate=0.1, wd=0.01)),
    ("adamax", dict(learning_rate=0.01)),
    ("nadam", dict(learning_rate=0.01, wd=0.01)),
    ("adadelta", dict(rho=0.9, epsilon=1e-4)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
    ("ftml", dict(learning_rate=0.05)),
]


def _three_updates(optm, nd, arr, name, kw, w, gs):
    o = optm.create(name, **kw)
    weight = arr(w)
    state = o.create_state(0, weight)
    for g in gs:
        o.update(0, weight, arr(g), state)
    parts = state if isinstance(state, tuple) else (state,)
    for s in parts:
        assert s is None or isinstance(s, nd.NDArray)
    return o, weight.asnumpy(), [s.asnumpy() for s in parts if s is not None]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_three_updates_like_jax(name, kw):
    rng = np.random.RandomState(3)
    w = rng.randn(6, 5).astype(np.float32)
    gs = [rng.randn(6, 5).astype(np.float32) for _ in range(3)]
    ot, wt, st = _three_updates(opt_t, nd_t, lambda v: nd_t.array(v, ctx=CPU),
                                name, kw, w, gs)
    oj, wj, sj = _three_updates(opt_j, nd_j, nd_j.array, name, kw, w, gs)
    assert type(ot).__name__ == type(oj).__name__
    np.testing.assert_allclose(wt, wj, **TOL)
    assert len(st) == len(sj)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a, b, **TOL)
    assert not np.allclose(wt, w)


@pytest.mark.parametrize("name", sorted(
    {n for n, _ in OPTIMIZERS} | {"sgld"}))
def test_optimizer_defaults_are_jax(name):
    ot, oj = opt_t.create(name), opt_j.create(name)
    assert type(ot).__name__ == type(oj).__name__
    skip = {"param_dict", "idx2name", "lr_scheduler", "_m_schedule",
            "_flat", "_index_update_count", "lr_mult", "wd_mult"}
    vt = {k: v for k, v in vars(ot).items() if k not in skip}
    vj = {k: v for k, v in vars(oj).items() if k not in skip}
    vj.pop("lazy_update", None)
    assert vt == vj


def test_sgld_samples_around_mode():
    mxt.random.seed(0, "cpu")
    target = np.array([1.0, -2.0], np.float32)
    w = nd_t.array(np.zeros(2, np.float32), ctx=CPU)
    o = opt_t.create("sgld", learning_rate=0.05)
    samples = []
    for step in range(400):
        o.update(0, w, nd_t.array(w.asnumpy() - target, ctx=CPU), None)
        if step > 200:
            samples.append(w.asnumpy().copy())
    samples = np.asarray(samples)
    assert np.abs(samples - target).max() < 5.0
    assert np.std(samples, axis=0).min() > 0.01
    assert np.isfinite(samples).all()


def test_lamb_update_multi_is_two_pass_calls_a_step(monkeypatch):
    """One group of parameters with one update count: one call of each
    LAMB pass for the whole list; the states hold views of the flat
    moments; a state given as tensors gets the new moments back."""
    calls = {"p1": 0, "p2": 0}
    p1, p2 = fused_update.lamb_pass1, fused_update.lamb_pass2

    def c1(*a, **k):
        calls["p1"] += 1
        return p1(*a, **k)

    def c2(*a, **k):
        calls["p2"] += 1
        return p2(*a, **k)
    monkeypatch.setattr(fused_update, "lamb_pass1", c1)
    monkeypatch.setattr(fused_update, "lamb_pass2", c2)
    rng = np.random.RandomState(4)
    shapes = [(7, 3), (600,), (2, 2, 2)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    o = opt_t.create("lamb", learning_rate=0.01, wd=0.01)
    oj = opt_j.create("lamb", learning_rate=0.01, wd=0.01)
    wt = [nd_t.array(w, ctx=CPU) for w in ws]
    wj = [nd_j.array(w) for w in ws]
    st = [o.create_state(i, w) for i, w in enumerate(wt)]
    sj = [oj.create_state(i, w) for i, w in enumerate(wj)]
    for _ in range(2):
        o.update_multi(list(range(3)), wt,
                       [nd_t.array(g, ctx=CPU) for g in gs], st)
        for i in range(3):
            oj.update(i, wj[i], nd_j.array(gs[i]), sj[i])
    assert calls == {"p1": 2, "p2": 2}
    for a, b, sa, sb in zip(wt, wj, st, sj):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
        for x, y in zip(sa, sb):
            np.testing.assert_allclose(x.asnumpy(), y.asnumpy(), **TOL)
    flat = next(iter(o._flat.values()))
    assert st[1][0]._t.data_ptr() == flat.m_views[1].data_ptr()
    # tensors in place of NDArrays: updated in place, moments copied back
    w0, g0 = torch.tensor(ws[0]), torch.tensor(gs[0])
    m0, v0 = torch.zeros(7, 3), torch.zeros(7, 3)
    o2 = opt_t.create("lamb", learning_rate=0.01)
    o2.update(0, w0, g0, (m0, v0))
    assert m0.abs().sum() > 0 and not torch.equal(w0, torch.tensor(ws[0]))


# -- eager BERT with gluon.Trainer(..., "lamb") --------------------------------

_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")


def test_eager_bert_lamb_trainer_matches_jax():
    cfg_j = bert_j.bert_tiny_config()
    jm = bert_j.BERTForPretraining(cfg_j)
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    b = bert_j.make_synthetic_batch(cfg_j, 4, 16, 3, seed=1)
    b["valid_length"][::2] = 11
    opt = {"learning_rate": 1e-3, "wd": 0.01}
    pos = "bert.position_embed"
    jm.collect_params()[pos].grad_req = "null"
    tr_j = gluon_j.Trainer(jm.collect_params(), "lamb", dict(opt))
    jl = []
    for _ in range(3):
        with ag_j.record():
            mlm, nsp = jm(*[nd_j.array(b[k]) for k in _DATA])
            loss = bert_j.bert_pretrain_loss(
                mlm, nsp, *[nd_j.array(b[k]) for k in _LABELS])
        loss.backward()
        tr_j.step(1)
        jl.append(float(loss.asscalar()))

    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    tm.collect_params()[pos].grad_req = "null"
    tr_t = gluon_t.Trainer(tm.collect_params(), "lamb", dict(opt))
    tl = []
    for _ in range(3):
        with ag_t.record():
            mlm, nsp = tm(*[nd_t.array(b[k], ctx=CPU) for k in _DATA])
            loss = bert_t.bert_pretrain_loss(
                mlm, nsp, *[nd_t.array(b[k], ctx=CPU) for k in _LABELS])
        loss.backward()
        tr_t.step(1)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert tl[-1] < tl[0]
    got = {k: p.detach().numpy() for k, p in tm.collect_params().items()}
    want = {k: p.data().asnumpy() for k, p in jm.collect_params().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_eager_bert_position_embedding_gradient_differs_from_jax():
    """What the freeze above stands for: with the position embedding
    trainable, the JAX package's eager gradient of it is zero and the
    port's is not (the other gradients agree within 1e-5)."""
    cfg_j = bert_j.bert_tiny_config()
    jm = bert_j.BERTForPretraining(cfg_j)
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    b = bert_j.make_synthetic_batch(cfg_j, 2, 8, 2, seed=1)
    for p in jm.collect_params().values():
        p.zero_grad()
    with ag_j.record():
        mlm, nsp = jm(*[nd_j.array(b[k]) for k in _DATA])
        loss = bert_j.bert_pretrain_loss(
            mlm, nsp, *[nd_j.array(b[k]) for k in _LABELS])
    loss.backward()
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    with ag_t.record():
        mlm, nsp = tm(*[nd_t.array(b[k], ctx=CPU) for k in _DATA])
        loss = bert_t.bert_pretrain_loss(
            mlm, nsp, *[nd_t.array(b[k], ctx=CPU) for k in _LABELS])
    loss.backward()
    pos = "bert.position_embed"
    gj = jm.collect_params()[pos].grad().asnumpy()
    gt = tm.collect_params()[pos].grad.numpy()
    assert not gj.any() and np.abs(gt[:8]).max() > 1e-3
    assert not gt[8:].any()
    for k, p in tm.collect_params().items():
        if k != pos:
            np.testing.assert_allclose(
                p.grad.numpy(), jm.collect_params()[k].grad().asnumpy(),
                rtol=1e-5, atol=1e-5, err_msg=k)
