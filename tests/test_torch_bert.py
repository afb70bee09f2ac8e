"""PyTorch port, BERT pretraining model: the same weights and numpy
inputs through `mxnet_tpu.models.bert` and `mxnet_tpu_torch.models.bert`
on the CPU, float32, bert_tiny_config (dropout 0).

Weights are carried across with `weights.load_named_arrays` (the JAX
`collect_params()` paths, unchanged). Tolerances: scores and loss atol
2e-5 (float32; the two frameworks reduce in other orders); gradients
atol 1e-5 + rtol 1e-4 against the JAX eager tape (the backward sums a
few more products in another order). The JAX eager tape does not see
`bert.position_embed` (its `_positions` reads the raw array), so that
parameter's tape gradient is zero; every gradient is therefore also held
against `jax.grad` through the JAX package's `functional_call`, the
path its ShardedTrainer differentiates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, parallel
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.models import bert as bert_j
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel.trainer import call_loss

from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import bert as bert_t

_ATOL = 2e-5
_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")


@pytest.fixture(scope="module")
def pair():
    parallel.make_mesh(dp=-1)
    jm = bert_j.BERTForPretraining(bert_j.bert_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    yield jm, tm, arrays
    parallel.set_mesh(None)


def _batch(B=4, L=24, P=5, seed=3):
    b = bert_t.make_synthetic_batch(bert_t.bert_tiny_config(), B, L, P, seed)
    b["valid_length"] = np.array([L, L - 7, 9, L - 1][:B], np.int32)
    b["mlm_weights"][1, -2:] = 0.0
    return b


def _nd(a):
    return NDArray(jnp.asarray(a))


def _np(x):
    return np.asarray(x._data if isinstance(x, NDArray) else x)


def test_synthetic_batch_is_the_jax_packages():
    cfg = bert_t.bert_tiny_config()
    a = bert_t.make_synthetic_batch(cfg, 3, 16, 4, seed=7)
    b = bert_j.make_synthetic_batch(bert_j.bert_tiny_config(), 3, 16, 4, 7)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_param_names_are_the_jax_paths(pair):
    _, tm, arrays = pair
    names = set(tm.collect_params())
    assert names == set(arrays) and len(names) == 38
    for n in ("bert.layers.0.attention.qkv.weight",
              "bert.layers.0.attn_ln.gamma", "bert.position_embed",
              "bert.pooler.weight", "mlm_transform.weight", "mlm_ln.beta",
              "mlm_bias", "nsp.weight"):
        assert n in names
    # the decoder is tied to the word embedding: no weight of its own
    assert not any("decoder" in n for n in names)


def test_model_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert_t.BERTForPretraining(bert_t.bert_tiny_config())


def test_blocks_start_in_eval_mode(pair):
    _, tm, _ = pair
    assert not any(m.training for m in tm.modules())


def test_scores_and_loss_match(pair):
    jm, tm, _ = pair
    b = _batch()
    mlm_j, nsp_j = jm(*[_nd(b[k]) for k in _DATA])
    loss_j = bert_j.bert_pretrain_loss(mlm_j, nsp_j,
                                       *[_nd(b[k]) for k in _LABELS])
    mlm_t, nsp_t = tm(*[torch.from_numpy(b[k]) for k in _DATA])
    loss_t = bert_t.bert_pretrain_loss(
        mlm_t, nsp_t, *[torch.from_numpy(b[k]) for k in _LABELS])
    assert mlm_t.shape == (4, 5, 128) and nsp_t.shape == (4, 2)
    np.testing.assert_allclose(mlm_t.detach().numpy(), _np(mlm_j),
                               atol=_ATOL, rtol=_ATOL)
    np.testing.assert_allclose(nsp_t.detach().numpy(), _np(nsp_j),
                               atol=_ATOL, rtol=_ATOL)
    np.testing.assert_allclose(float(loss_t), float(_np(loss_j)),
                               atol=_ATOL, rtol=_ATOL)


def test_padding_past_valid_length_is_ignored(pair):
    _, tm, _ = pair
    b = _batch()
    ids = b["input_ids"].copy()
    ids[1, 24 - 7:] = 3                    # row 1 keeps 17 tokens
    args = [torch.from_numpy(b[k]) for k in _DATA]
    seq_a, _ = tm.bert(*args[:3])
    seq_b, _ = tm.bert(torch.from_numpy(ids), *args[1:3])
    np.testing.assert_allclose(seq_a[1, :17].detach().numpy(),
                               seq_b[1, :17].detach().numpy(), atol=1e-6)


def test_gradients_match_the_jax_tape(pair):
    jm, tm, arrays = pair
    b = _batch(seed=5)
    with autograd.record():
        mlm_j, nsp_j = jm(*[_nd(b[k]) for k in _DATA])
        loss_j = bert_j.bert_pretrain_loss(mlm_j, nsp_j,
                                           *[_nd(b[k]) for k in _LABELS])
    loss_j.backward()
    tape = {k: np.asarray(p.grad()._data)
            for k, p in jm.collect_params().items()}
    fn, gps, aux = functional_call(jm, train=True)
    rng = mx.random.next_key()

    def loss_of(ps):
        outs, _ = fn(ps, [p.data()._data for _, p in aux], rng,
                     *[jnp.asarray(b[k]) for k in _DATA])
        return call_loss(bert_j.bert_pretrain_loss, rng, outs,
                         [jnp.asarray(b[k]) for k in _LABELS])

    grads_j = dict(zip([n for n, _ in gps], [np.asarray(g) for g in jax.grad(
        loss_of)([p.data()._data for _, p in gps])]))
    assert set(grads_j) == set(tape)

    from mxnet_tpu_torch.parallel import FusedLamb
    names = sorted(arrays)
    params = tm.collect_params()
    fl = FusedLamb([params[n].shape for n in names],
                   [params[n].dtype for n in names], [0.0] * len(names),
                   0.9, 0.999, 1e-6, True, 1.0, -1.0, -1.0, -1.0)
    master = fl.flatten([params[n] for n in names]).requires_grad_(True)
    views = dict(zip(names, fl.unflatten(master)))
    mlm_t, nsp_t = torch.func.functional_call(
        tm, views, tuple(torch.from_numpy(b[k]) for k in _DATA))
    loss_t = bert_t.bert_pretrain_loss(
        mlm_t, nsp_t, *[torch.from_numpy(b[k]) for k in _LABELS])
    grad, = torch.autograd.grad(loss_t, master)
    np.testing.assert_allclose(float(loss_t.detach()), float(_np(loss_j)),
                               atol=_ATOL)
    assert grad.shape == (fl.total,) and grad.dtype == torch.float32
    for name, g in zip(names, fl.unflatten_master(grad)):
        assert np.abs(grads_j[name]).max() > 0, name
        np.testing.assert_allclose(g.numpy(), grads_j[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
        if name != "bert.position_embed":
            np.testing.assert_allclose(g.numpy(), tape[name], atol=1e-5,
                                       rtol=1e-4, err_msg=name)
    # the padding of the flat gradient stays zero
    mask = torch.ones(fl.total, dtype=torch.bool)
    for off, n in zip(fl.offsets[:-1], fl.sizes):
        mask[off:off + n] = False
    assert float(grad[mask].abs().max()) == 0.0
