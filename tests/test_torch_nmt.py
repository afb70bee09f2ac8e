"""PyTorch port, the Sockeye Transformer NMT (`models.transformer`)
against the JAX package's on the CPU: a tiny model (units 32, hidden 64,
2 + 2 layers, 4 heads, vocabularies 50 and 60, dropout 0) whose weights
are carried by name from `mxnet_tpu.models.transformer.TransformerNMT`.

Tolerances (float32): logits 2e-5 and the smoothed loss 1e-6 (the two
frameworks sum in other orders). Three eager Adam steps (`autograd.
record()`, `label_smoothing_loss`, `backward()`, `gluon.Trainer(...,
"adam").step(1)`): losses 2e-5 and parameters 1e-4, the Adam
tolerances of `test_torch_gpt_train.py` (the step divides the gradient
by its own magnitude, so float32 noise in a near-zero gradient passes
on; the steps run at epsilon 1e-6, see
`test_eager_adam_steps_match_jax`). Greedy and beam-4 tokens equal;
beam scores within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mxj
from mxnet_tpu import nd as ndj
from mxnet_tpu import optimizer as optj
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.models import transformer as nmt_j
from mxnet_tpu.parallel.trainer import call_loss

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import gluon as gt
from mxnet_tpu_torch import nd, weights
from mxnet_tpu_torch.models import transformer as nmt_t

CPU = mxt.cpu()
_KW = dict(src_vocab=50, tgt_vocab=60, units=32, hidden_size=64,
           num_layers=2, num_heads=4, max_length=32, dropout=0.0)


def _jax_model(**kw):
    mxj.random.seed(0)
    jm = nmt_j.TransformerNMT(**dict(_KW, **kw))
    jm.initialize()
    return jm, {k: np.asarray(p.data()._data)
                for k, p in jm.collect_params().items()}


def _port_model(arrays, **kw):
    return weights.load_named_arrays(
        nmt_t.TransformerNMT(**dict(_KW, **kw), device="cpu"), arrays)


@pytest.fixture(scope="module")
def pair():
    jm, arrays = _jax_model()
    return jm, _port_model(arrays), arrays


def _batch(B=3, Ls=10, Lt=12, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 50, (B, Ls)).astype(np.int32)
    tgt = rng.randint(3, 60, (B, Lt)).astype(np.int32)
    valid = np.array([Ls, 7, 4][:B], np.float32)
    tgt[2, 8:] = 0                                  # padded labels
    return src, tgt, valid


def _j(*arrays):
    return [ndj.array(a) for a in arrays]


def _t(*arrays):
    return [nd.array(a, ctx=CPU) for a in arrays]


def test_parameter_paths_and_logits_match(pair):
    jm, tm, arrays = pair
    assert set(tm.collect_params()) == set(arrays)
    assert tm.collect_params()["pos_enc"].grad_req == "null"
    src, tgt, valid = _batch()
    ref = jm(*_j(src, tgt, valid)).asnumpy()
    tm.hybridize()
    got = tm(*_t(src, tgt, valid))
    assert isinstance(got, nd.NDArray) and got.shape == (3, 12, 60)
    np.testing.assert_allclose(got.asnumpy(), ref, rtol=2e-5, atol=2e-5)
    ref = jm(*_j(src, tgt)).asnumpy()
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-5,
                               atol=2e-5)


def test_label_smoothing_loss_matches():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 5, 60).astype(np.float32)
    labels = rng.randint(0, 60, (3, 5)).astype(np.int32)
    labels[0, 3:] = 0
    for kw in ({}, {"smoothing": 0.0}, {"smoothing": 0.2, "pad_id": 7}):
        ref = nmt_j.label_smoothing_loss(*_j(logits, labels), **kw)
        got = nmt_t.label_smoothing_loss(*_t(logits, labels), **kw)
        assert isinstance(got, nd.NDArray) and got.shape == ()
        np.testing.assert_allclose(got.asscalar(), ref.asscalar(),
                                   rtol=1e-6)
    plain = nmt_t.label_smoothing_loss(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    assert isinstance(plain, torch.Tensor)


def test_decoder_is_causal():
    """tests/unittest/test_models.py::test_nmt_causal_decoder on the
    port: future target tokens cannot change past logits."""
    m = nmt_t.TransformerNMT(src_vocab=30, tgt_vocab=30, units=16,
                             hidden_size=32, num_layers=1, num_heads=2,
                             max_length=16, dropout=0.0, device="cpu")
    m.initialize()
    rng = np.random.RandomState(2)
    src = nd.array(rng.randint(3, 30, (1, 6)), ctx=CPU)
    tgt1 = rng.randint(3, 30, (1, 8)).astype(np.int32)
    tgt2 = tgt1.copy()
    tgt2[:, 5:] = 7
    l1 = m(src, nd.array(tgt1, ctx=CPU)).asnumpy()
    l2 = m(src, nd.array(tgt2, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(l1[:, :5], l2[:, :5], rtol=1e-4, atol=1e-4)
    assert not np.allclose(l1[:, 5:], l2[:, 5:])


def _train(model, trainer, loss_fn, ag, arrays, steps):
    losses = []
    for _ in range(steps):
        src, tgt_in, valid, tgt_out = arrays
        with ag.record():
            loss = loss_fn(model(src, tgt_in, valid), tgt_out)
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    return losses


def _copy_batch(B=4, Ls=8, seed=3):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 50, (B, Ls)).astype(np.int32)
    valid = np.array([Ls, 5, 8, 3][:B], np.float32)
    src[np.arange(Ls)[None, :] >= valid[:, None]] = 0
    tgt_in = np.concatenate([np.ones((B, 1), np.int32), src], 1)
    tgt_out = np.concatenate([src, np.zeros((B, 1), np.int32)], 1)
    tgt_out[np.arange(B), valid.astype(int)] = 2
    return src, tgt_in, valid, tgt_out


def _jax_adam_steps(jm, batch, opts, steps):
    """The JAX package's side of the eager steps: the gradient by
    `jax.grad` through its `functional_call` (its eager tape gives the
    same gradient, an order of magnitude slower), then its
    `optimizer.Adam.update` for every parameter, as its `gluon.Trainer`
    runs it after `step(1)`. Returns the losses."""
    fn, gps, aux = functional_call(jm, train=True)
    rng = mxj.random.next_key()
    data = [jnp.asarray(x) for x in batch[:3]]
    labels = [jnp.asarray(batch[3])]

    def loss_of(ps):
        outs, _ = fn(ps, [p.data()._data for _, p in aux], rng, *data)
        return call_loss(nmt_j.label_smoothing_loss, rng, outs, labels)

    value_and_grad = jax.jit(jax.value_and_grad(loss_of))
    opt = optj.create("adam", **opts)
    opt.rescale_grad = 1.0
    states = [opt.create_state(i, p.data()) for i, (_, p) in enumerate(gps)]
    losses = []
    for _ in range(steps):
        loss, grads = value_and_grad([p.data()._data for _, p in gps])
        for i, ((_, p), g) in enumerate(zip(gps, grads)):
            opt.update(i, p.data(), ndj.array(g), states[i])
        losses.append(float(loss))
    return losses


def test_eager_adam_steps_match_jax():
    """Three steps of the MXNet loop on the port against the JAX
    package's Adam on its own gradients, at epsilon 1e-6: the key
    projections' biases have a gradient that is zero in exact
    arithmetic (they shift every score of a row alike), and at epsilon
    1e-8 or below Adam would move them by float32 noise normalised to
    about lr a step, differently in each package."""
    jm, arrays = _jax_model()
    tm = _port_model(arrays)
    opts = {"learning_rate": 1e-3, "beta2": 0.98, "epsilon": 1e-6}
    batch = _copy_batch()
    lj = _jax_adam_steps(jm, batch, opts, 3)
    trainer = gt.Trainer(tm.collect_params(), "adam", dict(opts))
    lt = _train(tm, trainer, nmt_t.label_smoothing_loss, agt, _t(*batch), 3)
    np.testing.assert_allclose(lt, lj, atol=2e-5)
    assert lt[-1] < lt[0]
    assert len(trainer._params) == len(arrays) - 1     # all but pos_enc
    for k, p in tm.collect_params().items():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(jm.collect_params()[k].data()
                                           ._data), atol=1e-4, err_msg=k)


def test_greedy_and_beam_search_match_jax(pair):
    jm, tm, _ = pair
    src, _, valid = _batch(seed=4)
    for v in (None, valid):
        vj = None if v is None else ndj.array(v)
        ref = jm.greedy_decode(ndj.array(src), max_len=8, src_valid=vj)
        got = tm.greedy_decode(nd.array(src, ctx=CPU), max_len=8,
                               src_valid=v)
        np.testing.assert_array_equal(got, ref)
    bj, sj = jm.beam_search(ndj.array(src), beam=4, max_len=8,
                            src_valid=ndj.array(valid), return_scores=True)
    bt, st = tm.beam_search(src, beam=4, max_len=8, src_valid=valid,
                            return_scores=True)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_allclose(st, sj, atol=1e-5)
    b1 = tm.beam_search(src, beam=1, max_len=8, src_valid=valid)
    np.testing.assert_array_equal(
        b1, tm.greedy_decode(src, max_len=8, src_valid=valid))


def test_decode_sees_updated_weights():
    """tests/train/test_decode.py::test_decode_sees_updated_weights on
    the port: decode, train eagerly, decode again: the tokens follow the
    new weights (those of a fresh model loaded with them), and the
    decode built no autograd graph."""
    m = _port_model(_jax_model()[1])
    src, tgt_in, valid, tgt_out = _copy_batch(seed=5)
    out1 = m.greedy_decode(src, max_len=10, src_valid=valid)
    tr = gt.Trainer(m.collect_params(), "adam", {"learning_rate": 3e-2})
    _train(m, tr, nmt_t.label_smoothing_loss, agt,
           _t(src, tgt_in, valid, tgt_out), 8)
    out2 = m.greedy_decode(src, max_len=10, src_valid=valid)
    fresh = _port_model({k: p.detach().numpy() for k, p in
                         m.collect_params().items()})
    np.testing.assert_array_equal(
        out2, fresh.greedy_decode(src, max_len=10, src_valid=valid))
    assert not np.array_equal(out1, out2)
    enc, _ = m.encode(torch.from_numpy(src))
    assert enc.requires_grad            # trained eagerly: a forward records
    modes = []
    m.encoder[0].register_forward_hook(
        lambda *_: modes.append(torch.is_grad_enabled()))
    m.greedy_decode(src, max_len=3)
    m.beam_search(src, beam=2, max_len=3)
    assert modes == [False, False]      # the decode entry points do not


def test_bf16_dtype_gives_float32_logits_as_in_jax():
    """dtype='bfloat16' builds bf16 Dense and Embedding weights; the
    float32 positional encoding promotes the embeddings, so every layer
    after it (Dense, LayerNorm, residual) runs in float32 and the logits
    are float32 in both packages. Cast after building, the model is bf16
    through and through."""
    jm, arrays = _jax_model(dtype="bfloat16")
    tm = _port_model(arrays, dtype="bfloat16")
    assert tm.collect_params()["src_embed.weight"].dtype == torch.bfloat16
    assert tm.collect_params()["encoder.0.self_ln.gamma"].dtype == \
        torch.float32
    src, tgt, valid = _batch()
    ref = jm(*_j(src, tgt, valid))
    got = tm(*_t(src, tgt, valid))
    assert ref.dtype == got.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), rtol=2e-5,
                               atol=2e-5)
    pairs = [(jm.src_embed(ndj.array(src)), tm.src_embed(
        torch.from_numpy(src))),
             (jm._embed(jm.src_embed, ndj.array(src)),
              tm._embed(tm.src_embed, torch.from_numpy(src)))]
    x_j, x_t = pairs[-1]
    pairs.append((jm.encoder[0](x_j), tm.encoder[0](x_t)))
    pairs.append((jm.encoder[0].self_ln(pairs[0][0]),
                  tm.encoder[0].self_ln(pairs[0][1])))
    for a, b in pairs:
        assert str(b.dtype).replace("torch.", "") == str(a.dtype)
    jm.cast("bfloat16")
    tm.cast("bfloat16")
    assert jm(*_j(src, tgt, valid)).dtype.name == "bfloat16"
    assert tm(*_t(src, tgt, valid)).dtype.name == "bfloat16"
