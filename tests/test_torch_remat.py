"""PyTorch port, per-layer remat: `bert_large_config` and
`gpt2_345m_config` (remat on, scan_layers on) at tiny widths.

Against the JAX package (its scan + remat path, differentiated with
`jax.grad` through its `functional_call`, the path its ShardedTrainer
takes), float32, dropout 0, from the same weights: loss atol 2e-5,
gradients atol 1e-5 + rtol 1e-4 (the two frameworks reduce in other
orders), and the same `collect_params()` paths.

Within the port, dropout 0.1 on hidden states and attention: a step with
remat and a step without, from the same weights and the same seed, give
the same loss and the same gradients bit for bit on the CPU, and leave
the random streams in the same state, so the next step draws the same
masks (its loss and gradients are equal bit for bit too). This holds
only because the recomputation replays the streams
(`random.get_state` / `set_state` in `models._remat.remat_call`).
"""
import numpy as np
import pytest
import torch
from torch.func import functional_call as t_functional_call

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.models import bert as bert_j
from mxnet_tpu.models import gpt as gpt_j
from mxnet_tpu.parallel.trainer import call_loss

from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import _remat
from mxnet_tpu_torch.models import bert as bert_t
from mxnet_tpu_torch.models import gpt as gpt_t

_TINY = dict(vocab_size=128, units=64, hidden_size=128, num_layers=3,
             num_heads=4, max_length=64)
_BERT_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_BERT_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")
_GPT_DATA = ("input_ids", "valid_length")
_GPT_LABELS = ("labels", "weights")

_FAMILIES = {
    "bert": (bert_j, bert_t, "bert_large_config", "BERTForPretraining",
             "bert_pretrain_loss", _BERT_DATA, _BERT_LABELS),
    "gpt": (gpt_j, gpt_t, "gpt2_345m_config", "GPTForCausalLM",
            "gpt_lm_loss", _GPT_DATA, _GPT_LABELS),
}


def _batch(family):
    _, t_mod, config = _FAMILIES[family][:3]
    cfg = getattr(t_mod, config)(**_TINY)
    if family == "bert":
        b = t_mod.make_synthetic_batch(cfg, 4, 32, 5, seed=3)
        b["valid_length"][1] = 25
    else:
        b = t_mod.make_synthetic_batch(cfg, 4, 32, seed=3)
        b["valid_length"][1] = 25
        b["weights"][1, 25:] = 0.0
    return b


@pytest.fixture(scope="module", params=sorted(_FAMILIES))
def pair(request):
    family = request.param
    j_mod, t_mod, config, cls = _FAMILIES[family][:4]
    parallel.make_mesh(dp=-1)
    jm = getattr(j_mod, cls)(getattr(j_mod, config)(dropout=0.0, **_TINY))
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    yield family, jm, arrays
    parallel.set_mesh(None)


def _port(family, arrays, **overrides):
    _, t_mod, config, cls = _FAMILIES[family][:4]
    cfg = getattr(t_mod, config)(**dict(_TINY, **overrides))
    tm = getattr(t_mod, cls)(cfg, device="cpu")
    weights.load_named_arrays(tm, arrays)
    return tm


def _port_loss_and_grads(family, tm, b):
    """The float32 loss of a training-mode forward and its gradient for
    every parameter (by name)."""
    _, t_mod, _, _, loss_name, data, labels = _FAMILIES[family]
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in tm.collect_params().items()}
    tm.train()
    try:
        outs = t_functional_call(tm, leaves, tuple(torch.from_numpy(b[k])
                                                   for k in data))
    finally:
        tm.eval()
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = getattr(t_mod, loss_name)(*outs, *[torch.from_numpy(b[k])
                                              for k in labels])
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def test_configs_are_the_jax_packages():
    for family in _FAMILIES:
        j_mod, t_mod, config = _FAMILIES[family][:3]
        got, ref = getattr(t_mod, config)(), getattr(j_mod, config)()
        assert got == ref, family
        assert got["remat"] is True and got["scan_layers"] is True


def test_parameter_paths_are_the_jax_scan_paths(pair):
    family, jm, arrays = pair
    tm = _port(family, arrays)
    assert set(tm.collect_params()) == set(jm.collect_params()) \
        == set(arrays)
    assert any(".layers.2." in n for n in arrays)


def test_remat_loss_and_gradients_match_jax(pair, monkeypatch):
    family, jm, arrays = pair
    j_mod, t_mod, _, _, loss_name, data, labels = _FAMILIES[family]
    b = _batch(family)
    fn, gps, aux = functional_call(jm, train=True)
    rng = mx.random.next_key()

    def loss_of(ps):
        outs, _ = fn(ps, [p.data()._data for _, p in aux], rng,
                     *[jnp.asarray(b[k]) for k in data])
        return call_loss(getattr(j_mod, loss_name), rng, outs,
                         [jnp.asarray(b[k]) for k in labels])

    loss_j, grads_j = jax.value_and_grad(loss_of)(
        [p.data()._data for _, p in gps])
    grads_j = dict(zip([n for n, _ in gps], grads_j))

    calls = []
    remat_call = _remat.remat_call
    monkeypatch.setattr(_remat, "remat_call",
                        lambda *a: calls.append(1) or remat_call(*a))
    tm = _port(family, arrays, dropout=0.0)
    loss_t, grads_t = _port_loss_and_grads(family, tm, b)
    assert len(calls) == _TINY["num_layers"]          # every layer remat
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=2e-5,
                               rtol=0)
    assert set(grads_t) == set(grads_j)
    for name, g in grads_t.items():
        assert np.abs(np.asarray(grads_j[name])).max() > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_j[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def _same_state(a, b):
    return a[0] == b[0] and torch.equal(a[1], b[1]) and set(a[2]) == \
        set(b[2]) and all(torch.equal(a[2][k], b[2][k]) for k in a[2])


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_remat_with_dropout_is_bit_equal_to_no_remat(family):
    # weights from the port's own initialisation, carried to both models
    _, t_mod, config, cls = _FAMILIES[family][:4]
    init = getattr(t_mod, cls)(getattr(t_mod, config)(**_TINY),
                               device="cpu")
    init.initialize(generator=mxrandom.seed(0, "cpu"))
    arrays = {k: p.detach().numpy().copy()
              for k, p in init.collect_params().items()}
    b = _batch(family)
    runs = {}
    for remat in (False, True):
        tm = _port(family, arrays, dropout=0.1, attn_dropout=0.1,
                   remat=remat)
        mxrandom.seed(11, "cpu")
        steps = []
        for _ in range(2):
            loss, grads = _port_loss_and_grads(family, tm, b)
            steps.append((loss, grads, mxrandom.get_state()))
        runs[remat] = steps
    for i, ((l0, g0, s0), (l1, g1, s1)) in enumerate(zip(runs[False],
                                                         runs[True])):
        assert torch.equal(l0, l1), (i, float(l0), float(l1))
        assert set(g0) == set(g1)
        for name in g0:
            assert torch.equal(g0[name], g1[name]), (i, name)
        assert _same_state(s0, s1), i
    # dropout was on: the two steps drew different masks
    assert not torch.equal(runs[True][0][0], runs[True][1][0])


def test_remat_is_off_outside_autograd(pair, monkeypatch):
    """A forward that records no gradient (serving, the probe pass) runs
    the layers plainly, as the JAX package remats only inside a trace."""
    family, _, arrays = pair
    calls = []
    monkeypatch.setattr(_remat, "remat_call",
                        lambda *a: calls.append(1))
    tm = _port(family, arrays, dropout=0.0)
    b = _batch(family)
    with torch.no_grad():
        tm(*[torch.from_numpy(b[k]) for k in _FAMILIES[family][5]])
    assert calls == []
