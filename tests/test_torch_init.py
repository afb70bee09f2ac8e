"""PyTorch port, parameter initialisation against `mxnet_tpu` on the CPU.

The same layers are built in both packages and initialised the same way;
the port must give what the JAX package gives:
  * the name rule of `Initializer.init_array`: whatever the initializer,
    names ending in bias, beta, running_mean or moving_mean hold zeros
    and names ending in gamma, running_var or moving_var hold ones;
  * a second `initialize()` leaves initialised parameters alone (loaded
    weights count as initialised), and `force_reinit=True` refills them;
  * `random.seed(s)` governs an `initialize()` that names no generator,
    so seed 1, seed 2, then seed 1 again repeats the first draw.
The two packages' random streams differ by design, so the draws are
compared for repetition, not for value; zeros and ones are compared
exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import initializer as init_j
from mxnet_tpu.gluon import nn as nn_j

from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import initializer as init_t
from mxnet_tpu_torch import random as random_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.gluon import nn as nn_t

_STATS = ("running_mean", "running_var", "moving_mean", "moving_var")


class _StatsJ(gluon_j.Block):
    """Parameters named as a BatchNorm's statistics, built directly."""

    def __init__(self):
        super().__init__()
        for name in _STATS:
            setattr(self, name, gluon_j.Parameter(name, shape=(4,)))
        self.weight = gluon_j.Parameter("weight", shape=(4, 4))


class _StatsT(gluon_t.Block):
    def __init__(self):
        super().__init__()
        for name in _STATS:
            setattr(self, name, gluon_t.Parameter(name, (4,)))
        self.weight = gluon_t.Parameter("weight", (4, 4))


def _layers(nn, stats):
    return {"dense": nn.Dense(4, in_units=3),
            "norm": nn.LayerNorm(in_channels=4), "stats": stats()}


def _values(package, block):
    if package == "jax":
        return {k: np.asarray(p.data()._data)
                for k, p in block.collect_params().items()}
    return {k: p.detach().numpy().copy()
            for k, p in block.collect_params().items()}


def _jax_values(init):
    mx.random.seed(0)
    out = {}
    for key, block in _layers(nn_j, _StatsJ).items():
        block.initialize(init=init)
        out.update({f"{key}.{k}": v for k, v in _values("jax", block).items()})
    return out


def _port_values(init, generator=None):
    random_t.seed(0, "cpu")
    out = {}
    for key, block in _layers(nn_t, _StatsT).items():
        block.initialize(init=init, generator=generator)
        out.update({f"{key}.{k}": v for k, v in _values("port", block).items()})
    return out


@pytest.mark.parametrize("init", ["xavier", "uniform", "xavier-instance"])
@pytest.mark.parametrize("generator", [None, "explicit"])
def test_name_rule_gives_zeros_and_ones_as_in_jax(init, generator):
    jinit = init_j.Xavier() if init == "xavier-instance" else init
    tinit = init_t.Xavier() if init == "xavier-instance" else init
    gen = torch.Generator().manual_seed(3) if generator else None
    jv, tv = _jax_values(jinit), _port_values(tinit, gen)
    assert sorted(jv) == sorted(tv)
    ruled = [k for k in jv if k.endswith(init_t._ZERO_NAMES
                                         + init_t._ONE_NAMES)]
    assert sorted(ruled) == sorted(
        ["dense.bias", "norm.gamma", "norm.beta"]
        + [f"stats.{s}" for s in _STATS])
    for k in ruled:
        want = 1.0 if k.endswith(init_t._ONE_NAMES) else 0.0
        np.testing.assert_array_equal(jv[k], np.full_like(jv[k], want))
        np.testing.assert_array_equal(tv[k], jv[k])
    for k in ("dense.weight", "stats.weight"):       # drawn in both
        assert tv[k].shape == jv[k].shape
        assert np.abs(tv[k]).max() > 0 and np.abs(jv[k]).max() > 0
        assert np.abs(tv[k]).max() <= np.abs(jv[k]).max() * 10


def test_name_rule_beats_a_parameters_own_initializer():
    """A parameter whose own initializer would draw still gets the name
    rule's value in both packages (the JAX rule is in init_array)."""
    jp = gluon_j.Parameter("proj_bias", shape=(5,), init="uniform")
    jp.initialize()
    tb = gluon_t.Block()
    tb.proj_bias = gluon_t.Parameter("proj_bias", (5,), init="uniform")
    tb.initialize(generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(np.asarray(jp.data()._data), np.zeros(5))
    np.testing.assert_array_equal(tb.proj_bias.detach().numpy(),
                                  np.zeros(5, np.float32))


def _weight(package, block):
    p = block.weight
    if package == "jax":
        return np.asarray(p.data()._data).copy()
    return p.detach().numpy().copy()


def _set_weight(package, block, value):
    if package == "jax":
        block.weight.set_data(np.full(block.weight.shape, value, np.float32))
    else:
        with torch.no_grad():
            block.weight.fill_(value)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_second_initialize_keeps_weights_unless_forced(package):
    nn = nn_j if package == "jax" else nn_t
    d = nn.Dense(2, in_units=2)
    d.initialize()
    _set_weight(package, d, 5.0)
    d.initialize()
    np.testing.assert_array_equal(_weight(package, d), np.full((2, 2), 5.0))
    d.initialize(force_reinit=True)
    w = _weight(package, d)
    assert not (w == 5.0).any() and np.abs(w).max() <= 0.07


def test_loaded_weights_count_as_initialised(tmp_path):
    """Weights loaded by name survive a later `initialize()` in the port,
    as `load_parameters` weights do in the JAX package."""
    jd = nn_j.Dense(3, in_units=4)
    jd.initialize(init="xavier")
    path = str(tmp_path / "dense.params")
    jd.save_parameters(path)
    jd2 = nn_j.Dense(3, in_units=4)
    jd2.load_parameters(path)
    jd2.initialize()
    want = _values("jax", jd)
    got_j = _values("jax", jd2)
    td = nn_t.Dense(3, in_units=4)
    weights.load_named_arrays(td, want)
    td.initialize(generator=torch.Generator().manual_seed(1))
    got_t = _values("port", td)
    for k in want:
        np.testing.assert_array_equal(got_j[k], want[k])
        np.testing.assert_array_equal(got_t[k], want[k])
    td.initialize(force_reinit=True, generator=torch.Generator().manual_seed(1))
    assert not np.array_equal(_values("port", td)["weight"], want["weight"])


def _draw(package, seed):
    if package == "jax":
        mx.random.seed(seed)
        d = nn_j.Dense(3, in_units=3)
    else:
        random_t.seed(seed, "cpu")
        d = nn_t.Dense(3, in_units=3)
    d.initialize()
    return _weight(package, d)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_seed_governs_initialize_without_a_generator(package):
    first, other, again = (_draw(package, s) for s in (1, 2, 1))
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)


def test_seed_governs_whole_model_initialisation():
    """A model initialised after `random.seed(s)` with no generator is the
    same model as one initialised from `random.seed(s, "cpu")`'s
    generator: the device stream is the one source."""
    from mxnet_tpu_torch.models import gpt as gpt_t

    def build(explicit):
        m = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
        gen = random_t.seed(7, "cpu")
        m.initialize(generator=gen if explicit else None)
        return _values("port", m)

    a, b = build(True), build(False)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
