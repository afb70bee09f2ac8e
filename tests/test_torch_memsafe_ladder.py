"""PyTorch port, the graduated remat policies and the trainer's OOM
degradation ladder (`memsafe`, `models._remat`, `Block.remat`),
mirroring the JAX package's `tests/unittest/test_memsafe.py` on the
CPU.

Every remat policy is held bit for bit against "none" with dropout on
(losses, gradients and the trained master: each recomputation replays
the port's random streams). The ladder's walk under the `oom` fault is
held against the JAX package's walk of the same configuration
(transition for transition); its losses against an uninterrupted run
within rtol 1e-5 once gradient accumulation changed the reduction order
(the JAX test's tolerance), bit for bit while only remat rungs fired.
"""
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import memsafe as memsafe_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import parallel as parallel_j
from mxnet_tpu import resilience as res_j
from mxnet_tpu.gluon import loss as gloss_j
from mxnet_tpu.gluon import nn as nn_j

from mxnet_tpu_torch import config, memsafe, parallel, resilience
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.models import _remat, bert, gpt


@pytest.fixture(autouse=True)
def _clean():
    yield
    memsafe.disable()
    memsafe.reset()
    resilience.uninstall()
    config.reset()


_TINY = dict(vocab_size=128, units=64, hidden_size=128, num_layers=3,
             num_heads=4, max_length=64, dropout=0.1, attn_dropout=0.1)
_FAMILIES = {
    "bert": (bert, "bert_large_config", "BERTForPretraining",
             "bert_pretrain_loss",
             ("input_ids", "token_types", "valid_length",
              "masked_positions"),
             ("mlm_labels", "mlm_weights", "nsp_labels")),
    "gpt": (gpt, "gpt2_345m_config", "GPTForCausalLM", "gpt_lm_loss",
            ("input_ids", "valid_length"), ("labels", "weights")),
}


def _model(family, **cfg):
    mod, config_name, cls = _FAMILIES[family][:3]
    m = getattr(mod, cls)(getattr(mod, config_name)(**dict(_TINY, **cfg)),
                          device="cpu")
    m.initialize(generator=mxrandom.seed(0, "cpu"))
    return m


def _batch(family):
    mod = _FAMILIES[family][0]
    cfg = getattr(mod, _FAMILIES[family][1])(**_TINY)
    if family == "bert":
        return mod.make_synthetic_batch(cfg, 4, 32, 5, seed=3)
    return mod.make_synthetic_batch(cfg, 4, 32, seed=3)


def _train(family, policy, steps=2):
    """`steps` LAMB steps of the tiny model under `policy`: (losses, the
    flat master)."""
    mod, _, _, loss, data, labels = _FAMILIES[family]
    m = _model(family)
    if policy is not None:
        m.remat(policy)
    tr = parallel.ShardedTrainer(m, getattr(mod, loss), "lamb",
                                 {"learning_rate": 1e-3, "wd": 0.01},
                                 device="cpu")
    b = _batch(family)
    mxrandom.seed(11, "cpu")
    losses = [float(tr.step([b[k] for k in data], [b[k] for k in labels]))
              for _ in range(steps)]
    return losses, tr.params.clone()


_REFS = {}


def _ref(family):
    if family not in _REFS:
        _REFS[family] = _train(family, "none")
    return _REFS[family]


@pytest.mark.parametrize("policy", ["dots_saveable", "layers", "full"])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_policy_bit_equal_to_none_with_dropout(family, policy):
    ref_losses, ref_master = _ref(family)
    losses, master = _train(family, policy)
    assert losses == ref_losses
    assert torch.equal(master, ref_master)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _remat.DOTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


_BWD_GEMMS = {}


def _bwd_gemms(policy):
    """GEMMs the backward of one training forward of the tiny BERT runs
    under `policy`."""
    if policy not in _BWD_GEMMS:
        mod, _, _, loss_name, data, labels = _FAMILIES["bert"]
        m = _model("bert").remat(policy)
        b = _batch("bert")
        leaves = {n: p.detach().clone().requires_grad_(True)
                  for n, p in m.collect_params().items()}
        m.train()
        out = functional_call(m, leaves, tuple(torch.from_numpy(b[k])
                                               for k in data))
        m.eval()
        loss = getattr(mod, loss_name)(*out, *[torch.from_numpy(b[k])
                                               for k in labels])
        with _CountMM() as c:
            torch.autograd.grad(loss, list(leaves.values()))
        _BWD_GEMMS[policy] = c.n
    return _BWD_GEMMS[policy]


@pytest.mark.parametrize("policy,recomputed", [
    ("dots_saveable", False), ("layers", True), ("full", True)])
def test_dots_saveable_recomputes_no_gemm(policy, recomputed):
    """GEMMs run in the backward: under "dots_saveable" exactly those of
    "none" (the saved outputs are reused), under "layers" and "full"
    more (the layers' GEMMs run again)."""
    base = _bwd_gemms("none")
    n = _bwd_gemms(policy)
    assert (n > base) == recomputed and n >= base, (policy, n, base)


def test_policy_markers_knob_and_legacy_alias():
    m = bert.BERTForPretraining(bert.bert_large_config(**_TINY),
                                device="cpu")
    # the config's remat=True is the "layers" alias
    assert memsafe.policy_marker(m) == "layers"
    m.remat("dots_saveable")                      # explicit beats config
    assert memsafe.policy_marker(m) == "dots_saveable"
    assert m.bert._remat_policy == "dots_saveable"
    assert memsafe.block_wrap_policy(m) is None   # BERTModel owns it
    config.set("remat_policy", "full")            # the default of the rest
    m2 = gpt.GPTForCausalLM(gpt.gpt2_345m_config(**dict(_TINY, remat=False)),
                            device="cpu")
    assert memsafe.policy_marker(m2) == "full"
    m2.remat("none")
    assert memsafe.policy_marker(m2) == "none"
    config.reset("remat_policy")
    with pytest.raises(ValueError):
        m2.remat("everything")
    with pytest.raises(ValueError, match="remat_policy"):
        config.set("remat_policy", "some")
    # a config's remat may name a policy; anything else is refused
    m3 = bert.BERTForPretraining(
        bert.bert_large_config(**dict(_TINY, remat="full")), device="cpu")
    assert memsafe.policy_marker(m3) == "full"
    with pytest.raises(ValueError, match="unknown remat policy"):
        gpt.GPTForCausalLM(gpt.gpt2_345m_config(**dict(_TINY, remat="some")),
                           device="cpu")
    # the knob and the JAX package agree on the names and the order
    assert memsafe.POLICIES == memsafe_j.POLICIES == memsafe.LADDER


def _dense_trainer(seed=0, dropout=False, optimizer="sgd"):
    mxrandom.seed(seed, "cpu")
    with torch.device("cpu"):
        if dropout:
            net = nn.HybridSequential()
            net.add(nn.Dense(16, in_units=8), nn.Dropout(0.5),
                    nn.Dense(4, in_units=16))
        else:
            net = nn.Dense(4, in_units=8)
    net.initialize()
    lfn = gloss.L2Loss()
    tr = parallel.ShardedTrainer(net, lambda o, l: lfn(o, l), optimizer,
                                 {"learning_rate": 0.1}, device="cpu")
    return tr, net


def _xy(batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 8).astype(np.float32),
            np.zeros((batch, 4), np.float32))


@pytest.mark.parametrize("policy", ["dots_saveable", "layers", "full"])
@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_generic_block_wrap_bit_equal(policy, optimizer):
    """A block without per-layer handling runs its whole forward under
    the policy's checkpoint in the trainer: losses and weights equal the
    unwrapped run's bit for bit, dropout on."""
    x, y = _xy()

    def run(pol):
        tr, net = _dense_trainer(dropout=True, optimizer=optimizer)
        if pol:
            net.remat(pol)
        assert memsafe.block_wrap_policy(net) == pol
        losses = [float(tr.step(x, y)) for _ in range(3)]
        return losses, [p.clone() for p in (
            [tr.params] if optimizer == "lamb" else tr.params)]

    ref, ref_w = run(None)
    got, got_w = run(policy)
    assert got == ref
    assert all(torch.equal(a, b) for a, b in zip(got_w, ref_w))


def _jax_walk(n_oom):
    """The JAX package's ladder on its dense trainer under `n_oom`
    `oom@step:1` faults: [(kind, value)]."""
    config_j.set("oom_recover", "auto")
    config_j.set("fault_inject", ",".join(["oom@step:1"] * n_oom))
    try:
        res_j.enable()
        memsafe_j.reset()
        parallel_j.make_mesh(dp=-1)
        mx.random.seed(0)
        net = nn_j.Dense(4, in_units=8)
        net.initialize()
        lfn = gloss_j.L2Loss()
        tr = parallel_j.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                       {"learning_rate": 0.1})
        x, y = _xy()
        tr.step(nd_j.array(x), nd_j.array(y))
        return [(t["kind"], t["value"]) for t in memsafe_j.transitions()]
    finally:
        res_j.uninstall()
        memsafe_j.disable()
        memsafe_j.reset()
        config_j.reset()
        parallel_j.set_mesh(None)


def test_full_ladder_walk_under_oom_injection():
    x, y = _xy()
    tr0, _ = _dense_trainer()
    ref = [float(tr0.step(x, y)) for _ in range(3)]
    config.set("oom_recover", "auto")
    config.set("fault_inject", ",".join(["oom@step:1"] * 5))
    resilience.enable()
    tr, net = _dense_trainer()
    losses = [float(tr.step(x, y)) for _ in range(3)]
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    walked = [(t["kind"], t["value"]) for t in memsafe.transitions()]
    assert walked == [("remat", "dots_saveable"), ("remat", "layers"),
                      ("remat", "full"), ("accum", 2), ("accum", 4)]
    assert walked == _jax_walk(5)
    assert memsafe.policy_marker(net) == "full" and tr._accum == 4
    assert memsafe.oom_events() == 5
    snap = memsafe.snapshot()
    assert snap["oom_events"] == 5 and \
        [(t["kind"], t["value"]) for t in snap["transitions"]] == walked
    assert tr.num_update == 3


def test_ladder_rewinds_the_random_streams():
    """Only remat rungs fired: the recovered run, dropout on, equals an
    uninterrupted one bit for bit (each failed attempt's draws are
    rewound, and every policy replays them)."""
    x, y = _xy()
    tr0, _ = _dense_trainer(dropout=True, optimizer="lamb")
    ref = [float(tr0.step(x, y)) for _ in range(3)]
    config.set("oom_recover", "auto")
    config.set("fault_inject", "oom@step:1,oom@step:1,oom@step:2")
    resilience.enable()
    tr, net = _dense_trainer(dropout=True, optimizer="lamb")
    losses = [float(tr.step(x, y)) for _ in range(3)]
    assert losses == ref
    assert [(t["kind"], t["value"], t["step"]) for t in
            memsafe.transitions()] == [("remat", "dots_saveable", 1),
                                       ("remat", "layers", 1),
                                       ("remat", "full", 2)]
    assert torch.equal(tr.params, tr0.params)


def test_oom_recover_off_keeps_fail_fast():
    config.set("fault_inject", "oom@step:1")
    config.set("device_bytes_limit", 10**9)   # arms memsafe; recover off
    resilience.enable()
    tr, _ = _dense_trainer()
    x, y = _xy()
    with pytest.raises(memsafe.SimulatedResourceExhausted,
                       match="RESOURCE_EXHAUSTED"):
        tr.step(x, y)
    assert memsafe.enabled() and memsafe.transitions() == []
    assert memsafe.oom_events() == 1
    assert tr.num_update == 0
    tr.step(x, y)                              # the spec fired once
    assert tr.num_update == 1


def test_ladder_exhausted_reraises_with_a_note():
    """A batch of 1 cannot be split: after the remat rungs the original
    error propagates, annotated."""
    config.set("oom_recover", "auto")
    config.set("fault_inject", ",".join(["oom@step:1"] * 4))
    resilience.enable()
    tr, _ = _dense_trainer()
    x, y = _xy(batch=1)
    with pytest.raises(memsafe.SimulatedResourceExhausted) as ei:
        tr.step(x, y)
    assert any("ladder exhausted" in n for n in ei.value.__notes__)
    assert [t["value"] for t in memsafe.transitions()] == \
        ["dots_saveable", "layers", "full"]
    assert tr.num_update == 0


@pytest.mark.parametrize("optimizer", ["sgd", "lamb"])
def test_no_retry_after_the_state_was_touched(monkeypatch, optimizer):
    """An out-of-memory inside the optimizer's in-place update (the
    state already partly written) cannot be retried: it raises, as the
    JAX package raises when the failed dispatch consumed its state."""
    config.set("oom_recover", "auto")
    tr, _ = _dense_trainer(optimizer=optimizer)
    x, y = _xy()
    tr.step(x, y)
    target = tr._fl if optimizer == "lamb" else tr.fopt
    name = "apply_flat" if optimizer == "lamb" else "apply"

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
    monkeypatch.setattr(target, name, oom)
    with pytest.raises(RuntimeError, match="cannot be retried") as ei:
        tr.step(x, y)
    assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)
    assert memsafe.transitions() == []
    assert tr.num_update == 1


def test_failed_attempt_frames_are_released():
    """The ladder runs outside the handler with the failed attempt's
    frames cleared: a tensor only the failing frame held is freed."""
    held = {}

    def attempt():
        big = torch.zeros(1000)
        held["ref"] = weakref.ref(big)
        raise memsafe.SimulatedResourceExhausted(step=1)

    try:
        attempt()
    except Exception as e:  # noqa: BLE001
        exc = memsafe._release(e)
    gc.collect()
    assert held["ref"]() is None
    assert "RESOURCE_EXHAUSTED" in str(exc)


def test_is_oom_classes():
    assert memsafe.is_oom(torch.cuda.OutOfMemoryError("x"))
    assert memsafe.is_oom(memsafe.SimulatedResourceExhausted(step=2))
    assert memsafe.is_oom(memsafe.MemoryBudgetError("e", 2, 1))
    assert not memsafe.is_oom(RuntimeError("CUDA error: illegal address"))


def test_eager_trainer_oom_counts_and_annotates():
    memsafe.enable()
    with torch.device("cpu"):
        net = nn.Dense(4, in_units=8)
    net.initialize(generator=mxrandom.seed(0, "cpu"))
    trainer = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    trainer._update = boom
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        trainer.step(8)
    assert memsafe.oom_events() == 1
    assert any("eager-path OOM" in n for n in ei.value.__notes__)
    memsafe.disable()
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        trainer.step(8)
    assert memsafe.oom_events() == 1 and not getattr(ei.value, "__notes__",
                                                      None)
