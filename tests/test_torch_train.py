"""PyTorch port, training: `parallel.ShardedTrainer` with fused
flat-master LAMB against `mxnet_tpu.parallel.ShardedTrainer(..., "lamb")`
on the CPU, float32, bert_tiny_config (dropout 0), from the same weights
and the same batch (batch 8, so the JAX trainer's 8-device CPU test mesh
divides it).

Tolerances: per-step losses atol 2e-5 and the final master per parameter
atol 2e-5 (float32 after three LAMB steps; the row sums of squares and
the forward/backward reduce in other orders, and the bias-correction
constants are host doubles in the port, float32 on the JAX device).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, parallel
from mxnet_tpu.models import bert as bert_j

from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import bert as bert_t

_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")
_OPT = {"learning_rate": 1e-3, "wd": 0.01}


@pytest.fixture(scope="module")
def runs():
    """Three steps of each trainer from the same start: (losses, master
    per name) for the JAX package and the port."""
    parallel.make_mesh(dp=-1)
    jm = bert_j.BERTForPretraining(bert_j.bert_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    b = bert_j.make_synthetic_batch(bert_j.bert_tiny_config(), 8, 32, 6,
                                    seed=1)
    b["valid_length"][::3] = 20
    jt = parallel.ShardedTrainer(jm, bert_j.bert_pretrain_loss, "lamb",
                                 dict(_OPT))
    jl = [float(jt.step([nd.array(b[k]) for k in _DATA],
                        [nd.array(b[k]) for k in _LABELS]).asscalar())
          for _ in range(3)]
    jw = {n: np.asarray(w) for n, w in zip(
        jt._names, jt._fl.unflatten_master(jt.params))}
    parallel.set_mesh(None)

    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    tt = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                   dict(_OPT), device="cpu")
    tl = [float(tt.step([b[k] for k in _DATA], [b[k] for k in _LABELS]))
          for _ in range(3)]
    tw = dict(zip(tt._names, tt._fl.unflatten_master(tt.params)))
    return jl, jw, tl, tw, tt, arrays


def test_lamb_step_losses_match(runs):
    jl, _, tl, _, _, _ = runs
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=0)
    assert tl[-1] < tl[0]


def test_lamb_master_matches_per_name(runs):
    _, jw, _, tw, _, arrays = runs
    assert set(tw) == set(jw) == set(arrays)
    for name in sorted(jw):
        np.testing.assert_allclose(tw[name].numpy(), jw[name], atol=2e-5,
                                   rtol=0, err_msg=name)
        # every parameter moved (zero-init biases included)
        assert not np.array_equal(jw[name], arrays[name]), name


def test_trainer_bookkeeping(runs):
    _, _, _, _, tt, arrays = runs
    assert tt.num_update == 3
    assert tt.param_count == sum(int(np.prod(a.shape)) for a in
                                 arrays.values())
    # no weight decay on bias / LayerNorm parameters (the LAMB convention)
    wd = dict(zip(tt._names, (tt.fopt._wd_for(i)
                              for i in range(len(tt._names)))))
    assert wd["mlm_bias"] == wd["bert.embed_ln.gamma"] == 0.0
    assert wd["bert.layers.0.attn_ln.beta"] == 0.0
    assert wd["nsp.weight"] == wd["bert.position_embed"] == 0.01
    # the block is back in evaluation mode after a step
    assert not tt.block.training


def test_sync_to_block_writes_the_master(runs):
    _, _, _, tw, tt, _ = runs
    tt.sync_to_block()
    params = tt.block.collect_params()
    for name, w in tw.items():
        np.testing.assert_array_equal(params[name].detach().numpy(),
                                      w.numpy())


def test_trainer_refuses_what_it_cannot_do():
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    with pytest.raises(NotImplementedError):
        parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                  device="cpu", param_mode="fsdp")
    with pytest.raises(NotImplementedError):
        parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "rmsprop",
                                  device="cpu")


def test_grad_req_null_parameters_stay_frozen():
    """A parameter with grad_req 'null' is left out of the flat master and
    keeps its value while the others train."""
    b = bert_t.make_synthetic_batch(bert_t.bert_tiny_config(), 4, 16, 3)
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    tm.initialize(generator=torch.Generator().manual_seed(1))
    frozen = tm.bert.token_type_embed.weight
    frozen.grad_req = "null"
    before = frozen.detach().clone()
    tt = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                   dict(_OPT), device="cpu")
    assert "bert.token_type_embed.weight" not in tt._names
    assert tt.param_count == sum(p.numel() for p in tm.parameters()) \
        - frozen.numel()
    start = tt.params.clone()
    loss = tt.step([b[k] for k in _DATA], [b[k] for k in _LABELS])
    assert np.isfinite(float(loss))
    assert torch.equal(frozen, before)
    assert not torch.equal(tt.params, start)


def test_trainer_without_device_needs_the_card(monkeypatch):
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb")


def test_dropout_trains_and_is_seeded():
    """With dropout 0.1 (hidden and attention) the step is reproducible
    from `random.seed` and differs from the dropout-free step."""
    from mxnet_tpu_torch import random as mxrandom
    b = bert_t.make_synthetic_batch(bert_t.bert_tiny_config(), 4, 16, 3)

    def losses(dropout, seed):
        cfg = bert_t.bert_tiny_config(dropout=dropout)
        tm = bert_t.BERTForPretraining(cfg, device="cpu")
        tm.initialize(generator=mxrandom.seed(seed, "cpu"))
        tt = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss,
                                       "lamb", dict(_OPT), device="cpu")
        return [float(tt.step([b[k] for k in _DATA],
                              [b[k] for k in _LABELS])) for _ in range(2)]

    a, again, plain = losses(0.1, 4), losses(0.1, 4), losses(0.0, 4)
    assert a == again
    assert a[0] != plain[0] and np.isfinite(a).all()
