"""PyTorch port, SGD / NAG and the trainer's aux state, probe pass and
gradient accumulation: `parallel.ShardedTrainer` against
`mxnet_tpu.parallel.ShardedTrainer` on the CPU, float32, from the same
weights and the same numpy batch (batch 8, which the JAX trainer's
8-device CPU test mesh divides).

On a small ResNet v1 (BottleneckV1, two stages, BatchNorm everywhere):
"sgd" without and with momentum and "nag", each with wd 1e-4 and
gradient clipping, and "sgd" with `set_grad_accum(2)` (BatchNorm
statistics chained through the microbatches): per-step losses atol
2e-5, every parameter and every running statistic after 3 steps within
1e-5 of the largest |value| of its tensor (float32; convolutions reduce
in other orders). On tiny BERT with LAMB (the flat-master path),
`set_grad_accum(2)`: losses atol 2e-5 and the master atol 2e-5, as
`test_torch_train.py` holds the unsplit step.

The same ResNet cast to bfloat16 (bench.py's recipe) is held to the JAX
package's bf16 run at bf16 size; see
`test_resnet_trainer_bf16_matches_jax`.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd, parallel
from mxnet_tpu.gluon import loss as loss_j
from mxnet_tpu.models import bert as bert_j
from mxnet_tpu.models import resnet as resnet_j

from mxnet_tpu_torch import optimizer as opt_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.gluon import loss as loss_t
from mxnet_tpu_torch.models import bert as bert_t
from mxnet_tpu_torch.models import resnet as resnet_t

_CASES = {
    "sgd": ("sgd", {"learning_rate": 0.1, "wd": 1e-4, "clip_gradient": 0.5},
            1),
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4, "clip_gradient": 0.5}, 1),
    "nag": ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                    "clip_gradient": 0.5}, 1),
    "sgd_momentum_accum2": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                                    "wd": 1e-4}, 2),
}


def _net(mod, **kw):
    return mod.ResNetV1(mod.BottleneckV1, [1, 1], [8, 16, 32], classes=10,
                        **kw)


def _batch():
    x = np.random.RandomState(0).randn(8, 3, 32, 32).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, 8).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def start():
    """The JAX net's weights after the forward that resolves its shapes."""
    parallel.make_mesh(dp=-1)
    jm = _net(resnet_j)
    mx.random.seed(0)
    jm.initialize()
    jm(nd.array(_batch()[0]))
    yield {k: np.asarray(p.data()._data)
           for k, p in jm.collect_params().items()}
    parallel.set_mesh(None)


def _close(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - ref).max()) / scale
    assert err <= 1e-5, (what, err)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_resnet_trainer_matches_jax(start, case):
    kind, opt, accum = _CASES[case]
    x, y = _batch()
    jm = _net(resnet_j)
    for k, p in jm.collect_params().items():
        p.initialize()
        p.set_data(nd.array(start[k]))
    lj = loss_j.SoftmaxCrossEntropyLoss()
    jt = parallel.ShardedTrainer(jm, lambda o, l: lj(o, l), kind, dict(opt))
    jt.set_grad_accum(accum)
    j_losses = [float(jt.step([nd.array(x)], [nd.array(y)]).asscalar())
                for _ in range(3)]

    tm = _net(resnet_t, device="cpu")
    weights.load_named_arrays(tm, start)
    lt = loss_t.SoftmaxCrossEntropyLoss()
    tt = parallel_t.ShardedTrainer(tm, lambda o, l: lt(o, l), kind,
                                   dict(opt), device="cpu")
    tt.set_grad_accum(accum)
    t_losses = [float(tt.step([x], [y])) for _ in range(3)]

    np.testing.assert_allclose(t_losses, j_losses, atol=2e-5, rtol=0)
    assert t_losses[-1] < t_losses[0]
    assert tt._names == jt._names
    for name, w_j, w_t in zip(jt._names, jt.params, tt.params):
        _close(w_t.numpy(), np.asarray(w_j), name)
    aux = dict(zip([n for n, _ in jt._aux_params], jt.aux))
    params = tm.collect_params()
    assert len(aux) == 18
    for name, a in aux.items():
        _close(params[name].detach().numpy(), np.asarray(a), name)
        assert not np.array_equal(np.asarray(a), start[name]), name
    # the trainer's state: momentum for sgd with momentum and nag, none
    # for plain sgd; the block's own weights stay until sync_to_block
    assert all(len(s) == (0 if case == "sgd" else 1) for s in tt.opt_state)
    w0 = params["output.weight"].detach().clone()
    tt.sync_to_block()
    assert not torch.equal(params["output.weight"], w0)


def _jax_trained(start, kind, opt, dtype=None, steps=3):
    """Per-step losses and {name: float32 array} of the weights and
    running statistics after `steps` JAX ShardedTrainer steps."""
    x, y = _batch()
    jm = _net(resnet_j)
    for k, p in jm.collect_params().items():
        p.initialize()
        p.set_data(nd.array(start[k]))
    if dtype:
        jm.cast(dtype)
    lj = loss_j.SoftmaxCrossEntropyLoss()
    jt = parallel.ShardedTrainer(jm, lambda o, l: lj(o, l), kind, dict(opt))
    losses = [float(jt.step([nd.array(x)], [nd.array(y)]).asscalar())
              for _ in range(steps)]
    state = {n: np.asarray(w).astype(np.float32)
             for n, w in zip(jt._names, jt.params)}
    state.update({n: np.asarray(a).astype(np.float32)
                  for (n, _), a in zip(jt._aux_params, jt.aux)})
    return losses, state


def _distance(a, b, keys):
    """|a - b| / |b| over the tensors `keys` taken together."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    return np.sqrt(num / sum(float((b[k] ** 2).sum()) for k in keys))


def test_resnet_trainer_bf16_matches_jax(start):
    """bench.py's ResNet recipe in bfloat16 (`cast("bfloat16")`, "sgd"
    with momentum 0.9, wd 1e-4, lr 0.1; no float32 master): 3 steps of
    the port against 3 of the JAX package, both cast. Each package's
    bf16 run strays from the float32 run of the same steps (bf16
    BatchNorm gradients are some tenths off per element in both), so
    the port is held to the reference at bf16 size and by that stray:
    losses within 2^-6 relative; weights and running statistics, taken
    together, within 5% and 2% of the JAX bf16 run's (by norm); and no
    further from the float32 run than 1.5 times the JAX bf16 run is."""
    x, y = _batch()
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    _, ref32 = _jax_trained(start, "sgd", opt)
    j_losses, ref16 = _jax_trained(start, "sgd", opt, "bfloat16")
    tm = _net(resnet_t, device="cpu")
    weights.load_named_arrays(tm, start)
    tm.cast("bfloat16")
    lt = loss_t.SoftmaxCrossEntropyLoss()
    tt = parallel_t.ShardedTrainer(tm, lambda o, l: lt(o, l), "sgd",
                                   dict(opt), device="cpu")
    t_losses = [float(tt.step([x], [y])) for _ in range(3)]
    params = tm.collect_params()
    # the weights stay bf16 (rounded back after each update), the
    # momentum is float32, the running statistics are bf16 and moved
    assert all(w.dtype == torch.bfloat16 for w in tt.params)
    assert all(s[0].dtype == torch.float32 for s in tt.opt_state)
    got = {n: w.float().numpy() for n, w in zip(tt._names, tt.params)}
    running = [k for k in ref16 if "running" in k]
    assert len(running) == 18
    for k in running:
        assert params[k].dtype == torch.bfloat16, k
        assert not np.array_equal(params[k].float().numpy(), start[k]), k
        got[k] = params[k].detach().float().numpy()
    with torch.no_grad():
        tm.eval()
        assert tm(torch.from_numpy(x)).dtype == torch.bfloat16

    np.testing.assert_allclose(t_losses, j_losses, rtol=2 ** -6, atol=0)
    assert t_losses[-1] < t_losses[0]
    for keys, tol in (([n for n in tt._names], 0.05), (running, 0.02)):
        assert _distance(got, ref16, keys) <= tol, keys[0]
        assert _distance(got, ref32, keys) <= \
            1.5 * _distance(ref16, ref32, keys), keys[0]


def test_lamb_grad_accum_matches_jax():
    """The flat-master LAMB path with set_grad_accum(2)."""
    parallel.make_mesh(dp=-1)
    try:
        jm = bert_j.BERTForPretraining(bert_j.bert_tiny_config())
        mx.random.seed(0)
        jm.initialize()
        arrays = {k: np.asarray(p.data()._data)
                  for k, p in jm.collect_params().items()}
        b = bert_j.make_synthetic_batch(bert_j.bert_tiny_config(), 8, 32, 6,
                                        seed=1)
        data = ("input_ids", "token_types", "valid_length",
                "masked_positions")
        labels = ("mlm_labels", "mlm_weights", "nsp_labels")
        opt = {"learning_rate": 1e-3, "wd": 0.01}
        jt = parallel.ShardedTrainer(jm, bert_j.bert_pretrain_loss, "lamb",
                                     dict(opt))
        jt.set_grad_accum(2)
        jl = [float(jt.step([nd.array(b[k]) for k in data],
                            [nd.array(b[k]) for k in labels]).asscalar())
              for _ in range(3)]
        jw = [np.asarray(w) for w in jt._fl.unflatten_master(jt.params)]
    finally:
        parallel.set_mesh(None)
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    tt = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                   dict(opt), device="cpu")
    tt.set_grad_accum(2)
    tl = [float(tt.step([b[k] for k in data], [b[k] for k in labels]))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=0)
    assert tt._names == jt._names
    for name, w_j, w_t in zip(tt._names, jw,
                              tt._fl.unflatten_master(tt.params)):
        np.testing.assert_allclose(w_t.numpy(), w_j, atol=2e-5, rtol=0,
                                   err_msg=name)


def test_grad_accum_needs_a_divisible_batch(start):
    x, y = _batch()
    jm = _net(resnet_j)
    for k, p in jm.collect_params().items():
        p.initialize()
        p.set_data(nd.array(start[k]))
    jt = parallel.ShardedTrainer(jm, lambda o, l: o.mean(), "sgd")
    jt.set_grad_accum(3)
    with pytest.raises(ValueError, match="divisible by 3"):
        jt.step([nd.array(x)], [nd.array(y)])
    tm = _net(resnet_t, device="cpu")
    weights.load_named_arrays(tm, start)
    tt = parallel_t.ShardedTrainer(tm, lambda o, l: o.mean(), "sgd",
                                   device="cpu")
    tt.set_grad_accum(3)
    with pytest.raises(ValueError, match="divisible by 3"):
        tt.step([x], [y])
    assert tt.num_update == 0
    with pytest.raises(ValueError, match=">= 1"):
        tt.set_grad_accum(0)


def test_probe_pass_is_one_eval_forward():
    """A trainer on a net whose shapes are deferred runs one
    evaluation-mode forward on the first batch before it collects the
    parameters: the same training as on a net resolved by hand, bit for
    bit (the probe moves no running statistic)."""
    x, y = _batch()
    lt = loss_t.SoftmaxCrossEntropyLoss()
    runs = []
    for by_hand in (False, True):
        tm = _net(resnet_t, device="cpu")
        tm.initialize(generator=mxrandom.seed(4, "cpu"))
        if by_hand:
            with torch.no_grad():
                tm(torch.from_numpy(x))
        tt = parallel_t.ShardedTrainer(tm, lambda o, l: lt(o, l), "sgd",
                                       {"momentum": 0.9}, device="cpu")
        assert tt._ready == by_hand
        losses = [tt.step([x], [y]) for _ in range(2)]
        runs.append((losses, tt.params,
                     tm.features[1].running_mean.detach().clone()))
    (l0, w0, m0), (l1, w1, m1) = runs
    assert all(np.array_equal(a.asnumpy(), b.asnumpy())
               for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    assert torch.equal(m0, m1) and float(m0.abs().max()) > 0


def test_optimizers_resolve_by_name():
    sgd = opt_t.create("sgd", momentum=0.9, wd=1e-4, learning_rate=0.1,
                       clip_gradient=1.0, rescale_grad=0.5)
    assert isinstance(sgd, opt_t.SGD) and sgd.momentum == 0.9
    assert (sgd.wd, sgd.lr, sgd.clip_gradient, sgd.rescale_grad) == \
        (1e-4, 0.1, 1.0, 0.5)
    nag = opt_t.create("nag")
    assert isinstance(nag, opt_t.NAG) and nag.momentum == 0.0
    assert nag.lr == 0.01
    fo = parallel_t.FunctionalOptimizer("nag")
    assert fo.kind == "nag" and len(fo.init([torch.zeros(3)])[0]) == 1
