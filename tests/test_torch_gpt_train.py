"""PyTorch port, GPT training: `models.gpt` in training mode, `gpt_lm_loss`
and `parallel.ShardedTrainer` with per-parameter Adam/AdamW against the
JAX package (`mxnet_tpu.models.gpt`, `mxnet_tpu.parallel.ShardedTrainer(
model, gpt_lm_loss, kind, ...)`) on the CPU, float32, gpt_tiny_config
(dropout 0), from the same weights (carried by name with
`weights.load_named_arrays`) and the same numpy batches (batch 8, which
the JAX trainer's 8-device CPU test mesh divides).

Tolerances: logits and loss atol 2e-5 (float32; the two frameworks
reduce in other orders). Gradients atol 1e-5 + rtol 1e-4 against
`jax.grad` through the JAX package's `functional_call` and against its
eager tape (a few more products summed in another order). Per-step
losses atol 2e-5. Final parameters atol 1e-4 after three steps: Adam's
step lr_t·m/(√v+ε) divides the gradient by its own magnitude, so an
element whose gradient is near zero passes on the gradient's float32
noise amplified by up to lr/(ε·√(1-β2)/(1-β1)) (about 3e3 at the first
step), and the port computes the bias-corrected lr_t as a host double
where the JAX step computes it in float32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd, parallel
from mxnet_tpu.gluon.block import functional_call
from mxnet_tpu.models import gpt as gpt_j
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel.trainer import call_loss

from mxnet_tpu_torch import optimizer as opt_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import random as mxrandom
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.cuda_ops import fused_update as fu_t
from mxnet_tpu_torch.models import gpt as gpt_t

_ATOL = 2e-5
_OPTS = {"adam": {"learning_rate": 1e-3},
         "adamw": {"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 1.0}}


def _jax_model():
    parallel.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    return jm, arrays


def _port_model(arrays, **overrides):
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(**overrides),
                              device="cpu")
    weights.load_named_arrays(tm, arrays)
    return tm


@pytest.fixture(scope="module")
def pair():
    jm, arrays = _jax_model()
    yield jm, _port_model(arrays), arrays
    parallel.set_mesh(None)


def _batch(B=8, L=24, seed=3):
    b = gpt_t.make_synthetic_batch(gpt_t.gpt_tiny_config(), B, L, seed)
    b["valid_length"][1::3] = L - 9
    for i in range(1, B, 3):
        b["weights"][i, L - 9:] = 0.0
    return b


def _nd(a):
    return NDArray(jnp.asarray(a))


def _np(x):
    return np.asarray(x._data if isinstance(x, NDArray) else x)


def test_synthetic_batch_is_the_jax_packages():
    cfg = gpt_t.gpt_tiny_config()
    got = gpt_t.make_synthetic_batch(cfg, 3, 10, seed=7)
    ref = gpt_j.make_synthetic_batch(gpt_j.gpt_tiny_config(), 3, 10, seed=7)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["labels"][:, :-1],
                                  got["input_ids"][:, 1:])


def test_dropout_layers_follow_the_config():
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt2_117m_config(num_layers=1, units=64,
                                                     hidden_size=128,
                                                     num_heads=4,
                                                     vocab_size=100,
                                                     max_length=32),
                              device="cpu")
    assert tm.gpt.embed_dropout._rate == 0.1
    assert tm.gpt.layers[0].dropout._rate == 0.1
    assert tm.gpt.layers[0].attn._dropout == 0.0      # GPT-2: attention 0
    tiny = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    assert tiny.gpt.embed_dropout is None and tiny.gpt.layers[0].dropout \
        is None


def test_train_mode_forward_and_loss_match(pair):
    """Training-mode forward (dropout 0) with valid_length < L and
    zero-weighted positions: logits and gpt_lm_loss."""
    jm, tm, _ = pair
    b = _batch()
    with autograd.record():                   # the JAX package's train mode
        lg_j = jm(_nd(b["input_ids"]), _nd(b["valid_length"]))
    loss_j = gpt_j.gpt_lm_loss(lg_j, _nd(b["labels"]), _nd(b["weights"]))
    tm.train()
    try:
        lg_t = tm(torch.from_numpy(b["input_ids"]),
                  torch.from_numpy(b["valid_length"]))
    finally:
        tm.eval()
    loss_t = gpt_t.gpt_lm_loss(lg_t, torch.from_numpy(b["labels"]),
                               torch.from_numpy(b["weights"]))
    np.testing.assert_allclose(lg_t.detach().numpy(), _np(lg_j), atol=_ATOL,
                               rtol=_ATOL)
    assert loss_t.dtype == torch.float32 and loss_t.dim() == 0
    np.testing.assert_allclose(float(loss_t), float(_np(loss_j)), atol=_ATOL)


def test_loss_weights_and_empty_batch():
    rng = np.random.RandomState(0)
    lg = torch.from_numpy(rng.randn(2, 5, 11).astype(np.float32))
    lb = torch.from_numpy(rng.randint(0, 11, (2, 5)).astype(np.int32))
    w = torch.zeros((2, 5))
    assert float(gpt_t.gpt_lm_loss(lg, lb, w)) == 0.0     # max(sum w, 1)
    w[0, 2] = 1.0
    want = -torch.log_softmax(lg[0, 2], -1)[lb[0, 2].long()]
    np.testing.assert_allclose(float(gpt_t.gpt_lm_loss(lg, lb, w)),
                               float(want), rtol=1e-6)
    ref = gpt_j.gpt_lm_loss(_nd(lg.numpy().astype(jnp.bfloat16)),
                            _nd(lb.numpy()), _nd(w.numpy()))
    got = gpt_t.gpt_lm_loss(lg.bfloat16(), lb, w)
    np.testing.assert_allclose(float(got), float(_np(ref)), rtol=1e-6)


def test_gradients_match_the_jax_tape(pair):
    jm, tm, arrays = pair
    b = _batch(seed=5)
    data = [b["input_ids"], b["valid_length"]]
    labels = [b["labels"], b["weights"]]
    with autograd.record():
        lg_j = jm(*[_nd(x) for x in data])
        loss_j = gpt_j.gpt_lm_loss(lg_j, *[_nd(x) for x in labels])
    loss_j.backward()
    tape = {k: np.asarray(p.grad()._data)
            for k, p in jm.collect_params().items()}
    fn, gps, aux = functional_call(jm, train=True)
    rng = mx.random.next_key()

    def loss_of(ps):
        outs, _ = fn(ps, [p.data()._data for _, p in aux], rng,
                     *[jnp.asarray(x) for x in data])
        return call_loss(gpt_j.gpt_lm_loss, rng, outs,
                         [jnp.asarray(x) for x in labels])

    grads_j = dict(zip([n for n, _ in gps], [np.asarray(g) for g in jax.grad(
        loss_of)([p.data()._data for _, p in gps])]))
    assert set(grads_j) == set(tape) == set(arrays)

    names = sorted(arrays)
    params = tm.collect_params()
    leaves = [params[n].detach().clone().requires_grad_(True) for n in names]
    tm.train()
    try:
        lg_t = torch.func.functional_call(
            tm, dict(zip(names, leaves)),
            tuple(torch.from_numpy(x) for x in data))
    finally:
        tm.eval()
    loss_t = gpt_t.gpt_lm_loss(lg_t, *[torch.from_numpy(x) for x in labels])
    grads = torch.autograd.grad(loss_t, leaves)
    np.testing.assert_allclose(float(loss_t.detach()), float(_np(loss_j)),
                               atol=_ATOL)
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32 and g.shape == params[name].shape
        assert np.abs(grads_j[name]).max() > 0, name
        np.testing.assert_allclose(g.numpy(), grads_j[name], atol=1e-5,
                                   rtol=1e-4, err_msg=name)
        if name != "gpt.position_embed":      # the JAX tape does not see it
            np.testing.assert_allclose(g.numpy(), tape[name], atol=1e-5,
                                       rtol=1e-4, err_msg=name)


def _batches(n=3):
    return [_batch(seed=10 + i) for i in range(n)]


@pytest.fixture(scope="module", params=sorted(_OPTS))
def runs(request):
    """Three steps of each trainer from the same start and the same three
    batches: (kind, JAX losses, JAX params by name, port losses, port
    params by name, port trainer, start weights)."""
    kind = request.param
    jm, arrays = _jax_model()
    jt = parallel.ShardedTrainer(jm, gpt_j.gpt_lm_loss, kind,
                                 dict(_OPTS[kind]))
    bs = _batches()
    jl = [float(jt.step([nd.array(b["input_ids"]), nd.array(b["valid_length"])],
                        [nd.array(b["labels"]), nd.array(b["weights"])]
                        ).asscalar()) for b in bs]
    jw = {n: np.asarray(w) for n, w in zip(jt._names, jt.params)}
    parallel.set_mesh(None)

    tm = _port_model(arrays)
    tt = parallel_t.ShardedTrainer(tm, gpt_t.gpt_lm_loss, kind,
                                   dict(_OPTS[kind]), device="cpu")
    n0 = fu_t.launches_adam
    tl = [float(tt.step([b["input_ids"], b["valid_length"]],
                        [b["labels"], b["weights"]])) for b in bs]
    assert fu_t.launches_adam == n0          # CPU tensors launch nothing
    tw = {n: w.detach().numpy() for n, w in zip(tt._names, tt.params)}
    return kind, jl, jw, tl, tw, tt, arrays


def test_adam_step_losses_match(runs):
    _, jl, _, tl, _, _, _ = runs
    np.testing.assert_allclose(tl, jl, atol=_ATOL, rtol=0)
    assert tl[-1] < tl[0]


def test_adam_params_match_per_name(runs):
    _, _, jw, _, tw, _, arrays = runs
    assert set(tw) == set(jw) == set(arrays)
    for name in sorted(jw):
        np.testing.assert_allclose(tw[name], jw[name], atol=1e-4, rtol=0,
                                   err_msg=name)
        assert not np.array_equal(jw[name], arrays[name]), name


def test_adam_trainer_bookkeeping(runs):
    kind, _, _, _, _, tt, arrays = runs
    assert tt.num_update == 3 and tt.fopt.kind == kind
    assert tt.param_count == sum(int(np.prod(a.shape))
                                 for a in arrays.values())
    assert len(tt.opt_state) == len(tt.params) == len(arrays)
    for p, (m, v) in zip(tt.params, tt.opt_state):
        assert m.dtype == v.dtype == torch.float32
        assert m.shape == v.shape == p.shape
        assert float(v.min()) >= 0.0
    # the trainer's copies are its own: the block is untouched until sync
    params = tt.block.collect_params()
    for name, p in zip(tt._names, tt.params):
        assert p.data_ptr() != params[name].data_ptr()
        np.testing.assert_array_equal(params[name].detach().numpy(),
                                      arrays[name])
    assert not tt.block.training


def test_adam_sync_to_block_writes_the_params(runs):
    _, _, _, _, tw, tt, _ = runs
    tt.sync_to_block()
    params = tt.block.collect_params()
    for name, w in tw.items():
        np.testing.assert_array_equal(params[name].detach().numpy(), w)


def test_optimizers_have_the_jax_defaults():
    from mxnet_tpu import optimizer as opt_j
    for name in ("adam", "adamw"):
        ref, got = opt_j.create(name), opt_t.create(name)
        assert type(got).__name__.lower() == name
        assert (got.lr, got.beta1, got.beta2, got.epsilon, got.wd) == \
            (ref.lr, ref.beta1, ref.beta2, ref.epsilon, ref.wd)
    assert isinstance(opt_t.create("lamb"), opt_t.LAMB)
    for name in ("sgd", "nag"):
        ref, got = opt_j.create(name), opt_t.create(name)
        assert type(got).__name__.lower() == name
        assert (got.lr, got.momentum, got.wd) == \
            (ref.lr, ref.momentum, ref.wd)
    with pytest.raises(NotImplementedError):
        opt_t.create("rmsprop")
    # an lr scheduler is ported: it takes the optimizer's rate as its base
    from mxnet_tpu_torch import lr_scheduler as lrs_t
    sched = lrs_t.FactorScheduler(step=1, factor=0.5)
    got = opt_t.create("adam", learning_rate=0.1, lr_scheduler=sched)
    assert sched.base_lr == 0.1 and got.learning_rate == 0.1
    with pytest.raises(TypeError):                 # no row-sparse gradients
        opt_t.create("adam", lazy_update=False)


def test_adam_weight_decay_is_every_parameters():
    """Adam and AdamW decay every parameter by wd (LayerNorm and biases
    included): LAMB's no-decay rule is not theirs."""
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    tm.initialize(generator=mxrandom.seed(2, "cpu"))
    b = _batch(B=2, L=8)
    for kind in ("adam", "adamw"):
        tt = parallel_t.ShardedTrainer(tm, gpt_t.gpt_lm_loss, kind,
                                       {"learning_rate": 0.0, "wd": 0.5},
                                       device="cpu")
        gamma = tt._names.index("gpt.ln_f.gamma")
        before = tt.params[gamma].clone()
        tt.step([b["input_ids"]], [b["labels"], b["weights"]])
        if kind == "adam":       # lr 0: wd folds into g, w does not move
            torch.testing.assert_close(tt.params[gamma], before)
            m = tt.opt_state[gamma][0]
            assert float(m.abs().min()) > 0.0      # 0.1 * (g + 0.5 w)
        else:                    # AdamW: eta * wd * w, not scaled by lr
            torch.testing.assert_close(tt.params[gamma], before * 0.5)


def test_adam_trains_a_bfloat16_model():
    """A bf16 model trains in place in bf16 with float32 moments (the
    LayerNorm gamma/beta masters stay float32)."""
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(dtype="bfloat16"),
                              device="cpu")
    tm.initialize(generator=mxrandom.seed(1, "cpu"))
    tt = parallel_t.ShardedTrainer(tm, gpt_t.gpt_lm_loss, "adam",
                                   {"learning_rate": 1e-2}, device="cpu")
    b = _batch(B=4, L=16)
    losses = [float(tt.step([b["input_ids"]], [b["labels"], b["weights"]]))
              for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    dts = dict(zip(tt._names, (p.dtype for p in tt.params)))
    assert dts["gpt.word_embed.weight"] == torch.bfloat16
    assert dts["gpt.ln_f.gamma"] == torch.float32
    assert all(m.dtype == torch.float32 for m, _ in tt.opt_state)


def test_gpt_dropout_trains_and_is_seeded():
    b = _batch(B=4, L=16)

    def losses(dropout, seed):
        tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(dropout=dropout),
                                  device="cpu")
        tm.initialize(generator=mxrandom.seed(seed, "cpu"))
        tt = parallel_t.ShardedTrainer(tm, gpt_t.gpt_lm_loss, "adam",
                                       device="cpu")
        return [float(tt.step([b["input_ids"]],
                              [b["labels"], b["weights"]]))
                for _ in range(2)]

    a, again, plain = losses(0.1, 4), losses(0.1, 4), losses(0.0, 4)
    assert a == again
    assert a[0] != plain[0] and np.isfinite(a).all()
