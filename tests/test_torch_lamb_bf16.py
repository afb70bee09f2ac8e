"""PyTorch port, LAMB with bfloat16 moments (`lamb_moments_dtype=
"bfloat16"`) against the JAX package on the CPU.

The port's plain route of both LAMB passes (`cuda_ops.fused_update`,
what `FusedLamb.apply_flat` runs on the CPU) against the JAX package's
`FusedLamb.apply_flat` with `moments_dtype=bfloat16`, 3 steps on the
same float32 master and gradients: moments within 1 bf16 ulp (XLA:CPU
and ATen may round the float32 EMA one ulp apart before the bf16
rounding), the master within 1e-5, the existing LAMB tolerance. Then the
tiny BERT trainer under the knob against the JAX trainer under it, from
the same weights and batch: losses and master atol 2e-5, the float32
route's tolerance in `tests/test_torch_train.py`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import nd, parallel
from mxnet_tpu.models import bert as bert_j
from mxnet_tpu.parallel.fused_lamb import FusedLamb as FusedLambJ

from mxnet_tpu_torch import config as config_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.cuda_ops import fused_update as fu
from mxnet_tpu_torch.models import bert as bert_t
from mxnet_tpu_torch.parallel.fused_lamb import FusedLamb as FusedLambT

_SHAPES = [(300, 7), (33,), (128, 64), (5,), (2, 3, 129)]
_WDS = [0.01, 0.0, 0.01, 0.0, 0.01]
_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")


@pytest.fixture(autouse=True)
def _clean():
    yield
    config_t.reset()
    config_j.reset()


def _bf16_ulps(a, b):
    """Largest distance between two bf16 arrays (as float32 values) in
    bf16 units in the last place."""
    def ordered(x):
        i = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
        return np.where(i >= 0x8000, 0x8000 - i, i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _pair(moments, bias_correction=True, clip=-1.0, rescale=1.0):
    args = (0.9, 0.999, 1e-6, bias_correction, rescale, clip, -1.0, -1.0)
    jl = FusedLambJ(_SHAPES, [jnp.float32] * len(_SHAPES), _WDS, *args,
                    moments_dtype=getattr(jnp, moments))
    tl = FusedLambT(_SHAPES, [torch.float32] * len(_SHAPES), _WDS, *args,
                    moments_dtype=moments)
    return jl, tl


@pytest.mark.parametrize("bias_correction,clip,rescale",
                         [(True, -1.0, 1.0), (False, 5e-4, 0.5)])
def test_plain_bf16_route_matches_jax_apply_flat(bias_correction, clip,
                                                 rescale):
    rng = np.random.RandomState(0)
    jl, tl = _pair("bfloat16", bias_correction, clip, rescale)
    ws = [rng.randn(*s).astype(np.float32) * 0.05 for s in _SHAPES]
    jw = jl.flatten([jnp.asarray(w) for w in ws])
    jm = jv = jnp.zeros(jw.shape, jnp.bfloat16)
    tw = tl.flatten([torch.from_numpy(w) for w in ws])
    tm, tv = tl.zeros_moments("cpu")
    assert tm.dtype == tv.dtype == torch.bfloat16
    for t in range(1, 4):
        gs = [rng.randn(*s).astype(np.float32) * 1e-3 for s in _SHAPES]
        jw, jm, jv = jl.apply_flat(jw, jl.flatten([jnp.asarray(g)
                                                  for g in gs]),
                                   jm, jv, t, 1e-3)
        tl.apply_flat(tw, tl.flatten([torch.from_numpy(g) for g in gs]),
                      tm, tv, t, 1e-3)
        assert jm.dtype == jnp.bfloat16
        for a, b in ((tm, jm), (tv, jv)):
            assert _bf16_ulps(a.float().numpy(),
                              np.asarray(b.astype(jnp.float32))) <= 1, t
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-5, err_msg=f"step {t}")
    # the padding of every segment stays zero in all three vectors
    for flat in (tw, tm.float(), tv.float()):
        for off, n, nxt in zip(tl.offsets[:-1], tl.sizes, tl.offsets[1:]):
            assert not flat[off + n:nxt].any()


def test_bf16_route_rounds_before_the_norms():
    """Pass 1 stores the bf16 moments and computes u from them: the row
    sums of u^2 equal those of the float32 route run on the stored
    (rounded) moments, not on the unrounded EMA."""
    g = torch.Generator().manual_seed(2)
    R = 6
    W = torch.randn(R, 512, generator=g) * 0.05
    G = torch.randn(R, 512, generator=g) * 1e-3
    m = (torch.randn(R, 512, generator=g) * 1e-4).bfloat16()
    v = (torch.randn(R, 512, generator=g) * 1e-4).square().bfloat16()
    wd = torch.full((R,), 0.01)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=True)
    c1, c2 = 1 - 0.9 ** 2, 1 - 0.999 ** 2
    m16, v16 = m.clone(), v.clone()
    _, ru16 = fu.lamb_pass1_reference(W, G, m16, v16, wd, c1, c2, **kw)
    m32, v32 = m.float(), v.float()
    fu.lamb_pass1_reference(W, G, m32, v32, wd, c1, c2, **kw)
    assert torch.equal(m16, m32.bfloat16()) and torch.equal(
        v16, v32.bfloat16())
    stored = fu._update(m16.float(), v16.float(), W, wd, c1, c2, 1e-6, True)
    assert torch.equal(ru16, (stored * stored).sum(1))
    unrounded = fu._update(m32, v32, W, wd, c1, c2, 1e-6, True)
    assert not torch.equal(ru16, (unrounded * unrounded).sum(1))


def test_moment_dtypes_are_checked():
    W = torch.zeros(2, 512)
    m, v = torch.zeros(2, 512), torch.zeros(2, 512, dtype=torch.bfloat16)
    wd = torch.zeros(2)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=True)
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        fu.lamb_pass1(W, W, m, v, wd, 0.1, 0.1, **kw)
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        fu.lamb_pass2(W, m.half(), m.half(), wd, wd, 0.1, 0.1, 1e-3,
                      epsilon=1e-6, bias_correction=True)
    with pytest.raises(ValueError, match="moments_dtype"):
        FusedLambT([(3,)], [torch.float32], [0.0], 0.9, 0.999, 1e-6, True,
                   1.0, -1.0, -1.0, -1.0, moments_dtype="float16")


@pytest.fixture(scope="module")
def trainer_runs():
    """Three LAMB steps of the tiny BERT under lamb_moments_dtype=
    "bfloat16" in each package, from the same weights and batch."""
    config_j.set("lamb_moments_dtype", "bfloat16")
    try:
        parallel.make_mesh(dp=-1)
        jm = bert_j.BERTForPretraining(bert_j.bert_tiny_config())
        mx.random.seed(0)
        jm.initialize()
        arrays = {k: np.asarray(p.data()._data)
                  for k, p in jm.collect_params().items()}
        b = bert_j.make_synthetic_batch(bert_j.bert_tiny_config(), 8, 32, 6,
                                        seed=1)
        jt = parallel.ShardedTrainer(jm, bert_j.bert_pretrain_loss, "lamb",
                                     {"learning_rate": 1e-3, "wd": 0.01})
        jl = [float(jt.step([nd.array(b[k]) for k in _DATA],
                            [nd.array(b[k]) for k in _LABELS]).asscalar())
              for _ in range(3)]
        jw = np.asarray(jt.params)
        jmom = [np.asarray(x.astype(jnp.float32)) for x in jt.opt_state]
        jdt = jt.opt_state[0].dtype
        parallel.set_mesh(None)
    finally:
        config_j.reset("lamb_moments_dtype")
    config_t.set("lamb_moments_dtype", "bfloat16")
    try:
        tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(),
                                       device="cpu")
        weights.load_named_arrays(tm, arrays)
        tt = parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                       {"learning_rate": 1e-3, "wd": 0.01},
                                       device="cpu")
    finally:
        config_t.reset("lamb_moments_dtype")
    tl = [float(tt.step([b[k] for k in _DATA], [b[k] for k in _LABELS]))
          for _ in range(3)]
    return jl, jw, jmom, jdt, tl, tt


def test_trainer_with_bf16_moments_matches_jax(trainer_runs):
    jl, jw, jmom, jdt, tl, tt = trainer_runs
    assert jdt == jnp.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in tt.opt_state)
    np.testing.assert_allclose(tl, jl, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tt.params.numpy(), jw, atol=2e-5, rtol=0)
    # moments: the gradients agree within float32 sums' order, so the
    # stored bf16 moments agree to about their own precision
    for a, b in zip(tt.opt_state, jmom):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2e-2,
                                   atol=1e-9)


def test_checkpoint_layout_keeps_the_moment_dtype(trainer_runs):
    *_, tt = trainer_runs
    state = tt._state()
    assert all(p.dtype == torch.float32 for p in state["params"])
    assert all(m.dtype == v.dtype == torch.bfloat16
               for m, v in state["opt_state"])
    assert [tuple(p.shape) for p in state["params"]] == \
        [tuple(s) for s in tt._fl.shapes]
    assert state["num_update"] == 3
