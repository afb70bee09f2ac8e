"""PyTorch port, Switch mixture-of-experts: `cuda_ops.moe_kernels`
(dispatch and combine with their autograd Functions), `parallel.mesh` and
`parallel.moe` against the JAX package on the CPU, float32, from the same
numpy inputs; then the Switch-FFN LM (embedding, `h + moe_apply(h)`, a
Dense head, loss ce + 0.01 aux) trained 3 Adam steps through the port's
`ShardedTrainer` against the JAX package's on a 1-device mesh, from the
same weights.

The JAX side of the kernel tests runs its Pallas kernels in interpret
mode (`MXNET_TPU_PALLAS_INTERPRET=1`, `kernels="auto"`), as its own
kernel tests do; `moe_apply` and the trainer run its einsum path
(`kernels="off"`), which its tests hold equal to the kernel path.

Tolerances: dispatch and combine 1e-6 (a copy and one product per
element); their gradients 1e-5; routing ints exactly, gate and aux 1e-6;
`moe_apply` y and aux 1e-5, gradients 1e-4 relative + 1e-5 (float32
einsums and a softmax summed in other orders); trainer losses and
parameters 1e-5 after three steps.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import mxnet_tpu as mx
from mxnet_tpu import config, nd, parallel
from mxnet_tpu.gluon import HybridBlock, Parameter, nn as gnn
from mxnet_tpu.ndarray import apply_op
from mxnet_tpu.parallel import moe as moe_j

import chip_smoke
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.cuda_ops import moe_kernels as mk_t
from mxnet_tpu_torch.ops import nn_ops
from mxnet_tpu_torch.parallel import mesh as mesh_t
from mxnet_tpu_torch.parallel import moe as moe_t

mk_j = importlib.import_module("mxnet_tpu.pallas_ops.moe_kernels")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    config.set("kernels", "auto")
    yield
    config.reset("kernels")


@pytest.fixture
def kernels_off():
    config.set("kernels", "off")
    yield
    config.reset("kernels")


@pytest.fixture(autouse=True)
def fresh_meshes():
    yield
    parallel.set_mesh(None)
    mesh_t.set_mesh(None)


def _moe_case(N=50, D=40, E=4, C=16, seed=0, dup=True):
    """tests/unittest/test_kernels.py's case: random routing with
    duplicates, invalid (-1) and overflow (>= C) positions; with dup False
    every kept slot holds one token (what moe_route gives)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype(np.float32)
    expert = rng.randint(0, E, N).astype(np.int32)
    pos = rng.randint(-1, C + 2, N).astype(np.int32)
    if not dup:
        expert = (np.arange(N) % E).astype(np.int32)
        pos = (np.arange(N) // E).astype(np.int32) - 1
    gate = rng.rand(N).astype(np.float32)
    return x, expert, pos, gate, E, C


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("dup", [True, False])
def test_dispatch_combine_match_pallas_interpret(interpret, dup):
    x, expert, pos, gate, E, C = _moe_case(dup=dup)
    bj = mk_j.dispatch_to_experts(jnp.asarray(x), jnp.asarray(expert),
                                  jnp.asarray(pos), E, C)
    yj = mk_j.combine_from_experts(bj, jnp.asarray(expert), jnp.asarray(pos),
                                   jnp.asarray(gate))
    bt = mk_t.dispatch_to_experts(_t(x), _t(expert), _t(pos), E, C)
    yt = mk_t.combine_from_experts(bt, _t(expert), _t(pos), _t(gate))
    assert bt.shape == (E, C, x.shape[1]) and bt.dtype == torch.float32
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)
    keep = (pos >= 0) & (pos < C)
    assert not yt.numpy()[~keep].any()           # dropped tokens give zeros
    if not dup:                                  # one token a slot: copies
        got = bt.numpy()[expert[keep], pos[keep]]
        np.testing.assert_array_equal(got, x[keep])


def test_dispatch_gradient_matches_jax_vjp(interpret):
    x, expert, pos, _, E, C = _moe_case()

    def f(x_):
        return jnp.sum(mk_j.dispatch_to_experts(
            x_, jnp.asarray(expert), jnp.asarray(pos), E, C) ** 2)

    gj = jax.grad(f)(jnp.asarray(x))
    xt = _t(x, grad=True)
    (mk_t.dispatch_to_experts(xt, _t(expert), _t(pos), E, C) ** 2) \
        .sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)


def test_combine_gradients_match_jax_vjp(interpret):
    x, expert, pos, gate, E, C = _moe_case()
    buf = np.asarray(mk_j.dispatch_reference(
        jnp.asarray(x), jnp.asarray(expert), jnp.asarray(pos), E, C))

    def f(b_, g_):
        return jnp.sum(mk_j.combine_from_experts(
            b_, jnp.asarray(expert), jnp.asarray(pos), g_) ** 2)

    gbj, ggj = jax.grad(f, argnums=(0, 1))(jnp.asarray(buf),
                                          jnp.asarray(gate))
    bt, gt = _t(buf, grad=True), _t(gate, grad=True)
    (mk_t.combine_from_experts(bt, _t(expert), _t(pos), gt) ** 2) \
        .sum().backward()
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gbj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(ggj), rtol=1e-5,
                               atol=1e-6)


def test_empty_routing_and_cpu_launch_nothing():
    mk_t.launches_dispatch = mk_t.launches_combine = 0
    x = torch.zeros((0, 8))
    e = torch.zeros((0,), dtype=torch.int32)
    buf = mk_t.dispatch_to_experts(x, e, e, 3, 5)
    assert buf.shape == (3, 5, 8) and not buf.any()
    y = mk_t.combine_from_experts(buf, e, e, torch.zeros(0))
    assert y.shape == (0, 8)
    x, expert, pos, gate, E, C = _moe_case()
    xt = _t(x, grad=True)
    mk_t.combine_from_experts(mk_t.dispatch_to_experts(
        xt, _t(expert), _t(pos), E, C), _t(expert), _t(pos), _t(gate)) \
        .sum().backward()
    assert mk_t.launches_dispatch == mk_t.launches_combine == 0


def test_moe_wrappers_refuse_other_devices():
    x = torch.zeros((4, 8), device="meta")
    r = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mk_t.dispatch_to_experts(x, r, r, 2, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        mk_t.combine_from_experts(torch.zeros((2, 2, 8), device="meta"), r,
                                  r, torch.zeros((4,), device="meta"))


def _router_case(N=64, D=16, E=4, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, D).astype(np.float32),
            rng.randn(D, E).astype(np.float32))


@pytest.mark.parametrize("N,E", [(64, 4), (200, 8), (7, 3)])
def test_moe_route_matches_jax(N, E):
    x, router = _router_case(N=N, E=E)
    ej, pj, gj, aj = moe_j.moe_route(jnp.asarray(x), jnp.asarray(router), E)
    et, pt, gt, at = moe_t.moe_route(_t(x), _t(router), E)
    assert et.dtype == pt.dtype == torch.int32
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6, atol=1e-6)


def test_moe_route_takes_the_first_maximum():
    x = np.ones((5, 4), np.float32)
    router = np.zeros((4, 3), np.float32)            # every expert ties
    e, p, g, aux = moe_t.moe_route(_t(x), _t(router), 3)
    assert e.tolist() == [0] * 5 and p.tolist() == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(g.numpy(), 1 / 3, rtol=1e-6)
    ej, pj, _, _ = moe_j.moe_route(jnp.asarray(x), jnp.asarray(router), 3)
    assert np.asarray(ej).tolist() == e.tolist()
    assert np.asarray(pj).tolist() == p.tolist()


@pytest.mark.parametrize("capacity", [2, 5, 40])
def test_moe_dispatch_matches_jax(capacity):
    x, router = _router_case(N=48, E=4)
    dj, cj, aj = moe_j.moe_dispatch(jnp.asarray(x), jnp.asarray(router), 4,
                                    capacity)
    dt, ct, at = moe_t.moe_dispatch(_t(x), _t(router), 4, capacity)
    assert dt.shape == (48, 4, capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


def test_moe_dispatch_capacity_drops():
    """tests/dist/test_ulysses_moe.py's case: every token prefers expert 0
    and capacity 2 keeps exactly 2; the compact routing drops the same."""
    x = torch.ones((5, 4))
    router = torch.zeros((4, 3))
    router[:, 0] = 1.0
    dispatch, _, aux = moe_t.moe_dispatch(x, router, 3, capacity=2)
    assert float(dispatch.sum()) == 2.0
    assert float(aux) > 1.0                          # heavily imbalanced
    _, _, aj = moe_j.moe_dispatch(jnp.asarray(x.numpy()),
                                  jnp.asarray(router.numpy()), 3, capacity=2)
    np.testing.assert_allclose(float(aux), float(aj), rtol=1e-6)
    expert, pos, _, _ = moe_t.moe_route(x, router, 3)
    buf = mk_t.dispatch_to_experts(x, expert, pos, 3, 2)
    assert float((buf.abs().sum(-1) > 0).sum()) == 2.0


def test_mesh_without_a_process_group():
    m = parallel_t.make_mesh()
    assert parallel_t.current_mesh() is m
    assert mesh_t.mesh_axes(m) == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1,
                                   "sp": 1, "tp": 1}
    assert m.group("ep") is None and m.coordinate("ep") == 0
    assert list(mesh_t.mesh_axes(parallel_t.make_mesh(ep=1))) == \
        ["pp", "dp", "fsdp", "ep", "sp", "tp"]
    with pytest.raises(ValueError, match="needs 2 devices"):
        parallel_t.make_mesh(ep=2)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_t.MeshPlan(dp=-1, tp=3).resolve(4)
    assert mesh_t.MeshPlan(dp=-1, ep=2).resolve(8)["dp"] == 4
    mesh_t.set_mesh(None)
    assert mesh_t.current_mesh().shape["dp"] == 1


def _moe_weights(N=32, D=16, F=24, E=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, D).astype(np.float32),
            rng.randn(D, E).astype(np.float32),
            (rng.randn(E, D, F) * 0.1).astype(np.float32),
            (rng.randn(E, F, D) * 0.1).astype(np.float32))


_ACTS = {"gelu": (jax.nn.gelu, nn_ops.gelu),
         "relu": (jax.nn.relu, torch.relu)}


@pytest.mark.parametrize("act", sorted(_ACTS))
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_matches_jax_on_one_device(kernels_off, act, cf):
    """y, aux and the gradients of sum(y^2) + aux in x, router, w1 and w2;
    capacity factor 0.5 drops about half of the tokens."""
    arrays = _moe_weights()
    act_j, act_t = _ACTS[act]
    mesh = Mesh(np.array(jax.devices()[:1]), ("ep",))

    def loss_j(*a):
        y, aux = moe_j.moe_apply(*a, mesh=mesh, capacity_factor=cf,
                                 activation=act_j)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (yj, aj)), gj = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3), has_aux=True))(
            *[jnp.asarray(a) for a in arrays])
    ts = [_t(a, grad=True) for a in arrays]
    yt, at = moe_t.moe_apply(*ts, capacity_factor=cf, activation=act_t)
    ((yt ** 2).sum() + at).backward()
    assert yt.shape == arrays[0].shape and yt.dtype == torch.float32
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(at.detach()), float(aj), rtol=1e-5,
                               atol=1e-5)
    for name, t, g in zip(("x", "router", "w1", "w2"), ts, gj):
        assert np.abs(np.asarray(g)).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_moe_apply_bfloat16_keeps_the_dtype():
    arrays = _moe_weights()
    ts = [_t(a).bfloat16() for a in arrays]
    y, aux = moe_t.moe_apply(*ts)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    y32, _ = moe_t.moe_apply(*[t.float() for t in ts])
    torch.testing.assert_close(y.float(), y32.bfloat16().float())


# -- the Switch-FFN LM ---------------------------------------------------------

_LM = dict(V=128, D=64, F=128, E=4)


def _jax_switch_lm(V, D, F, E):
    """The Switch-FFN LM of __graft_entry__.py's `_dryrun_moe` on a
    1-device mesh (so without its sharding annotations)."""

    class _MoELM(HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.embed = gnn.Embedding(V, D)
            self.router_w = Parameter("router_w", shape=(D, E))
            self.moe_w1 = Parameter("moe_w1", shape=(E, D, F))
            self.moe_w2 = Parameter("moe_w2", shape=(E, F, D))
            self.head = gnn.Dense(V, in_units=D, flatten=False)

        def forward(self, toks):
            h = self.embed(toks)
            B, T, _ = h.shape

            def _moe(hf, r, w1, w2):
                y, aux = moe_j.moe_apply(hf.reshape(B * T, D), r, w1, w2,
                                         axis_name="ep")
                return y.reshape(B, T, D), aux

            y, aux = apply_op(_moe, h, self.router_w.data(),
                              self.moe_w1.data(), self.moe_w2.data())
            return self.head(h + y), aux

    return _MoELM()


def _jax_loss(logits, aux, lb):
    def f(lg, aux_, lb_):
        logp = jax.nn.log_softmax(lg.astype(jnp.float32), -1)
        ce = -jnp.mean(jnp.take_along_axis(
            logp, lb_.astype(jnp.int32)[..., None], -1))
        return ce + 0.01 * aux_

    return apply_op(f, logits, aux, lb)


def _lm_batches(V, n=3, B=8, T=16):
    out = []
    for i in range(n):
        toks = np.random.RandomState(i).randint(0, V, (B, T)) \
            .astype(np.int32)
        out.append((toks, np.roll(toks, 1, axis=1).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def switch_runs():
    """Three Adam steps (lr 1e-3) of each trainer from the same weights on
    the same batches: (JAX losses, JAX params, port losses, port params,
    port trainer, start weights)."""
    config.set("kernels", "off")
    try:
        parallel.make_mesh(devices=jax.devices()[:1])
        mx.random.seed(0)
        jm = _jax_switch_lm(**_LM)
        jm.initialize()
        arrays = {k: np.asarray(p.data()._data)
                  for k, p in jm.collect_params().items()}
        jt = parallel.ShardedTrainer(jm, _jax_loss, "adam",
                                     {"learning_rate": 1e-3})
        bs = _lm_batches(_LM["V"])
        jl = [float(jt.step([nd.array(t)], [nd.array(lb)]).asscalar())
              for t, lb in bs]
        jw = {n: np.asarray(w) for n, w in zip(jt._names, jt.params)}
    finally:
        config.reset("kernels")
        parallel.set_mesh(None)
    tm = chip_smoke.build_switch_lm(**_LM, dtype="float32", seed=0,
                                    device="cpu")
    weights.load_named_arrays(tm, arrays)
    tt = parallel_t.ShardedTrainer(tm, chip_smoke.switch_lm_loss, "adam",
                                   {"learning_rate": 1e-3}, device="cpu")
    tl = [float(tt.step([t], [lb])) for t, lb in bs]
    tw = {n: w.detach().numpy() for n, w in zip(tt._names, tt.params)}
    mesh_t.set_mesh(None)
    return jl, jw, tl, tw, tt, arrays


def test_switch_lm_has_the_jax_parameter_names(switch_runs):
    _, jw, _, tw, tt, arrays = switch_runs
    assert set(tw) == set(jw) == set(arrays) == {
        "embed.weight", "router_w", "moe_w1", "moe_w2", "head.weight",
        "head.bias"}
    assert len(tt.params) == 6


def test_switch_lm_adam_losses_match(switch_runs):
    jl, _, tl, _, _, _ = switch_runs
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert tl[-1] < tl[0]


def test_switch_lm_adam_params_match(switch_runs):
    _, jw, _, tw, _, arrays = switch_runs
    for name in sorted(jw):
        np.testing.assert_allclose(tw[name], jw[name], atol=1e-5, rtol=0,
                                   err_msg=name)
        assert not np.array_equal(jw[name], arrays[name]), name


def test_switch_lm_forward_drops_by_capacity():
    """The model's forward returns the aux loss beside the logits; the
    routing of its tokens keeps at most C per expert."""
    tm = chip_smoke.build_switch_lm(**_LM, dtype="float32", seed=3,
                                    device="cpu")
    toks = torch.from_numpy(_lm_batches(_LM["V"], n=1)[0][0])
    logits, aux = tm(toks)
    assert logits.shape == (8, 16, _LM["V"]) and float(aux) > 0
    h = tm.embed(toks).reshape(-1, _LM["D"])
    expert, pos, _, _ = moe_t.moe_route(h, tm.router_w, _LM["E"])
    C = int(128 * 1.25 / _LM["E"])
    assert int((pos < C).sum()) <= C * _LM["E"]
    assert np.bincount(expert.numpy()[pos.numpy() < C]).max() <= C
