"""PyTorch port, kernel modules: the plain versions that CPU tensors
run, held against the JAX package's kernels and references.

The same numpy inputs (from a seed) go through both packages. The JAX
side runs its Pallas kernels in interpret mode
(MXNET_TPU_PALLAS_INTERPRET=1), as the JAX package's own kernel tests
do, and its plain references. Tolerances: paged attention rtol/atol
2e-6 (both sides are float32 reductions of the same expression), flash
attention atol 1e-5 (the Pallas kernel's 128-key tiles sum in another
order than one softmax), the flash backward atol 2e-5 (a few more
float32 products per element), the LAMB passes rtol 2e-6 / atol 2e-7 as
the JAX package's own kernel-vs-XLA test holds them (sums of squares
rtol 1e-5: 512-lane rows summed in another order), Adam rtol 2e-6 /
atol 2e-7 in float32 (the same elementwise expression; XLA may contract
a multiply-add that torch rounds twice) and one bf16 ulp for a bf16
weight, the int8 matmul rtol/atol 1e-6 (an exact int32 product, then one
float32 rescale and bias add on both sides). The dropout keep mask is
compared bit for bit. CPU tensors never launch a CUDA kernel.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu_torch.cuda_ops import flash_attention as fa_t
from mxnet_tpu_torch.cuda_ops import fused_update as fu_t
from mxnet_tpu_torch.cuda_ops import int8_matmul as im_t
from mxnet_tpu_torch.cuda_ops import paged_attention as pa_t
from mxnet_tpu_torch.parallel import FusedLamb as FusedLambT

fa_j = importlib.import_module("mxnet_tpu.pallas_ops.flash_attention")
fu_j = importlib.import_module("mxnet_tpu.pallas_ops.fused_update")
pa_j = importlib.import_module("mxnet_tpu.pallas_ops.paged_attention")
fl_j = importlib.import_module("mxnet_tpu.parallel.fused_lamb")
im_j = importlib.import_module("mxnet_tpu.pallas_ops.int8_matmul")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- paged attention ---------------------------------------------------------

_PAGED = {"small": dict(B=3, H=4, D=16, ps=8, n_pg=4, P=20),
          "serving_widths": dict(B=4, H=12, D=64, ps=16, n_pg=6, P=30),
          "page_of_one": dict(B=2, H=2, D=8, ps=1, n_pg=9, P=12)}


def _paged_case(B, H, D, ps, n_pg, P, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, 1, D).astype(np.float32)
    kp = rng.randn(P, H, ps, D).astype(np.float32)
    vp = rng.randn(P, H, ps, D).astype(np.float32)
    tables = rng.randint(0, P, (B, n_pg)).astype(np.int32)
    t = rng.randint(0, n_pg * ps, (B,)).astype(np.int32)
    t[0] = n_pg * ps - 1
    return q, kp, vp, tables, t


@pytest.mark.parametrize("case", sorted(_PAGED))
def test_paged_plain_matches_jax_reference(case):
    arrs = _paged_case(**_PAGED[case])
    ref = pa_j.paged_attention_reference(*[jnp.asarray(a) for a in arrs])
    got = pa_t.paged_attention(*[_t(a) for a in arrs])
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("case", ["small", "serving_widths"])
def test_paged_plain_matches_pallas_interpret(interpret, case):
    arrs = _paged_case(**_PAGED[case], seed=1)
    pa_j._load_pallas()
    ref = pa_j._paged_attention_pallas(*[jnp.asarray(a) for a in arrs])
    got = pa_t.paged_attention(*[_t(a) for a in arrs])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)


def test_paged_plain_bf16_keeps_dtype():
    q, kp, vp, tables, t = (_t(a) for a in _paged_case(**_PAGED["small"]))
    got = pa_t.paged_attention(q.bfloat16(), kp.bfloat16(), vp.bfloat16(),
                               tables, t)
    ref = pa_t.paged_attention(q, kp, vp, tables, t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=2e-2)


# -- flash attention ---------------------------------------------------------

# (Lq, Lk, causal, padding mask); block-aligned for the Pallas kernel
_FLASH_ALIGNED = {"causal": (256, 256, True, False),
                  "plain": (256, 256, False, False),
                  "padded": (256, 256, False, True),
                  "causal_lq_lt_lk": (128, 256, True, False)}
# ragged lengths, against the dense reference
_FLASH_RAGGED = {"causal_77": (77, 77, True, False),
                 "padded_300": (300, 300, False, True),
                 "causal_padded_130": (130, 130, True, True),
                 "causal_lq_lt_lk": (100, 300, True, False)}


def _flash_case(Lq, Lk, padded, B=2, H=2, D=32, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Lq, D).astype(np.float32)
    k = rng.randn(B, H, Lk, D).astype(np.float32)
    v = rng.randn(B, H, Lk, D).astype(np.float32)
    mask = None
    if padded:
        mask = np.ones((B, Lk), bool)
        mask[1, Lk * 2 // 3:] = False
    return q, k, v, mask


@pytest.mark.parametrize("case", sorted(_FLASH_ALIGNED))
def test_flash_plain_matches_pallas_interpret(interpret, case):
    Lq, Lk, causal, padded = _FLASH_ALIGNED[case]
    q, k, v, mask = _flash_case(Lq, Lk, padded)
    ref = fa_j.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal,
        block_q=128, block_k=128)
    got = fa_t.flash_attention(_t(q), _t(k), _t(v),
                               None if mask is None else _t(mask),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_flash_lse_matches_pallas_interpret(interpret):
    q, k, v, mask = _flash_case(256, 256, True)
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)
    fa_j.has_pallas()
    _, lse = fa_j._flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.zeros((1,), jnp.int32), True, 1.0 / np.sqrt(32), 128, 128, 0.0)
    _, got = fa_t.flash_fwd(_t(q), _t(k), _t(v), _t(bias), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[:, 0, :],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(_FLASH_RAGGED))
def test_flash_plain_matches_mha_reference(case):
    Lq, Lk, causal, padded = _FLASH_RAGGED[case]
    q, k, v, mask = _flash_case(Lq, Lk, padded, seed=2)
    bias = None
    if mask is not None:
        bias = jnp.where(jnp.asarray(mask), 0.0, -1e30)[:, None, None, :]
    ref = fa_j.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=bias, causal=causal)
    got = fa_t.flash_attention(_t(q), _t(k), _t(v),
                               None if mask is None else _t(mask),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_flash_dropout_raises():
    """A dropout rate outside [0, 1) is refused."""
    q, k, v, _ = _flash_case(8, 8, False)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout"):
            fa_t.flash_attention(_t(q), _t(k), _t(v), dropout=rate, seed=1)


def test_flash_dropout_without_seed_is_off():
    """As in the JAX package (no dropout key), no seed means no dropout."""
    q, k, v, _ = _flash_case(16, 16, False)
    np.testing.assert_array_equal(
        fa_t.flash_attention(_t(q), _t(k), _t(v), dropout=0.5).numpy(),
        fa_t.flash_attention(_t(q), _t(k), _t(v)).numpy())


def test_cpu_tensors_never_launch_a_kernel():
    fa_t.launches = fa_t.launches_dq = fa_t.launches_dkv = 0
    pa_t.launches = 0
    fu_t.launches_pass1 = fu_t.launches_pass2 = 0
    q, k, v, mask = _flash_case(40, 40, True)
    qt = _t(q).requires_grad_(True)
    out = fa_t.flash_attention(qt, _t(k), _t(v), _t(mask), causal=True,
                               dropout=0.1, seed=3)
    out.sum().backward()
    fa_t.flash_fwd(_t(q), _t(k), _t(v), torch.zeros(2, 40))
    pa_t.paged_attention(*[_t(a) for a in _paged_case(**_PAGED["small"])])
    W, G, m, v2, wd, _ = _lamb_rows(4)
    fu_t.lamb_pass1(W, G, m, v2, wd, 0.1, 0.001, **_LAMB_KW)
    fu_t.lamb_pass2(W, m, v2, wd, torch.ones(4), 0.1, 0.001, 0.01,
                    epsilon=1e-6, bias_correction=True)
    assert fa_t.launches == fa_t.launches_dq == fa_t.launches_dkv == 0
    assert pa_t.launches == 0
    assert fu_t.launches_pass1 == fu_t.launches_pass2 == 0


# -- the dropout keep mask ---------------------------------------------------

# Philox-4x32-10 known answers (Random123's kat_vectors): counter, key, out
_PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("i", range(len(_PHILOX_KAT)))
def test_philox_known_answers(i):
    ctr, key, want = _PHILOX_KAT[i]
    got = fa_t._philox4x32_10(*[torch.tensor([c], dtype=torch.int64)
                                for c in ctr], *key)
    assert [int(x) for x in got] == list(want)


def test_keep_mask_pinned_values():
    """Element (bh, row, col) is word col & 3 of Philox at counter
    (col >> 2, row, bh, 0), key (seed lo, seed hi): with seed 0 and
    (bh, row) = (0, 0), columns 0-3 are the first known answer."""
    kat = _PHILOX_KAT[0][2]
    for p in (0.1, 0.5, 0.9):
        thr = fa_t.dropout_threshold(p)
        got = fa_t.dropout_keep_mask(0, 1, 1, 4, p)[0, 0].tolist()
        assert got == [w >= thr for w in kat]
    assert fa_t.dropout_threshold(0.1) == 429496730
    assert fa_t.dropout_threshold(1.0) == 0xFFFFFFFF
    # the high 32 bits of the seed are the key's second word
    seed = (0x299F31D0 << 32) | 0xA4093822
    m = fa_t.dropout_keep_mask(seed, 1, 1, 4, 0.5)
    assert m.shape == (1, 1, 4) and m.dtype == torch.bool


def test_keep_mask_is_deterministic_and_tiling_free():
    seed, p = 0x1234_5678_9ABC_DEF0, 0.1
    whole = fa_t.dropout_keep_mask(seed, 6, 70, 90, p)
    assert torch.equal(whole, fa_t.dropout_keep_mask(seed, 6, 70, 90, p))
    # the mask of a bigger grid, cut down, is the same mask: each element
    # depends on its coordinates alone
    big = fa_t.dropout_keep_mask(seed, 7, 100, 130, p)
    assert torch.equal(big[:6, :70, :90], whole)
    assert not torch.equal(whole, fa_t.dropout_keep_mask(seed + 1, 6, 70,
                                                          90, p))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_four_sigma(p):
    m = fa_t.dropout_keep_mask(77, 8, 128, 128, p)
    n = m.numel()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(float(m.float().mean()) - (1 - p)) < 4 * sigma


# -- the flash backward --------------------------------------------------------

_BWD = {"plain": (64, 64, False, False), "padded": (48, 48, False, True),
        "causal": (40, 40, True, False),
        "causal_lq_lt_lk": (24, 56, True, True)}


def _bwd_case(Lq, Lk, padded, seed=4):
    q, k, v, mask = _flash_case(Lq, Lk, padded, seed=seed)
    g = np.random.RandomState(seed + 1).randn(*q.shape).astype(np.float32)
    bias = np.zeros((q.shape[0], Lk), np.float32) if mask is None \
        else np.where(mask, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias, g


def _plain_bwd(q, k, v, bias, g, causal, dropout=0.0, seed=0):
    out, lse = fa_t.flash_fwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                        causal, dropout=dropout, seed=seed)
    delta = (_t(g) * out).sum(-1).reshape(lse.shape)
    return fa_t.flash_bwd(_t(q), _t(k), _t(v), _t(bias), _t(g), lse, delta,
                          causal, dropout=dropout, seed=seed)


@pytest.mark.parametrize("case", sorted(_BWD))
def test_flash_bwd_plain_matches_jax_grad(case):
    Lq, Lk, causal, padded = _BWD[case]
    q, k, v, bias, g = _bwd_case(Lq, Lk, padded)

    def f(q_, k_, v_):
        return jnp.sum(fa_j.mha_reference(
            q_, k_, v_, bias=jnp.asarray(bias)[:, None, None, :],
            causal=causal) * jnp.asarray(g))

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    got = _plain_bwd(q, k, v, bias, g, causal)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("case", sorted(_BWD))
def test_flash_bwd_plain_matches_torch_autograd(case, dropout):
    """The plain backward's formulas against torch autograd through the
    plain forward, which applies `dropout_keep_mask`."""
    Lq, Lk, causal, padded = _BWD[case]
    q, k, v, bias, g = _bwd_case(Lq, Lk, padded, seed=6)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out, _ = fa_t.flash_fwd_reference(*leaves, _t(bias), causal,
                                      dropout=dropout, seed=99)
    ref = torch.autograd.grad(out, leaves, _t(g))
    got = _plain_bwd(q, k, v, bias, g, causal, dropout=dropout, seed=99)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
    # and the differentiable op routes its backward through flash_bwd
    leaves2 = [_t(x).requires_grad_(True) for x in (q, k, v)]
    mask = None if not padded else _t(bias == 0)
    o2 = fa_t.flash_attention(*leaves2, mask, causal=causal,
                              dropout=dropout, seed=99)
    np.testing.assert_allclose(o2.detach().numpy(), out.detach().numpy(),
                               atol=1e-6)
    o2.backward(_t(g))
    for name, a, b in zip("qkv", leaves2, got):
        np.testing.assert_allclose(a.grad.numpy(), b.numpy(), atol=1e-6,
                                   err_msg=f"d{name}")


def test_flash_fwd_dropout_keeps_the_undropped_lse():
    q, k, v, bias, _ = _bwd_case(32, 32, True)
    o0, l0 = fa_t.flash_fwd_reference(_t(q), _t(k), _t(v), _t(bias))
    o1, l1 = fa_t.flash_fwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                      dropout=0.3, seed=5)
    assert torch.equal(l0, l1)
    assert not torch.allclose(o0, o1)


# -- the LAMB passes ---------------------------------------------------------

_LAMB_KW = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=0.5,
                clip_gradient=1.0, bias_correction=True)


def _lamb_rows(R, seed=0):
    rng = np.random.RandomState(seed)
    W, G, m = (rng.randn(R, 512).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(R, 512)).astype(np.float32) * 0.01
    wd = np.where(np.arange(R) % 2, 0.0, 0.01).astype(np.float32)
    return _t(W), _t(G) * 3, _t(m) * 0.1, _t(v), _t(wd), rng


@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_passes_plain_match_pallas_interpret(interpret, bias_correction):
    R = 32
    W, G, m, v, wd, _ = _lamb_rows(R)
    kw = dict(_LAMB_KW, bias_correction=bias_correction)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    fu_j._load_pallas()
    # copies: the port updates m, v and W in place, and a zero-copy JAX
    # view of them could be read after that by JAX's asynchronous dispatch
    jm, jv, jrw, jru = fu_j.lamb_pass1(
        *[jnp.array(x.numpy()) for x in (W, G, m, v, wd)], c1, c2, **kw)
    rw, ru = fu_t.lamb_pass1(W, G, m, v, wd, c1, c2, **kw)     # m, v in place
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:R], rtol=2e-6,
                               atol=2e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv)[:R], rtol=2e-6,
                               atol=2e-7)
    np.testing.assert_allclose(rw.numpy(), np.asarray(jrw), rtol=1e-5)
    np.testing.assert_allclose(ru.numpy(), np.asarray(jru), rtol=1e-5)
    trust = torch.linspace(0.5, 2.0, R)
    jw = fu_j.lamb_pass2(jnp.array(W.numpy()), jm, jv, jnp.asarray(
        wd.numpy()), jnp.asarray(trust.numpy()), c1, c2, 0.01,
        beta1=0.9, beta2=0.999, epsilon=1e-6,
        bias_correction=bias_correction)
    out = fu_t.lamb_pass2(W, m, v, wd, trust, c1, c2, 0.01, epsilon=1e-6,
                          bias_correction=bias_correction)
    assert out is W                                          # in place
    np.testing.assert_allclose(W.numpy(), np.asarray(jw), rtol=2e-6,
                               atol=2e-7)


_FL_SHAPES = [(64, 32), (100,), (7, 13), (), (3, 600)]


@pytest.mark.parametrize("clip,lo,hi", [(1.0, 0.0, 10.0), (None, 0.5, 0.9),
                                        (None, None, None)])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_fused_lamb_apply_flat_matches_jax(clip, lo, hi, bias_correction):
    """The port's FusedLamb (its plain passes, a segment scatter-add for
    the norms) against the JAX package's apply_flat over three steps:
    wd 0.01 and 0 segments, a ()-shaped parameter, clip and bounds."""
    rng = np.random.RandomState(2)
    wds = [0.01, 0.0, 0.01, 0.0, 0.01]
    args = (0.9, 0.999, 1e-6, bias_correction, 1.0, clip or -1.0,
            lo if lo is not None else -1.0, hi if hi is not None else -1.0)
    fj = fl_j.FusedLamb(_FL_SHAPES, [jnp.float32] * 5, wds, *args)
    ft = FusedLambT(_FL_SHAPES, [torch.float32] * 5, wds, *args)
    ws = [np.asarray(rng.randn(*s), np.float32) for s in _FL_SHAPES]
    ws[1][:] = 0.0                                   # a zero-init segment
    jw = fj.flatten([jnp.asarray(w) for w in ws])
    tw = ft.flatten([torch.from_numpy(np.asarray(w)) for w in ws])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jm = jv = jnp.zeros_like(jw)
    tm, tv = torch.zeros_like(tw), torch.zeros_like(tw)
    for t in (1, 2, 3):
        gs = [np.asarray(rng.randn(*s), np.float32) * 2 for s in _FL_SHAPES]
        jg = fj.flatten([jnp.asarray(g) for g in gs])
        tg = ft.flatten([torch.from_numpy(np.asarray(g)) for g in gs])
        jw, jm, jv = fj.apply_flat(jw, jg, jm, jv, jnp.float32(t),
                                   jnp.float32(0.01))
        out = ft.apply_flat(tw, tg, tm, tv, t, 0.01)
        assert out[0] is tw and out[1] is tm and out[2] is tv
        for name, a, b in (("w", tw, jw), ("m", tm, jm), ("v", tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=2e-7, err_msg=f"step {t} {name}")
    for a, b in zip(ft.unflatten_master(tw), fj.unflatten_master(jw)):
        assert tuple(a.shape) == tuple(b.shape)


# -- Adam / AdamW ------------------------------------------------------------

@pytest.fixture
def kernels_on_every_size():
    """Pallas kernels in interpret mode for every buffer size, as the JAX
    package's own kernel tests run them."""
    from mxnet_tpu import config
    config.set("kernels", "auto")
    config.set("kernels_min_elements", 1)
    yield
    config.reset("kernels")
    config.reset("kernels_min_elements")


_ADAM_SHAPES = [(300,), (7, 13), (), (2, 1024)]


def _adam_state(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    w = np.asarray(rng.randn(*shape), np.float32)
    g = np.asarray(rng.randn(*shape) * 3, np.float32)
    m = np.asarray(rng.randn(*shape) * 0.1, np.float32)
    v = np.abs(np.asarray(rng.randn(*shape), np.float32)) * 0.01
    jw, jg = jnp.asarray(w).astype(dtype), jnp.asarray(g).astype(dtype)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tw, tg = _t(w).to(tdt), _t(g).to(tdt)
    return (jw, jg, jnp.asarray(m), jnp.asarray(v)), (tw, tg, _t(m), _t(v))


def _ulp_close(a, b, dtype, what):
    """float32: rtol 2e-6 / atol 2e-7; bfloat16: one bf16 ulp."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b.astype(jnp.float32) if hasattr(b, "astype") else b,
                   np.float32)
    if dtype == "bfloat16":
        ulp = np.abs(b) * 2.0 ** -7 + 1e-38
        assert (np.abs(a - b) <= ulp).all(), what
    else:
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-7, err_msg=what)


@pytest.mark.parametrize("shape", _ADAM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decoupled,clip,wd", [(False, -1.0, 0.0),
                                               (False, 1.0, 0.01),
                                               (True, 1.0, 0.01),
                                               (True, -1.0, 0.1)])
def test_adam_plain_matches_pallas_interpret(interpret, kernels_on_every_size,
                                             shape, dtype, decoupled, clip,
                                             wd):
    """`adam_update` on CPU tensors (its plain version, in place) against
    the JAX package's `adam_update`, whose `_adam_kernel` runs in
    interpret mode, over three steps."""
    fu_j._load_pallas()
    (jw, jg, jm, jv), (tw, tg, tm, tv) = _adam_state(shape, dtype)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=wd, rescale_grad=0.5,
              clip_gradient=clip, decoupled_wd=decoupled)
    for t in (1, 2, 3):
        lr_t = 1e-2 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        jw, jm, jv = fu_j.adam_update(jw, jg, jm, jv, np.float32(lr_t), **kw)
        out = fu_t.adam_update(tw, tg, tm, tv, float(np.float32(lr_t)), **kw)
        assert out[0] is tw and out[1] is tm and out[2] is tv
        assert tw.dtype == tg.dtype and tm.dtype == torch.float32
        _ulp_close(tw.float().numpy(), jw, dtype, f"w step {t}")
        for name, a, b in (("m", tm, jm), ("v", tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=2e-7, err_msg=f"{name} step {t}")


@pytest.mark.parametrize("decoupled", [False, True])
def test_adam_plain_is_the_jax_reference(decoupled):
    """The plain version against `adam_update_reference` (the JAX
    package's registered optimizer ops), with no clip and eta 0.5."""
    (jw, jg, jm, jv), (tw, tg, tm, tv) = _adam_state((5, 40), "float32", 3)
    kw = dict(beta1=0.8, beta2=0.99, epsilon=1e-6, wd=0.05, rescale_grad=1.0,
              clip_gradient=-1.0, decoupled_wd=decoupled, eta=0.5)
    ref = fu_j.adam_update_reference(jw, jg, jm, jv, 3e-3, **kw)
    got = fu_t.adam_update_reference(tw, tg, tm, tv, 3e-3, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=2e-7)
    # the plain version leaves its inputs alone
    assert torch.equal(tw, _t(np.array(jw)))


def test_adam_is_not_torch_adamw():
    """MXNet's AdamW decays by eta·wd·w, not lr·wd·w as torch.optim does:
    with lr 0 the weight still shrinks."""
    w = torch.ones(4)
    fu_t.adam_update(w, torch.zeros(4), torch.zeros(4), torch.zeros(4), 0.0,
                     wd=0.1, decoupled_wd=True)
    torch.testing.assert_close(w, torch.full((4,), 0.9))


# sizes a list kernel gets wrong first: one element, the n % 4 tails, an
# empty tensor, a 2-D weight and one past a 4,096-element boundary
_ADAM_LIST = [((1,), "float32"), ((3,), "bfloat16"), ((4,), "float32"),
              ((5,), "bfloat16"), ((0,), "float32"), ((7, 13), "float32"),
              ((4097,), "bfloat16"), ((0,), "bfloat16"),
              ((2, 1024), "float32")]


def _adam_list(seed=0):
    """(jax tensors, torch tensors, lrs, wds) of `_ADAM_LIST`: every
    tensor its own lr_t and weight decay."""
    jl, tl = [], []
    for i, (shape, dtype) in enumerate(_ADAM_LIST):
        j, t = _adam_state(shape, dtype, seed + i)
        jl.append(j)
        tl.append(t)
    lrs = [1e-2 * (1 + i / 5) for i in range(len(_ADAM_LIST))]
    wds = [0.01 * i for i in range(len(_ADAM_LIST))]
    return jl, tl, lrs, wds


_ADAM_MULTI_KW = [dict(decoupled_wd=False, clip_gradient=-1.0),
                  dict(decoupled_wd=False, clip_gradient=1.0),
                  dict(decoupled_wd=True, clip_gradient=-1.0),
                  dict(decoupled_wd=True, clip_gradient=1.0)]


@pytest.mark.parametrize("kw", _ADAM_MULTI_KW,
                         ids=["adam", "adam_clip", "adamw", "adamw_clip"])
def test_adam_multi_is_the_plain_version_per_tensor(kw):
    """`adam_update_multi` on a CPU list, in place, equals
    `adam_update_reference` tensor by tensor, bit for bit: float32 and
    bf16 weights in one list, sizes 0, 1, 3, 4, 5 and 4,097, per-tensor
    lr and wd; no kernel launches."""
    _, tl, lrs, wds = _adam_list()
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5, **kw)
    ref = [fu_t.adam_update_reference(w, g, m, v, lr, wd=wd, **kw)
           for (w, g, m, v), lr, wd in zip(tl, lrs, wds)]
    n0 = fu_t.launches_adam
    ws, gs, ms, vs = (list(x) for x in zip(*tl))
    fu_t.adam_update_multi(ws, gs, ms, vs, lrs, wds, **kw)
    assert fu_t.launches_adam == n0
    for (w, _, m, v), (rw, rm, rv) in zip(tl, ref):
        assert w.dtype == rw.dtype and m.dtype == torch.float32
        for a, b in ((w, rw), (m, rm), (v, rv)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw", _ADAM_MULTI_KW,
                         ids=["adam", "adam_clip", "adamw", "adamw_clip"])
def test_adam_multi_is_the_jax_reference(kw):
    """The same list against the JAX package's `adam_update_reference`
    (its registered optimizer ops) per tensor, as
    `test_adam_plain_is_the_jax_reference` holds one tensor: float32
    rtol 2e-6 / atol 2e-7, a bf16 weight within one bf16 ulp."""
    jl, tl, lrs, wds = _adam_list(seed=11)
    kw = dict(beta1=0.8, beta2=0.99, epsilon=1e-6, rescale_grad=0.5, eta=0.5,
              **kw)
    # the JAX side first: its arrays may share the numpy buffers that the
    # in-place update writes
    ref = [[np.asarray(x) for x in fu_j.adam_update_reference(
        jw, jg, jm, jv, lr, kw["beta1"], kw["beta2"], kw["epsilon"], wd,
        kw["rescale_grad"], kw["clip_gradient"],
        decoupled_wd=kw["decoupled_wd"], eta=kw["eta"])]
        for (jw, jg, jm, jv), lr, wd in zip(jl, lrs, wds)]
    ws, gs, ms, vs = (list(x) for x in zip(*tl))
    fu_t.adam_update_multi(ws, gs, ms, vs, lrs, wds, **kw)
    for (shape, dtype), (rw, rm, rv), (tw, _, tm, tv) in zip(
            _ADAM_LIST, ref, tl):
        _ulp_close(tw.float().numpy(), rw, dtype, f"w {shape} {dtype}")
        for name, a, b in (("m", tm, rm), ("v", tv, rv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                       atol=2e-7, err_msg=f"{name} {shape}")


def test_adam_multi_refuses_mixed_lists():
    """A list runs on one device, and its six lists have one length."""
    w = [torch.zeros(4), torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="entry 1"):
        fu_t.adam_update_multi(w, w, w, w, [1e-3] * 2, [0.0] * 2)
    with pytest.raises(ValueError, match="2 weights, 2 gradients"):
        fu_t.adam_update_multi(w, w, w, w, [1e-3], [0.0] * 2)
    fu_t.adam_update_multi([], [], [], [], [], [])


# -- LAMB's conditioning on the tiny BERT (why no device holds one element) --

def _tiny_bert_lamb_step(monkeypatch, perturb):
    """One CPU LAMB step (lr 1e-3, wd 0.01, ε 1e-6) of the tiny BERT and
    batch of `tests/test_torch_cuda.py::
    test_tiny_bert_training_on_card_matches_cpu`, with `perturb` added to
    the gradient of `bert.embed_ln.gamma[11]` where `lamb_pass1` receives
    it. Returns (master after the step, its flat gradient, the element's
    flat index, the slice of the gamma's segment)."""
    from mxnet_tpu_torch import parallel, random as mxrandom
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_tiny_config()
    b = bert.make_synthetic_batch(cfg, 4, 64, 6)
    b["valid_length"][1] = 40
    m = bert.BERTForPretraining(cfg, device="cpu")
    m.initialize(generator=mxrandom.seed(0, "cpu"))
    tr = parallel.ShardedTrainer(m, bert.bert_pretrain_loss, "lamb",
                                 {"learning_rate": 1e-3, "wd": 0.01},
                                 device="cpu")
    k = tr._names.index("bert.embed_ln.gamma")
    seg = slice(tr._fl.offsets[k], tr._fl.offsets[k] + tr._fl.sizes[k])
    idx = seg.start + 11
    grads, pass1 = [], fu_t.lamb_pass1

    def perturbed(W, G, *a, **kw):
        G.view(-1)[idx] += perturb
        grads.append(G.reshape(-1).clone())
        return pass1(W, G, *a, **kw)

    monkeypatch.setattr(fu_t, "lamb_pass1", perturbed)
    tr.step([b[k] for k in ("input_ids", "token_types", "valid_length",
                            "masked_positions")],
            [b[k] for k in ("mlm_labels", "mlm_weights", "nsp_labels")])
    return tr.params.detach().clone(), grads[0], idx, seg


def test_lamb_step_is_ill_conditioned_at_a_near_zero_gradient(monkeypatch):
    """Fault 8's mechanism, on the CPU alone: at step 1 LAMB's update of an
    element is u = m̂/(√v̂ + ε) = g/(|g| + ε), so du/dg = ε/(|g| + ε)², at
    least 1/(4ε) where |g| <= ε. `embed_ln.gamma[11]` of the tiny BERT has
    g = 2.27e-7 there (ε = 1e-6): du/dg ≈ 6.6e5, and with lr 1e-3 and a
    trust ratio near 1 a gradient change of 1.5e-7, the size of a
    card-vs-CPU difference in a near-cancelling float32 sum, moves the
    weight by ~1e-4, the card test's whole tolerance. The other 63
    elements of the segment (|g| ~ 3e-2) move by less than 1e-6, and no
    other segment moves at all. So no implementation could hold that one
    element to 1e-4 against another's."""
    w0, g0, idx, seg = _tiny_bert_lamb_step(monkeypatch, 0.0)
    w1, g1, _, _ = _tiny_bert_lamb_step(monkeypatch, -1.5e-7)
    eps = 1e-6
    assert 0 < abs(float(g0[idx])) < eps
    assert eps / (abs(float(g0[idx])) + eps) ** 2 >= 1 / (4 * eps)
    assert float((g1 - g0).abs().max()) == pytest.approx(1.5e-7, rel=1e-3)
    d = (w1 - w0).abs()
    assert float(d[idx]) > 1e-4
    others = torch.cat([d[seg.start:idx], d[idx + 1:seg.stop]])
    assert float(others.max()) < 1e-6
    assert float(others.max()) > 0            # through the trust ratio
    assert float(d[:seg.start].max()) == float(d[seg.stop:].max()) == 0.0
    # a well-conditioned element given the same nudge barely moves
    far = seg.start + int(torch.argmax(g0[seg].abs()))
    assert abs(float(g0[far])) > 1e4 * eps
    assert eps / (abs(float(g0[far])) + eps) ** 2 * 1.5e-7 * 1e-3 < 1e-6


# -- int8 matmul -------------------------------------------------------------

def _int8_case(M=5, K=96, O=200, lead=(), seed=0):
    """The JAX package's kernel-test case (`tests/unittest/test_kernels.py`)."""
    rng = np.random.RandomState(seed)
    shape = tuple(lead) + (M, K) if lead else (M, K)
    x_q = rng.randint(-127, 128, shape).astype(np.int8)
    w_q = rng.randint(-127, 128, (K, O)).astype(np.int8)
    w_scale = (rng.rand(O) * 0.1 + 1e-3).astype(np.float32)
    bias = rng.randn(O).astype(np.float32)
    return x_q, w_q, np.float32(0.017), w_scale, bias


def _int8_both(x_q, w_q, s_x, w_scale, bias=None, relu=False):
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else _t(bias)
    j_args = (jnp.asarray(x_q), jnp.asarray(w_q), jnp.float32(s_x),
              jnp.asarray(w_scale))
    t_args = (_t(x_q), _t(w_q), float(s_x), _t(w_scale))
    pallas = im_j.int8_matmul(*j_args, bias=jb, relu=relu)
    ref = im_j.int8_matmul_reference(*j_args, bias=jb, relu=relu)
    n0 = im_t.launches
    got = im_t.int8_matmul(*t_args, bias=tb, relu=relu)
    assert im_t.launches == n0
    plain = im_t.int8_matmul_reference(*t_args, bias=tb, relu=relu)
    assert torch.equal(got, plain)
    return got, np.asarray(pallas), np.asarray(ref)


@pytest.mark.parametrize("relu", [False, True])
def test_int8_plain_matches_pallas_interpret(interpret, kernels_on_every_size,
                                             relu):
    got, pallas, ref = _int8_both(*_int8_case(), relu=relu)
    assert got.dtype == torch.float32 and got.shape == (5, 200)
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if relu:
        assert float(got.min()) == 0.0


def test_int8_plain_3d_and_no_bias(interpret, kernels_on_every_size):
    # the decode path shape: (B, 1, E) activations
    x_q, w_q, s_x, w_scale, _ = _int8_case(M=1, K=64, O=96, lead=(3,))
    got, pallas, ref = _int8_both(x_q, w_q, s_x, w_scale)
    assert got.shape == (3, 1, 96)
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_int8_plain_per_tensor_scale_broadcasts(interpret,
                                                kernels_on_every_size):
    x_q, w_q, s_x, _, _ = _int8_case(O=96)
    got, pallas, ref = _int8_both(x_q, w_q, s_x,
                                  np.asarray([0.05], np.float32))
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_int8_plain_product_is_exact():
    """At the widest K of GPT-2 (3072) every product is +-127^2: the
    int32 accumulator must hold 127^2 * 3072 exactly."""
    x_q = np.full((2, 3072), 127, np.int8)
    w_q = np.full((3072, 4), -127, np.int8)
    got = im_t.int8_matmul_reference(_t(x_q), _t(w_q), 1.0,
                                     torch.ones(4))
    assert float(got.min()) == float(got.max()) == -127.0 ** 2 * 3072


def test_int8_rejects_fp_operands():
    with pytest.raises(TypeError, match="int8"):
        im_t.int8_matmul(torch.ones((4, 8)), torch.ones((8, 4),
                                                        dtype=torch.int8),
                         1.0, torch.ones(4))
    with pytest.raises(TypeError, match="int8"):
        im_t.int8_matmul_reference(torch.ones((4, 8), dtype=torch.int8),
                                   torch.ones((8, 4)), 1.0, torch.ones(4))


def test_new_wrappers_refuse_other_devices():
    w = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fu_t.adam_update(w, w, w, w, 1e-3)
    x = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        im_t.int8_matmul(x, torch.zeros((8, 4), dtype=torch.int8,
                                        device="meta"), 1.0,
                         torch.ones(4, device="meta"))
