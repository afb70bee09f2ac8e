"""Port kernels against their plain versions ON THE CARD.

Every test here needs an NVIDIA GPU and is marked `cuda`; without one
each skips with a reason. The file imports neither jax nor mxnet_tpu, so
it runs on a machine with PyTorch for CUDA alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: float32 2e-5 (paged) and 1e-4 (flash forward and backward:
a 64-key tile loop sums in another order than the reference's one
softmax); bfloat16 2e-2 relative to the output's largest magnitude, as
the JAX package's own kernel tests use; LAMB rtol 1e-5 (FMA contraction
and another summation order of the 512-lane rows). The dropout keep
mask, the Adam update (w, m and v: the kernel rounds every operation as
the plain version does), the int8 GEMM's output, MoE combine and MoE
dispatch on routing with one token a slot are compared bit for bit;
MoE dispatch with duplicate slots (summed by float atomics in any
order) at 1e-6. The box_nms keep masks are compared bit for bit (the
kernel rounds each IoU step as the plain version does).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.cuda_ops import flash_attention as fa
from mxnet_tpu_torch.cuda_ops import fused_update as fu
from mxnet_tpu_torch.cuda_ops import int8_matmul as im
from mxnet_tpu_torch.cuda_ops import moe_kernels as mk
from mxnet_tpu_torch.cuda_ops import paged_attention as pa

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(dev, dtype, B=5, H=4, D=64, ps=16, n_pg=8, P=48, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, H, 1, D), dtype=dtype, device=dev)
    kp = torch.tensor(rng.randn(P, H, ps, D), dtype=dtype, device=dev)
    vp = torch.tensor(rng.randn(P, H, ps, D), dtype=dtype, device=dev)
    tables = torch.tensor(rng.randint(0, P, (B, n_pg)), dtype=torch.int32,
                          device=dev)
    t = torch.tensor(rng.randint(0, n_pg * ps, (B,)), dtype=torch.int32,
                     device=dev)
    t[0] = n_pg * ps - 1
    if B > 1:
        t[1] = 0
    return q, kp, vp, tables, t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,ps", [(64, 16), (128, 8), (40, 4), (128, 64),
                                  (64, 40)])
def test_paged_kernel_matches_plain(dev, dtype, D, ps):
    case = _paged_case(dev, dtype, D=D, ps=ps)
    n0 = pa.launches
    got = pa.paged_attention(*case)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(*case)
    assert pa.launches == n0 + 1
    assert got.dtype == dtype and got.shape == ref.shape
    tol = _TOL[dtype][0]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


# flash-decoding shapes: (B, H, D, ps, n_pg, P). The split over pages is
# 8 at B*H = 1 and 12, 4 at B*H = 96 with 64-page tables, 2 with 7 pages
# of 64 positions, 1 at the steady-decode shape and with one page; page
# ids are read from device memory past 1024 pages
_PAGED_SPLIT_SHAPES = [(1, 1, 64, 16, 64, 80), (8, 12, 64, 16, 64, 520),
                       (8, 12, 64, 16, 7, 60), (3, 4, 40, 4, 64, 200),
                       (2, 5, 128, 64, 7, 20), (5, 4, 128, 8, 1, 48),
                       (4, 3, 40, 16, 7, 30), (2, 6, 64, 8, 64, 140),
                       # a table too wide to stage in shared memory
                       (2, 2, 64, 4, 1100, 40)]


def _paged_split_t(B, ps, n_pg):
    """Per-row positions: in the first page, at the end of the first
    page, the last position, t < 0 (every position masked), at and after
    a 16-position unit boundary, mid-table, past the table."""
    L = n_pg * ps
    want = [ps // 2, ps - 1, L - 1, -1, min(47, L - 1), min(48, L - 1),
            L // 2, L + 5]
    return [want[b % len(want)] for b in range(B)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,D,ps,n_pg,P", _PAGED_SPLIT_SHAPES)
def test_paged_kernel_split_over_pages_matches_plain(dev, dtype, B, H, D, ps,
                                                     n_pg, P):
    case = list(_paged_case(dev, dtype, B=B, H=H, D=D, ps=ps, n_pg=n_pg,
                            P=P, seed=B * H + ps))
    case[4] = torch.tensor(_paged_split_t(B, ps, n_pg), dtype=torch.int32,
                           device=dev)
    n0 = pa.launches
    got = pa.paged_attention(*case)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(*case)
    assert pa.launches == n0 + 1
    tol = _TOL[dtype][0]
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_paged_kernel_refuses_what_it_cannot_take(dev):
    q, kp, vp, tables, t = _paged_case(dev, torch.float32)
    bad = [(q[:, :, :, :60].contiguous(), kp, vp, tables, t),   # D mismatch
           (q, kp, vp, tables.long(), t),
           (q, kp.bfloat16(), vp, tables, t),
           (q, kp, vp, tables, t[:2]),
           (q, kp.transpose(2, 3).contiguous().transpose(2, 3), vp,
            tables, t)]
    flat = torch.zeros(kp.numel() + 1, device=dev)
    bad.append((q, flat[1:].view(kp.shape), vp, tables, t))    # off 16 B
    n0 = pa.launches
    for args in bad:
        with pytest.raises(ValueError):
            pa.paged_attention(*args)
    assert pa.launches == n0


def _bias(dev, B, Lk, padded):
    """(B, Lk) additive bias: zeros; padded=True masks the last third of
    batch row 1, padded="all" every key of it."""
    bias = torch.zeros((B, Lk), dtype=torch.float32, device=dev)
    if padded == "all":
        bias[1] = -1e30
    elif padded:
        bias[1, Lk * 2 // 3:] = -1e30
    return bias


def _qkv(dev, dtype, B, H, Lq, Lk, D, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, H, Lq, D), dtype=dtype, device=dev)
    k = torch.tensor(rng.randn(B, H, Lk, D), dtype=dtype, device=dev)
    v = torch.tensor(rng.randn(B, H, Lk, D), dtype=dtype, device=dev)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,D,causal,padded", [
    (256, 256, 64, True, False),
    (300, 300, 64, False, True),
    (100, 300, 64, True, False),
    (77, 77, 128, True, True),
    (65, 130, 40, False, False),
    # the wgmma kernels' edges: one row or key, ragged tiles of 127, 129
    # and 257 (H = 3, so a tile past Lk must not read the next head), head
    # dims 8, 40, 96, 128, Lq > Lk causal (rows 0 and 1 see no key), and
    # a batch row with every key masked
    (1, 1, 64, False, False),
    (1, 129, 64, True, False),
    (127, 127, 8, False, True),
    (129, 127, 40, True, False),
    (257, 129, 96, False, True),
    (129, 257, 128, True, False),
    (257, 1, 64, False, False),
    (127, 257, 64, False, "all"),
])
def test_flash_kernel_matches_plain(dev, dtype, Lq, Lk, D, causal, padded):
    B, H = 2, 3
    q, k, v = _qkv(dev, dtype, B, H, Lq, Lk, D)
    bias = _bias(dev, B, Lk, padded)
    n0 = fa.launches
    out, lse = fa.flash_fwd(q, k, v, bias, causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, bias, causal)
    assert fa.launches == n0 + 1
    assert out.dtype == dtype and lse.shape == (B * H, Lq)
    tol = _TOL[dtype][1]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-4, atol=1e-4)


def test_flash_dropout_raises_on_card(dev):
    q, k, v = _qkv(dev, torch.float32, 1, 1, 8, 8, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, dropout=1.0, seed=1)


def _close(got, ref, dtype, what):
    """float32: atol/rtol 1e-4; bf16: 2e-2 of the reference's scale."""
    scale = max(float(ref.float().abs().max()), 1.0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * scale
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("BH,Lq,Lk", [(3, 70, 130), (24, 64, 64),
                                      (2, 513, 77)])
def test_dropout_mask_kernel_matches_plain_bit_for_bit(dev, BH, Lq, Lk):
    seed = 0xDEADBEEF_12345678
    for p in (0.1, 0.5):
        got = fa.dropout_mask(seed, BH, Lq, Lk, p, dev)
        ref = fa.dropout_keep_mask(seed, BH, Lq, Lk, p, dev)
        assert torch.equal(got, ref)


_BWD_CASES = [(128, 128, 64, False, False), (128, 128, 64, True, False),
              (100, 100, 64, False, True), (77, 77, 128, True, True),
              (64, 192, 64, True, False), (65, 130, 40, False, True),
              # as test_flash_kernel_matches_plain's edges; Lk = 300 takes
              # three 128-key tiles of the forward (and five of dq's 64)
              (1, 129, 64, True, False), (129, 127, 40, True, False),
              (127, 257, 8, False, True), (257, 257, 96, False, "all"),
              (257, 300, 128, False, False),
              # bf16 dkv work items are 192 keys (D <= 64) or 128 keys
              # (D <= 128): Lk that they do not divide, and causal with
              # Lq > Lk (no q tile skipped; early rows see no key)
              (200, 200, 64, False, True), (100, 577, 64, True, False),
              (64, 577, 128, False, True), (300, 200, 64, True, False),
              (250, 130, 128, True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dropout", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("Lq,Lk,D,causal,padded", _BWD_CASES)
def test_flash_fwd_bwd_kernels_match_plain(dev, dtype, dropout, Lq, Lk, D,
                                           causal, padded):
    B, H = 2, 3
    q, k, v = _qkv(dev, dtype, B, H, Lq, Lk, D, seed=Lq + Lk)
    g = torch.tensor(np.random.RandomState(1).randn(B, H, Lq, D),
                     dtype=dtype, device=dev)
    bias = _bias(dev, B, Lk, padded)
    seed = 1234567890123
    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_fwd(q, k, v, bias, causal, dropout=dropout, seed=seed)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, causal, dropout=dropout,
                                      seed=seed)
    _close(out, ro, dtype, "O")
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    delta = (g.float() * ro.float()).sum(-1).reshape(B * H, Lq)
    got = fa.flash_bwd(q, k, v, bias, g, rlse, delta, causal,
                       dropout=dropout, seed=seed)
    torch.cuda.synchronize()
    ref = fa.flash_bwd_reference(q, k, v, bias, g, rlse, delta, causal,
                                 dropout=dropout, seed=seed)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, dtype, name)


def _lengths_bias(dev, lengths, Lk):
    """(B, Lk) padding bias: batch row b keeps its first lengths[b] keys."""
    bias = torch.zeros((len(lengths), Lk), dtype=torch.float32, device=dev)
    for b, n in enumerate(lengths):
        bias[b, n:] = -1e30
    return bias


_SPLIT_TF32_EDGES = [
    # SQuAD-like: 384 keys padded to lengths off the 64-row tiles
    (384, 384, 64, (200, 384), 0.1),
    # D = 72: a head dim between 64 and 96, padded, Lq != Lk
    (130, 200, 72, (200, 131), 0.0),
    (130, 200, 72, (117, 200), 0.1),
    # D = 128 (the other tiling: 64 rows a block, 32-row walked tiles)
    (384, 384, 128, (384, 251), 0.1),
]


@pytest.mark.parametrize("Lq,Lk,D,lengths,dropout", _SPLIT_TF32_EDGES)
def test_flash_fwd_float32_split_tf32_tile_edges(dev, Lq, Lk, D, lengths,
                                                 dropout):
    """The float32 forward (split TF32 on the tensor cores) at the edges
    of its tiling, the backward's grid: padded lengths off the tile grid,
    a head dim that is not a power of two, Lq != Lk, dropout; O and lse
    within 1e-4 of the plain version, one launch."""
    B, H = 2, 3
    q, k, v = _qkv(dev, torch.float32, B, H, Lq, Lk, D, seed=Lq + D)
    bias = _lengths_bias(dev, lengths, Lk)
    seed = 0x5EED_1234_ABCD
    n = fa.launches
    out, lse = fa.flash_fwd(q, k, v, bias, dropout=dropout, seed=seed)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, dropout=dropout,
                                      seed=seed)
    assert out.shape == ro.shape and torch.isfinite(out).all()
    _close(out, ro, torch.float32, "O")
    _close(lse, rlse, torch.float32, "lse")


@pytest.mark.parametrize("Lq,Lk,D,lengths,dropout", _SPLIT_TF32_EDGES)
def test_flash_bwd_float32_split_tf32_tile_edges(dev, Lq, Lk, D, lengths,
                                                  dropout):
    """The float32 dq and dkv (split TF32 on the tensor cores) at the
    edges of their tiling: padded lengths off the tile grid, a head dim
    that is not a power of two, Lq != Lk, dropout; each within 1e-4 of
    the plain version."""
    B, H = 2, 3
    q, k, v = _qkv(dev, torch.float32, B, H, Lq, Lk, D, seed=Lq + D)
    g = torch.tensor(np.random.RandomState(D).randn(B, H, Lq, D),
                     dtype=torch.float32, device=dev)
    bias = _lengths_bias(dev, lengths, Lk)
    seed = 0x5EED_1234_ABCD
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, dropout=dropout,
                                      seed=seed)
    delta = (g * ro).sum(-1).reshape(B * H, Lq)
    args = (q, k, v, bias, g, rlse, delta, False, None, dropout, seed)
    n = (fa.launches_dq, fa.launches_dkv)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (n[0] + 1, n[1] + 1)
    ref = fa.flash_bwd_reference(*args)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert a.shape == r.shape and torch.isfinite(a).all()
        _close(a, r, torch.float32, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_raises_on_misaligned_view(dev, dtype):
    """The kernels load through TMA (bf16) or 16-byte vectors (float32):
    a view whose base is off the 16-byte grid raises, with no copy and no
    fallback."""
    B, H, L, D = 1, 2, 16, 64
    n = B * H * L * D
    q, k, v = _qkv(dev, dtype, B, H, L, L, D)
    bias = _bias(dev, B, L, False)
    bad = torch.zeros(n + 1, dtype=dtype, device=dev)[1:].view(B, H, L, D)
    bad.copy_(q)
    n0 = (fa.launches, fa.launches_dq)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(bad, k, v, bias)
    out, lse = fa.flash_fwd(q, k, v, bias)
    delta = (q.float() * out.float()).sum(-1).reshape(B * H, L)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dq(q, k, v, bias, bad, lse, delta)
    assert (fa.launches, fa.launches_dq) == (n0[0] + 1, n0[1])


def test_autograd_on_card_goes_through_the_kernels(dev):
    q, k, v = (x.requires_grad_(True) for x in
               _qkv(dev, torch.bfloat16, 2, 2, 96, 96, 64))
    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out = fa.flash_attention(q, k, v, dropout=0.1, seed=7)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


@pytest.mark.parametrize("R", [1, 9, 200])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_kernels_match_plain(dev, R, bias_correction):
    rng = np.random.RandomState(R)

    def rows(scale=1.0):
        return torch.tensor(rng.randn(R, 512) * scale, dtype=torch.float32,
                            device=dev)

    W, G, m = rows(), rows(3.0), rows(0.1)
    v = rows(0.1).abs()
    wd = torch.tensor(np.where(np.arange(R) % 2, 0.0, 0.01),
                      dtype=torch.float32, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=0.5,
              clip_gradient=1.0, bias_correction=bias_correction)
    c1, c2 = 1 - 0.9 ** 2, 1 - 0.999 ** 2
    m2, v2 = m.clone(), v.clone()
    n1, n2 = fu.launches_pass1, fu.launches_pass2
    rw, ru = fu.lamb_pass1(W, G, m, v, wd, c1, c2, **kw)
    rrw, rru = fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)
    for a, b in ((m, m2), (v, v2), (rw, rrw), (ru, rru)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    trust = torch.linspace(0.5, 2.0, R, device=dev)
    W2 = W.clone()
    fu.lamb_pass2(W, m, v, wd, trust, c1, c2, 0.01, epsilon=1e-6,
                  bias_correction=bias_correction)
    fu.lamb_pass2_reference(W2, m, v, wd, trust, c1, c2, 0.01, epsilon=1e-6,
                            bias_correction=bias_correction)
    torch.cuda.synchronize()
    torch.testing.assert_close(W, W2, rtol=1e-5, atol=1e-7)
    assert (fu.launches_pass1, fu.launches_pass2) == (n1 + 1, n2 + 1)


# Card-vs-CPU LAMB training: the flat gradient that each step hands to
# LAMB, every element. Step 1 starts from the same weights on both
# devices: float32 sums of up to a few thousand products whose inputs
# already differ (the attention kernels within ~1e-6 of the plain version,
# GEMMs and reductions in other orders), so atol 1e-6. Steps 2 and 3 start
# from weights that differ by up to ~1e-6 after a step, so atol 1e-5.
_TOL_GRAD = [dict(rtol=1e-4, atol=1e-6)] + [dict(rtol=1e-4, atol=1e-5)] * 2


def test_tiny_bert_training_on_card_matches_cpu(dev, monkeypatch):
    """Three float32 LAMB steps of a tiny BERT on the card (flash and LAMB
    kernels) against the same steps on the CPU (plain versions): losses
    within 1e-4, each step's flat gradient within its `_TOL_GRAD`, and
    the final master within atol 1e-4 on every element whose update is
    well conditioned.

    The conditioning: LAMB's update of an element is u = m̂/(√v̂ + ε) (+
    wd·w), at step 1 g/(|g| + ε), so du/dg = ε/(|g| + ε)², at least
    1/(4ε) = 2.5e5 where 0 < |g| < ε = 1e-6, against at most 1/ε where g
    is larger. With lr 1e-3 and a trust ratio near 1, a gradient change
    of 1.5e-7 there (no more than the float32 rounding of a near-
    cancelling sum of 256 rows) moves the weight by ~1e-4: no
    implementation holds such an element to 1e-4 against another's
    (`tests/test_torch_kernels.py::
    test_lamb_step_is_ill_conditioned_at_a_near_zero_gradient` shows it
    on `embed_ln.gamma[11]`, g = 2.27e-7, the element of 99,328 that
    failed 1e-4 about once in ten card runs). So an element whose
    gradient lies in (0, ε) on either device at some step is held by that
    gradient, within `_TOL_GRAD`, instead of by its weight; such elements
    must stay under 0.5% of the master. An element whose gradient is
    exactly 0 on both devices has u = wd·w on both and keeps the 1e-4."""
    from mxnet_tpu_torch import parallel, random as mxrandom
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_tiny_config()
    b = bert.make_synthetic_batch(cfg, 4, 64, 6)
    b["valid_length"][1] = 40
    data = [b[k] for k in ("input_ids", "token_types", "valid_length",
                           "masked_positions")]
    labels = [b[k] for k in ("mlm_labels", "mlm_weights", "nsp_labels")]
    eps = 1e-6                           # LAMB's default epsilon
    grads, pass1 = [], fu.lamb_pass1

    def recorded(W, G, *args, **kw):
        grads.append(G.detach().reshape(-1).cpu().clone())
        return pass1(W, G, *args, **kw)

    monkeypatch.setattr(fu, "lamb_pass1", recorded)
    runs = {}
    for where in ("cpu", "cuda"):
        m = bert.BERTForPretraining(cfg, device="cpu")
        m.initialize(generator=mxrandom.seed(0, "cpu"))
        m.to(where)
        tr = parallel.ShardedTrainer(m, bert.bert_pretrain_loss, "lamb",
                                     {"learning_rate": 1e-3, "wd": 0.01},
                                     device=where)
        assert tr.fopt.opt.epsilon == eps
        n = (fa.launches_dq, fu.launches_pass2)
        del grads[:]
        losses = [float(tr.step(data, labels)) for _ in range(3)]
        if where == "cuda":
            assert fa.launches_dq - n[0] == 3 * cfg["num_layers"]
            assert fu.launches_pass2 - n[1] == 3
        runs[where] = (losses, tr.params.cpu(), torch.stack(grads))
    (lc, wc, gc), (lg, wg, gg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, atol=1e-4)
    for step in range(3):
        torch.testing.assert_close(gg[step], gc[step], **_TOL_GRAD[step],
                                   msg=lambda m: f"step {step + 1}: {m}")
    small = torch.minimum(gg.abs(), gc.abs()) < eps
    ill = (small & ((gg != 0) | (gc != 0))).any(0)
    assert int(ill.sum()) < 0.005 * wc.numel(), int(ill.sum())
    torch.testing.assert_close(wg[~ill], wc[~ill], rtol=0, atol=1e-4)


def test_tiny_gpt_paths_on_card(dev):
    """The serving and generate paths at tiny size on the card, float32:
    pages="on" (paged kernel) serves the tokens of pages="off" (plain
    dense attention), and generate (flash prefill) matches them too."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.models import gpt

    model = gpt.GPTForCausalLM(gpt.gpt_tiny_config())
    model.initialize(generator=mxrandom.seed(0))
    assert model.device.type == "cuda"
    prompts = np.random.RandomState(1).randint(0, 128, (3, 20)) \
        .astype(np.int32)
    out = {}
    for pages in ("on", "off"):
        pa.launches = 0
        srv = serve.Server(model, slots=4, pages=pages, page_size=4,
                           prefill_chunk=4)
        reqs = [srv.submit(p, max_new_tokens=8) for p in prompts]
        srv.drain()
        srv.stop()
        assert all(r.verdict == "200 ok" for r in reqs)
        out[pages] = [list(r.tokens) for r in reqs]
        assert (pa.launches > 0) == (pages == "on")
    assert out["on"] == out["off"]
    fa.launches = 0
    gen = model.generate(prompts, max_new_tokens=8)
    assert fa.launches == len(model.gpt.layers)
    assert gen.tolist() == out["off"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 37, 1000, 1001, 4099])
@pytest.mark.parametrize("decoupled,clip,wd", [(False, -1.0, 0.0),
                                               (False, 0.5, 0.01),
                                               (True, 0.5, 0.01)])
def test_adam_kernel_matches_plain(dev, dtype, n, decoupled, clip, wd):
    """In place, against the plain version, bit for bit; n % 4 != 0
    takes the element-at-a-time tail."""
    rng = np.random.RandomState(n)

    def vec(scale, dt=torch.float32):
        return torch.tensor(rng.randn(n) * scale, device=dev).to(dt)

    w, g = vec(1.0, dtype), vec(3.0, dtype)
    m, v = vec(0.1), vec(0.1).abs()
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=wd, rescale_grad=0.5,
              clip_gradient=clip, decoupled_wd=decoupled)
    rw, rm, rv = fu.adam_update_reference(w, g, m, v, 2e-3, **kw)
    n0 = fu.launches_adam
    out = fu.adam_update(w, g, m, v, 2e-3, **kw)
    torch.cuda.synchronize()
    assert fu.launches_adam == n0 + 1
    assert out[0] is w and out[1] is m and out[2] is v
    for got, ref in ((w, rw), (m, rm), (v, rv)):
        assert torch.equal(got, ref), float((got.float() - ref.float())
                                            .abs().max())


def test_adam_kernel_refuses_what_it_cannot_take(dev):
    w = torch.zeros(8, device=dev)
    m = torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        fu.adam_update(w, torch.zeros(8, device=dev, dtype=torch.bfloat16),
                       m, m.clone(), 1e-3)
    with pytest.raises(ValueError):
        fu.adam_update(w, w.clone(), m.half(), m.clone(), 1e-3)
    with pytest.raises(ValueError):
        big = torch.zeros((4, 4), device=dev)
        fu.adam_update(big.t(), big.clone(), big.clone(), big.clone(), 1e-3)
    n0 = fu.launches_adam
    for which in range(4):                 # one array off the 16-byte grid
        x = [torch.zeros(9, device=dev)[:8] for _ in range(4)]
        x[which] = torch.zeros(9, device=dev)[1:]
        with pytest.raises(ValueError, match="16-byte"):
            fu.adam_update(*x, 1e-3)
    assert fu.launches_adam == n0


# the hostile list: one element, the n % 4 tails, an empty tensor, a
# tensor past two of the kernel's 4,096-element chunks, one of a whole
# chunk, one an element short of it and one of 13 chunks, float32 and
# bf16 weights in one call
_ADAM_SIZES = [1, 3, 4, 5, 4097, 0, 768, 2 * 4096 + 5, 4096, 7, 2, 4095,
               3 * 16384 + 1]


@pytest.mark.parametrize("decoupled,clip", [(False, -1.0), (False, 0.5),
                                            (True, -1.0), (True, 0.5)])
def test_adam_list_kernel_matches_plain(dev, decoupled, clip):
    """`adam_update_multi` on the hostile list, every tensor its own lr
    and wd: w, m and v equal the plain version's per tensor bit for bit,
    in two launches (one a weight dtype)."""
    rng = np.random.RandomState(7)
    ws, gs, ms, vs = [], [], [], []
    for i, n in enumerate(_ADAM_SIZES):
        dt = (torch.float32, torch.bfloat16)[i % 2]
        ws.append(torch.tensor(rng.randn(n), device=dev).to(dt))
        gs.append(torch.tensor(rng.randn(n) * 3, device=dev).to(dt))
        ms.append(torch.tensor(rng.randn(n) * 0.1, dtype=torch.float32,
                               device=dev))
        vs.append(torch.tensor(np.abs(rng.randn(n)) * 0.1,
                               dtype=torch.float32, device=dev))
    lrs = [2e-3 * (1 + i / 7) for i in range(len(_ADAM_SIZES))]
    wds = [0.003 * i for i in range(len(_ADAM_SIZES))]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5,
              clip_gradient=clip, decoupled_wd=decoupled)
    ref = [fu.adam_update_reference(w, g, m, v, lr, wd=wd, **kw)
           for w, g, m, v, lr, wd in zip(ws, gs, ms, vs, lrs, wds)]
    n0 = fu.launches_adam
    fu.adam_update_multi(ws, gs, ms, vs, lrs, wds, **kw)
    torch.cuda.synchronize()
    assert fu.launches_adam == n0 + 2
    for i, (got, want) in enumerate(zip(zip(ws, ms, vs), ref)):
        for a, b in zip(got, want):
            assert torch.equal(a, b), (i, float((a.float() - b.float())
                                                .abs().max()))


def test_adam_list_kernel_splits_a_long_list(dev):
    """700 float32 tensors: two launches (one holds 600 entries), bit for
    bit against the plain version."""
    rng = np.random.RandomState(3)
    sizes = rng.randint(1, 300, 700)
    ws = [torch.tensor(rng.randn(n), dtype=torch.float32, device=dev)
          for n in sizes]
    gs = [torch.randn_like(w) for w in ws]
    ms = [torch.zeros_like(w) for w in ws]
    vs = [torch.zeros_like(w) for w in ws]
    ref = [fu.adam_update_reference(w, g, m, v, 1e-3, wd=0.01)
           for w, g, m, v in zip(ws, gs, ms, vs)]
    n0 = fu.launches_adam
    fu.adam_update_multi(ws, gs, ms, vs, [1e-3] * 700, [0.01] * 700)
    torch.cuda.synchronize()
    assert fu.launches_adam == n0 + 2
    for got, want in zip(zip(ws, ms, vs), ref):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_adam_list_kernel_refuses_and_names_the_entry(dev):
    """A misaligned entry (refused in C), g in another dtype and a tensor
    on another device (refused in Python) raise, name the entry's index
    and launch nothing."""
    def entries():
        return [[torch.zeros(8, device=dev) for _ in range(4)]
                for _ in range(3)]

    misaligned, wrong_dtype, elsewhere = entries(), entries(), entries()
    misaligned[2][3] = torch.zeros(9, device=dev)[1:]
    wrong_dtype[2][1] = wrong_dtype[2][1].bfloat16()
    elsewhere[2][2] = elsewhere[2][2].cpu()
    for what, bad in (("16-byte", misaligned), ("g in w's dtype", wrong_dtype),
                      ("one device", elsewhere)):
        ws, gs, ms, vs = (list(x) for x in zip(*bad))
        n0 = fu.launches_adam
        with pytest.raises(ValueError, match="entry 2") as err:
            fu.adam_update_multi(ws, gs, ms, vs, [1e-3] * 3, [0.0] * 3)
        assert what in str(err.value)
        assert fu.launches_adam == n0


def _int8(dev, shape, seed):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randint(-127, 128, shape), dtype=torch.int8,
                        device=dev)


@pytest.mark.parametrize("M,K,O", [(1, 64, 96), (8, 768, 2304), (17, 96, 200),
                                   (64, 3072, 768), (130, 100, 37),
                                   (5, 48, 7), (300, 768, 3072),
                                   # M <= 16 splits K over a cluster: long
                                   # K, splits that do not divide K, odd O,
                                   # and the path boundary 16 / 17
                                   (1, 3072, 768), (8, 3072, 768),
                                   (16, 3072, 768), (8, 3000, 768),
                                   (8, 100, 768), (8, 3072, 37),
                                   (16, 768, 768), (17, 768, 768)])
@pytest.mark.parametrize("variant", ["bias", "no bias", "relu",
                                     "per-tensor", "bf16 scale"])
def test_int8_kernel_matches_plain_bit_for_bit(dev, M, K, O, variant):
    rng = np.random.RandomState(M * K + O)
    x_q, w_q = _int8(dev, (M, K), 1), _int8(dev, (K, O), 2)
    w_s = torch.tensor(rng.rand(O) * 1e-2 + 1e-4, dtype=torch.float32,
                       device=dev)
    kw = dict(bias=torch.tensor(rng.randn(O), dtype=torch.float32,
                                device=dev))
    s_x = torch.tensor(0.0173, device=dev)
    if variant == "no bias":
        kw = {}
    elif variant == "relu":
        kw["relu"] = True
    elif variant == "per-tensor":
        w_s = w_s[:1].contiguous()
    elif variant == "bf16 scale":
        s_x = s_x.bfloat16()
    n0 = im.launches
    got = im.int8_matmul(x_q, w_q, s_x, w_s, **kw)
    torch.cuda.synchronize()
    ref = im.int8_matmul_reference(x_q, w_q, s_x, w_s, **kw)
    assert im.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (M, O)
    assert torch.equal(got, ref), float((got - ref).abs().max())


def test_int8_kernel_3d_input_and_extreme_values(dev):
    x_q = torch.full((3, 1, 3072), 127, dtype=torch.int8, device=dev)
    w_q = torch.full((3072, 40), -127, dtype=torch.int8, device=dev)
    got = im.int8_matmul(x_q, w_q, 1.0, torch.ones(40, device=dev))
    assert got.shape == (3, 1, 40)
    assert float(got.min()) == float(got.max()) == -127.0 ** 2 * 3072


@pytest.mark.parametrize("M", [1, 8, 16])
def test_int8_split_k_is_exact_at_extreme_values(dev, M):
    """Operands of +-127 and -128 only at K = 3072 (split over 8 blocks at
    O = 768): the int32 partials summed across the cluster equal the
    plain version's product bit for bit."""
    rng = np.random.RandomState(M)
    vals = np.array([127, -127, -128], dtype=np.int8)
    x_q = torch.tensor(vals[rng.randint(0, 3, (M, 3072))], device=dev)
    w_q = torch.tensor(vals[rng.randint(0, 3, (3072, 768))], device=dev)
    w_q[:, :5] = -128
    x_q[0] = -128
    w_s = torch.ones(768, device=dev)
    got = im.int8_matmul(x_q, w_q, 1.0, w_s)
    torch.cuda.synchronize()
    ref = im.int8_matmul_reference(x_q, w_q, 1.0, w_s)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert float(got[0, 0]) == 128.0 ** 2 * 3072


def test_int8_kernel_refuses_what_it_cannot_take(dev):
    x = _int8(dev, (4, 8), 0)
    w = _int8(dev, (8, 4), 1)
    with pytest.raises(TypeError):
        im.int8_matmul(x.float(), w, 1.0, torch.ones(4, device=dev))
    with pytest.raises(ValueError):
        im.int8_matmul(x, _int8(dev, (6, 4), 2), 1.0,
                       torch.ones(4, device=dev))
    with pytest.raises(ValueError):
        im.int8_matmul(x, w.t().contiguous().t(), 1.0,
                       torch.ones(4, device=dev))


_GPT2_GEMMS = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize("M,K,O", [(M, K, O) for M in (17, 64, 65, 512, 1024)
                                   for K, O in _GPT2_GEMMS]
                         + [(17, 96, 200), (300, 96, 200)])
@pytest.mark.parametrize("variant", ["bias", "no bias", "relu",
                                     "per-tensor", "bf16 scale",
                                     "self-transposed"])
def test_int8_wgmma_route_matches_plain_bit_for_bit(dev, M, K, O, variant):
    """M > 16 with K % 16 == 0: the wgmma route on the K-major weight, or
    without it on the wrapper's own transpose (one more, counted launch),
    equal to the plain version bit for bit."""
    rng = np.random.RandomState(M * K + O)
    x_q, w_q = _int8(dev, (M, K), 1), _int8(dev, (K, O), 2)
    w_s = torch.tensor(rng.rand(O) * 1e-2 + 1e-4, dtype=torch.float32,
                       device=dev)
    kw = dict(bias=torch.tensor(rng.randn(O), dtype=torch.float32,
                                device=dev))
    s_x = torch.tensor(0.0173, device=dev)
    if variant == "no bias":
        kw = {}
    elif variant == "relu":
        kw["relu"] = True
    elif variant == "per-tensor":
        w_s = w_s[:1].contiguous()
    elif variant == "bf16 scale":
        s_x = torch.tensor(0.0173, dtype=torch.bfloat16, device=dev)
    given = {} if variant == "self-transposed" else \
        {"w_q_k": w_q.t().contiguous()}
    n0 = (im.launches, im.launches_wgmma, im.launches_transpose,
          im.launches_decode, im.launches_mma)
    got = im.int8_matmul(x_q, w_q, s_x, w_s, **kw, **given)
    torch.cuda.synchronize()
    ref = im.int8_matmul_reference(x_q, w_q, s_x, w_s, **kw)
    n1 = (im.launches, im.launches_wgmma, im.launches_transpose,
          im.launches_decode, im.launches_mma)
    assert n1 == (n0[0] + 1, n0[1] + 1, n0[2] + (not given), n0[3], n0[4])
    assert got.dtype == torch.float32 and got.shape == (M, O)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    if given:
        # the K-major route equals the self-transposed one
        again = im.int8_matmul(x_q, w_q, s_x, w_s, **kw)
        assert torch.equal(got, again)


@pytest.mark.parametrize("M,K,O,misaligned", [(130, 100, 37, False),
                                              (17, 40, 64, False),
                                              (64, 768, 768, True)])
def test_int8_mma_route_where_tma_cannot_address(dev, M, K, O, misaligned):
    """K % 16 != 0, or x off the 16-byte grid: the mma.sync route, with
    its own counter, bit for bit; the K-major weight is not read."""
    x_all = _int8(dev, (M * K + 1,), 3)
    x_q = (x_all[1:] if misaligned else x_all[:-1]).view(M, K)
    w_q = _int8(dev, (K, O), 4)
    w_s = torch.rand(O, device=dev) * 1e-2 + 1e-4
    bias = torch.randn(O, device=dev)
    n0 = (im.launches_mma, im.launches_wgmma, im.launches_transpose)
    got = im.int8_matmul(x_q, w_q, 0.02, w_s, bias=bias,
                         w_q_k=w_q.t().contiguous())
    torch.cuda.synchronize()
    assert (im.launches_mma, im.launches_wgmma, im.launches_transpose) == \
        (n0[0] + 1, n0[1], n0[2])
    ref = im.int8_matmul_reference(x_q, w_q, 0.02, w_s, bias=bias)
    assert torch.equal(got, ref), float((got - ref).abs().max())


def test_int8_wgmma_is_exact_at_extreme_values(dev):
    """+-127 and -128 operands at K = 3072 through the wgmma route."""
    rng = np.random.RandomState(5)
    vals = np.array([127, -127, -128], dtype=np.int8)
    x_q = torch.tensor(vals[rng.randint(0, 3, (200, 3072))], device=dev)
    w_q = torch.tensor(vals[rng.randint(0, 3, (3072, 768))], device=dev)
    x_q[0] = -128
    w_q[:, :5] = -128
    w_s = torch.ones(768, device=dev)
    n0 = im.launches_wgmma
    got = im.int8_matmul(x_q, w_q, 1.0, w_s, w_q_k=w_q.t().contiguous())
    torch.cuda.synchronize()
    assert im.launches_wgmma == n0 + 1
    ref = im.int8_matmul_reference(x_q, w_q, 1.0, w_s)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert float(got[0, 0]) == 128.0 ** 2 * 3072


def test_int8_wgmma_refuses_a_wrong_kmajor_weight(dev):
    x_q, w_q = _int8(dev, (32, 64), 0), _int8(dev, (64, 48), 1)
    w_s = torch.ones(48, device=dev)
    n0 = im.launches
    for w_k in (w_q.contiguous(),                      # (K, O), not (O, K)
                w_q.t(),                               # not contiguous
                w_q.t().contiguous().float()):
        with pytest.raises(ValueError):
            im.int8_matmul(x_q, w_q, 1.0, w_s, w_q_k=w_k)
    assert im.launches == n0


def test_tiny_gpt_adam_training_on_card_matches_cpu(dev):
    """Three float32 Adam steps of a tiny GPT on the card (flash and Adam
    kernels) against the same steps on the CPU (plain versions)."""
    from mxnet_tpu_torch import parallel, random as mxrandom
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny_config()
    b = gpt.make_synthetic_batch(cfg, 4, 48, seed=1)
    b["valid_length"][1] = 30
    b["weights"][1, 30:] = 0.0
    runs = {}
    for where in ("cpu", "cuda"):
        m = gpt.GPTForCausalLM(cfg, device="cpu")
        m.initialize(generator=mxrandom.seed(0, "cpu"))
        m.to(where)
        tr = parallel.ShardedTrainer(m, gpt.gpt_lm_loss, "adamw",
                                     {"learning_rate": 1e-3, "wd": 0.01,
                                      "clip_gradient": 1.0}, device=where)
        n = (fa.launches_dq, fu.launches_adam)
        losses = [float(tr.step([b["input_ids"], b["valid_length"]],
                                [b["labels"], b["weights"]]))
                  for _ in range(3)]
        if where == "cuda":
            # one Adam launch a step: every parameter is float32
            assert {p.dtype for p in tr.params} == {torch.float32}
            assert fa.launches_dq - n[0] == 3 * cfg["num_layers"]
            assert fu.launches_adam - n[1] == 3
        runs[where] = (losses, [p.cpu() for p in tr.params])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    for a, c in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4)


def test_tiny_gpt_int8_serving_on_card(dev):
    """A quantized tiny GPT on the card: every Dense launches the int8
    kernel, and the greedy tokens of `Server(model, slots=2)` equal the
    simulate=True twin's (the JAX package's gate)."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.contrib import quantization as quant
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt_tiny_config()
    out = {}
    for simulate in (False, True):
        m = gpt.GPTForCausalLM(cfg)
        m.initialize(generator=mxrandom.seed(0))
        quant.quantize_block(m, simulate=simulate)
        im.launches = 0
        srv = serve.Server(m, slots=2)
        prompts = np.random.RandomState(3).randint(0, 128, (3, 9)) \
            .astype(np.int32)
        reqs = [srv.submit(p, max_new_tokens=6) for p in prompts]
        srv.drain()
        srv.stop()
        assert all(r.verdict == "200 ok" for r in reqs)
        out[simulate] = [list(r.tokens) for r in reqs]
        assert (im.launches > 0) == (not simulate)
        assert im.launches % (4 * cfg["num_layers"]) == 0
    assert out[False] == out[True]


def _moe_case(dev, N, D, E, C, dup, seed=0, misaligned=False):
    """Routing with duplicates, invalid (-1, E) experts and overflow
    positions, or (dup False) moe_route-like routing: one token a slot,
    the tokens past capacity dropped."""
    rng = np.random.RandomState(seed)
    xs = torch.tensor(rng.randn(N * D + 1), dtype=torch.float32, device=dev)
    x = (xs[1:] if misaligned else xs[:-1]).view(N, D)
    if dup:
        expert = rng.randint(-1, E + 1, N)
        pos = rng.randint(-1, C + 2, N)
    else:
        expert = rng.randint(0, E, N)
        pos = np.array([(expert[:i] == e).sum() for i, e in enumerate(expert)])
    gate = torch.tensor(rng.rand(N), dtype=torch.float32, device=dev)
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa
    return x, as_i32(expert), as_i32(pos), gate


_MOE_SHAPES = [(50, 40, 4, 16), (37, 13, 3, 5), (0, 8, 2, 3), (1, 4, 1, 1),
               (1000, 768, 8, 160), (333, 70, 5, 64)]


@pytest.mark.parametrize("dup", [True, False])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("N,D,E,C", _MOE_SHAPES)
def test_moe_kernels_match_plain(dev, N, D, E, C, dup, misaligned):
    x, expert, pos, gate = _moe_case(dev, N, D, E, C, dup,
                                     misaligned=misaligned)
    n0 = (mk.launches_dispatch, mk.launches_combine)
    buf = mk.dispatch_to_experts(x, expert, pos, E, C)
    y = mk.combine_from_experts(buf, expert, pos, gate)
    torch.cuda.synchronize()
    assert mk.launches_dispatch == n0[0] + 1
    assert mk.launches_combine == n0[1] + (1 if N else 0)
    bref = mk.dispatch_reference(x, expert, pos, E, C)
    yref = mk.combine_reference(buf, expert, pos, gate)
    assert buf.shape == (E, C, D) and y.shape == (N, D)
    if dup:
        torch.testing.assert_close(buf, bref, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(buf, bref)
    assert torch.equal(y, yref)


def test_moe_autograd_on_card_goes_through_the_kernels(dev):
    """The backward passes launch the kernels as the JAX VJPs do: the
    dispatch gradient is a combine, the combine gradient a dispatch (buf)
    and a combine (gate); gradients equal the CPU plain versions'."""
    N, D, E, C = 300, 36, 4, 60
    x, expert, pos, gate = _moe_case(dev, N, D, E, C, dup=False, seed=2)
    w = torch.randn(E, C, D, device=dev)
    grads = {}
    for where in ("cpu", "cuda"):
        xt = x.to(where).requires_grad_(True)
        gt = gate.to(where).requires_grad_(True)
        e, p = expert.to(where), pos.to(where)
        n0 = (mk.launches_dispatch, mk.launches_combine)
        buf = mk.dispatch_to_experts(xt, e, p, E, C) * w.to(where)
        y = mk.combine_from_experts(buf, e, p, gt)
        (y ** 2).sum().backward()
        launched = (mk.launches_dispatch - n0[0], mk.launches_combine - n0[1])
        assert launched == ((2, 3) if where == "cuda" else (0, 0))
        grads[where] = (xt.grad.cpu(), gt.grad.cpu())
    for a, c in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


def test_moe_kernels_refuse_what_they_cannot_take(dev):
    x, expert, pos, gate = _moe_case(dev, 16, 8, 2, 4, dup=False)
    with pytest.raises(ValueError):
        mk.dispatch_to_experts(x.double(), expert, pos, 2, 4)
    with pytest.raises(ValueError):
        mk.dispatch_to_experts(x, expert.long(), pos, 2, 4)
    with pytest.raises(ValueError):
        mk.dispatch_to_experts(x.t().contiguous().t(), expert, pos, 2, 4)
    with pytest.raises(ValueError):
        mk.dispatch_to_experts(x, expert.cpu(), pos, 2, 4)
    buf = mk.dispatch_to_experts(x, expert, pos, 2, 4)
    with pytest.raises(ValueError):
        mk.combine_from_experts(buf, expert, pos, gate.double())
    with pytest.raises(ValueError):
        mk.combine_from_experts(buf.bfloat16(), expert, pos, gate)


def test_tiny_switch_lm_training_on_card_matches_cpu(dev):
    """Three float32 Adam steps of a small Switch-FFN LM on the card
    (dispatch, combine and Adam kernels) against the same steps on the
    CPU: per step 2 dispatch, 3 combine and 1 Adam launch (its 6 float32
    parameters in one list)."""
    import chip_smoke
    from mxnet_tpu_torch import parallel, weights
    lm = dict(V=128, D=64, F=128, E=4)
    base = chip_smoke.build_switch_lm(**lm, seed=0, device="cpu")
    arrays = {k: p.detach().numpy() for k, p in base.collect_params().items()}
    toks = np.random.RandomState(0).randint(0, 128, (8, 16)).astype(np.int32)
    labels = np.roll(toks, 1, axis=1)
    runs = {}
    for where in ("cpu", "cuda"):
        m = chip_smoke.build_switch_lm(**lm, seed=0, device=where)
        weights.load_named_arrays(m, arrays)
        tr = parallel.ShardedTrainer(m, chip_smoke.switch_lm_loss, "adam",
                                     {"learning_rate": 1e-3}, device=where)
        n = (mk.launches_dispatch, mk.launches_combine, fu.launches_adam)
        losses = [float(tr.step([toks], [labels])) for _ in range(3)]
        got = (mk.launches_dispatch - n[0], mk.launches_combine - n[1],
               fu.launches_adam - n[2])
        assert got == ((6, 9, 3) if where == "cuda" else (0, 0, 0))
        runs[where] = (losses, [p.cpu() for p in tr.params])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    for a, c in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4)


def _tiny_bert_large(remat, dropout):
    from mxnet_tpu_torch.models import bert
    return bert.bert_large_config(vocab_size=128, units=128, hidden_size=256,
                                  num_layers=3, num_heads=2, max_length=64,
                                  dropout=dropout, remat=remat)


def test_remat_on_card_is_bit_equal_and_replays_flash_seeds(dev,
                                                            monkeypatch):
    """BERT with per-layer remat and dropout 0.1 (hidden and attention)
    on the card: loss and every gradient equal the run without remat bit
    for bit over two steps, and each recomputed flash forward launches
    with the seed of the layer's first forward."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert
    seeds = []
    fwd = fa.flash_fwd

    def recording(*args, **kw):
        seeds.append(args[7] if len(args) > 7 else kw.get("seed"))
        return fwd(*args, **kw)

    monkeypatch.setattr(fa, "flash_fwd", recording)
    init = bert.BERTForPretraining(_tiny_bert_large(False, 0.1),
                                   device="cpu")
    init.initialize(generator=mxrandom.seed(0, "cpu"))
    state = {k: p.detach() for k, p in init.collect_params().items()}
    b = bert.make_synthetic_batch(init.cfg, 4, 64, 6, seed=1)
    data = tuple(torch.from_numpy(b[k]).to(dev) for k in
                 ("input_ids", "token_types", "valid_length",
                  "masked_positions"))
    labels = [torch.from_numpy(b[k]).to(dev) for k in
              ("mlm_labels", "mlm_weights", "nsp_labels")]
    runs = {}
    for remat in (False, True):
        m = bert.BERTForPretraining(_tiny_bert_large(remat, 0.1),
                                    device="cpu")
        m.load_state_dict(state)
        m.to(dev)
        mxrandom.seed(11, dev)
        steps = []
        for _ in range(2):
            seeds.clear()
            n = fa.launches
            leaves = {k: p.detach().clone().requires_grad_(True)
                      for k, p in m.collect_params().items()}
            m.train()
            outs = torch.func.functional_call(m, leaves, data)
            loss = bert.bert_pretrain_loss(*outs, *labels)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            m.eval()
            torch.cuda.synchronize()
            steps.append((loss.detach(), grads, list(seeds),
                          fa.launches - n))
        runs[remat] = steps
    for (l0, g0, s0, n0), (l1, g1, s1, n1) in zip(runs[False], runs[True]):
        assert torch.equal(l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        assert (n0, n1) == (3, 6)
        assert s1[:3] == s0 and s1[3:] == s0[::-1]      # backward order
        assert len(set(s0)) == 3
    assert runs[True][0][2] != runs[True][1][2]       # fresh seeds a step


def test_small_resnet_sgd_on_card_matches_cpu(dev):
    """Three float32 SGD steps (momentum 0.9, wd 1e-4, grad accumulation
    2) of a small ResNet v1 on the card (cuDNN, TF32 off) against the
    same steps on the CPU: losses, parameters and running statistics
    within 1e-4; no repo kernel launches."""
    from mxnet_tpu_torch import parallel, weights
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.models import resnet

    def net():
        return resnet.ResNetV1(resnet.BottleneckV1, [1, 1], [8, 16, 32],
                               classes=10, device="cpu")

    rng = np.random.RandomState(0)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    start = net()
    start.initialize(generator=mxrandom.seed(1, "cpu"))
    with torch.no_grad():
        start(torch.from_numpy(x))
    arrays = {k: p.detach().numpy().copy()
              for k, p in start.collect_params().items()}
    lfn = gloss.SoftmaxCrossEntropyLoss()
    runs = {}
    for where in ("cpu", "cuda"):
        m = weights.load_named_arrays(net(), arrays).to(where)
        tr = parallel.ShardedTrainer(
            m, lambda o, l: lfn(o, l), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
            device=where)
        tr.set_grad_accum(2)
        n = (fa.launches, fu.launches_adam, fu.launches_pass1)
        losses = [float(tr.step([x], [y])) for _ in range(3)]
        assert (fa.launches, fu.launches_adam, fu.launches_pass1) == n
        state = {k: p.detach().cpu() for k, p in m.collect_params().items()
                 if "running" in k}
        state.update({k: w.cpu() for k, w in zip(tr._names, tr.params)})
        runs[where] = (losses, state)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    for k, v in runs["cpu"][1].items():
        torch.testing.assert_close(runs["cuda"][1][k], v, rtol=0, atol=1e-4)


def test_lamb_kernels_past_2_to_26_elements(dev):
    """Both LAMB passes on a flat master of more than 2^26 elements
    against their plain versions."""
    R = (1 << 26) // 512 + 1001
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def rows(scale):
        return torch.randn((R, 512), generator=gen, device=dev) * scale

    W, G, m = rows(0.05), rows(1e-3), rows(1e-4)
    v = rows(1e-4).square()
    wd = torch.where(torch.arange(R, device=dev) % 3 > 0, 0.01, 0.0)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=True)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    m2, v2 = m.clone(), v.clone()
    rw, ru = fu.lamb_pass1(W, G, m, v, wd, c1, c2, **kw)
    rrw, rru = fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)
    for a, b in ((m, m2), (v, v2), (rw, rrw), (ru, rru)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    trust = torch.rand(R, generator=gen, device=dev) + 0.5
    W2 = W.clone()
    fu.lamb_pass2(W, m, v, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                  bias_correction=True)
    fu.lamb_pass2_reference(W2, m, v, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                            bias_correction=True)
    torch.cuda.synchronize()
    assert W.numel() > 1 << 26
    torch.testing.assert_close(W, W2, rtol=1e-5, atol=1e-7)


def _padding_bias(dev, lens, Lk):
    keys = torch.arange(Lk, device=dev)[None, :] < torch.tensor(
        lens, device=dev)[:, None]
    return torch.where(keys, 0.0, -1e30).float().contiguous(), keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,causal", [(65, 64, False), (64, 64, False),
                                          (65, 65, True)])
def test_flash_at_nmt_shapes(dev, dtype, Lq, Lk, causal):
    """The Transformer NMT's attention shapes (H 8, D 64): cross-attention
    (65 queries over 64 keys) and the encoder's self-attention with a
    padding bias of sources 16-64 long, the decoder's causal 65 x 65:
    forward and both backward kernels against their plain versions."""
    B, H, D = 4, 8, 64
    q, k, v = _qkv(dev, dtype, B, H, Lq, Lk, D, seed=Lq)
    g = torch.tensor(np.random.RandomState(2).randn(B, H, Lq, D),
                     dtype=dtype, device=dev)
    bias = _padding_bias(dev, [16, 64, 37, 63], Lk)[0] if not causal \
        else _bias(dev, B, Lk, False)
    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_fwd(q, k, v, bias, causal)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, causal)
    _close(out, ro, dtype, "O")
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    delta = (g.float() * ro.float()).sum(-1).reshape(B * H, Lq)
    got = fa.flash_bwd(q, k, v, bias, g, rlse, delta, causal)
    torch.cuda.synchronize()
    ref = fa.flash_bwd_reference(q, k, v, bias, g, rlse, delta, causal)
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b, dtype, name)


def test_flash_op_on_head_views_goes_through_the_kernels(dev):
    """`nn_ops.flash_attention` on the transposed (B, H, L, D) views of
    the NMT's projections: one copy each, then the kernels, forward and
    backward, with the gradients of the plain version."""
    from mxnet_tpu_torch.ops import nn_ops
    B, H, D = 3, 8, 64
    rng = np.random.RandomState(5)
    xq = torch.tensor(rng.randn(B, 65, H * D), device=dev,
                      requires_grad=True)
    xk = torch.tensor(rng.randn(B, 64, H * D), device=dev,
                      requires_grad=True)
    mask = torch.arange(64, device=dev)[None, :] < torch.tensor(
        [64, 20, 41], device=dev)[:, None]

    def heads(x):
        return x.float().reshape(B, x.shape[1], H, D).transpose(1, 2)

    n = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out = nn_ops.flash_attention(heads(xq), heads(xk), heads(xk), mask)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == \
        (n[0] + 1, n[1] + 1, n[2] + 1)
    got = (out.detach(), xq.grad, xk.grad)
    xq2, xk2 = (x.detach().clone().requires_grad_(True) for x in (xq, xk))
    bias = torch.where(mask, 0.0, -1e30).float()
    ro, _ = fa.flash_fwd_reference(heads(xq2), heads(xk2), heads(xk2), bias)
    ro.square().sum().backward()
    for name, a, b in zip(("O", "dxq", "dxk"), got,
                          (ro.detach(), xq2.grad, xk2.grad)):
        _close(a, b, torch.float32, name)


def test_eager_trainer_launches_adam_once_per_dtype(dev):
    """The eager loop on the card: `autograd.record()` + `backward()` +
    `gluon.Trainer(..., "adam").step` on a small TransformerNMT launches 3
    flash forwards, dq and dkv per layer pair and one Adam kernel for its
    88 trainable parameters (all float32), and its NDArrays live on the
    card."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import transformer
    m = transformer.TransformerNMT(50, 60, units=64, hidden_size=128,
                                   num_layers=2, num_heads=4, max_length=32,
                                   dropout=0.1)
    mxrandom.seed(0)
    m.initialize()
    tr = gluon.Trainer(m.collect_params(), "adam", {"learning_rate": 1e-3})
    rng = np.random.RandomState(0)
    src = nd.array(rng.randint(3, 50, (4, 12)))
    tgt = nd.array(rng.randint(3, 60, (4, 13)))
    valid = nd.array([12, 5, 9, 1])
    assert src.context.device_type == "gpu"
    n = (fa.launches, fa.launches_dq, fa.launches_dkv, fu.launches_adam)
    with autograd.record():
        loss = transformer.label_smoothing_loss(m(src, tgt, valid), tgt)
    loss.backward()
    tr.step(1)
    torch.cuda.synchronize()
    assert (fa.launches - n[0], fa.launches_dq - n[1],
            fa.launches_dkv - n[2]) == (6, 6, 6)
    assert len(tr._params) == 88
    assert {p.dtype for p in tr._params} == {torch.float32}
    assert fu.launches_adam - n[3] == 1
    assert np.isfinite(loss.asscalar())
    toks = m.greedy_decode(src, max_len=6, src_valid=valid)
    assert toks.shape[0] == 4 and (toks[:, 0] == 1).all()


def test_nd_array_lands_on_the_card(dev):
    from mxnet_tpu_torch import cpu, gpu, nd
    x = nd.array(np.arange(6.0).reshape(2, 3))
    assert x.context == gpu(torch.cuda.current_device())
    assert x.dtype == np.float32
    for y in (nd.zeros((2,)), nd.ones((2,)), nd.full((2,), 3.0),
              nd.arange(4), x * 2, x.as_in_context(dev)):
        assert y.context.device_type == "gpu"
    assert nd.array([1.0], ctx=cpu()).context.device_type == "cpu"
    np.testing.assert_array_equal((x + 1).asnumpy(),
                                  np.arange(6.0).reshape(2, 3) + 1)


def _nms_case(dev, B, N, n_cls=3, seed=0, invalid_share=0.2):
    """Score-sorted corner boxes on a 6 x 6 field (many overlaps), a
    valid prefix of each row and class ids; some boxes repeat exactly
    (IoU 1) and some are inverted (area 0)."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, N, 2) * 6
    boxes = np.concatenate([xy, xy + rng.rand(B, N, 2) * 2 + 0.05], -1)
    if N > 3:
        boxes[:, 3] = boxes[:, 1]
        boxes[:, 2, 2:] = boxes[:, 2, :2] - 0.5
    valid = np.arange(N)[None, :] < (N * (1 - invalid_share)
                                     * rng.rand(B, 1)).astype(int) + 1
    ids = rng.randint(0, n_cls, (B, N))
    return (torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.tensor(valid, device=dev),
            torch.tensor(ids, dtype=torch.float32, device=dev))


def _rank_cut(keep, max_keep):
    """keep & (rank < max_keep), rank = cumsum(keep) - 1."""
    return keep if max_keep is None else keep & (keep.cumsum(-1) <= max_keep)


def _nms_matches(bn, boxes, valid, ids, thresh, n_sup=None, clamp=True,
                 max_keeps=(None, 1, 100, 400, "N")):
    """The kernel's keep mask at each max_keep ("N": the row count) equals
    the plain version's, one launch a call. The plain loop runs once;
    its max_keep cut is the rank cut that
    `test_torch_detection_ops.py::test_box_nms_keep_reference_cuts_at_max_keep`
    holds the plain version to."""
    want = bn.box_nms_keep_reference(boxes, valid, ids, thresh, n_sup, clamp)
    N = boxes.shape[1]
    for mk in max_keeps:
        mk = N if mk == "N" else mk
        n0 = bn.launches
        got = bn.box_nms_keep(boxes, valid, ids, thresh, n_sup, clamp,
                              max_keep=mk)
        torch.cuda.synchronize()
        assert bn.launches == n0 + 1
        assert got.dtype == torch.bool
        assert torch.equal(got, _rank_cut(want, mk)), (mk, int(
            (got != _rank_cut(want, mk)).sum()))
    return want


# N = 1, not a multiple of 32 or of the kernel's 128-row chunk, the
# YOLOv3-tiny decode's 2,535, and SSD300's 30,120 (one image, and the
# (32, 30,120) of SSD's multibox_detection); max_keep None (the general
# path), 1, 100 (YOLO's topk), 400 (SSD's nms_topk) and N
@pytest.mark.parametrize("B,N,with_ids", [
    (1, 1, True), (1, 1, False), (3, 31, True), (3, 31, False),
    (2, 545, True), (2, 545, False), (4, 2535, True), (4, 2535, False),
    (2, 12000, True), (2, 12000, False), (1, 30120, True),
    (1, 30120, False), (32, 30120, True)])
def test_box_nms_kernel_matches_plain(dev, B, N, with_ids):
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    boxes, valid, ids = _nms_case(dev, B, N)
    ids = ids if with_ids else None
    for n_sup, clamp in ((None, True), (min(N, 100), False)):
        _nms_matches(bn, boxes, valid, ids, 0.45, n_sup, clamp)


def test_box_nms_kernel_edges(dev):
    """All rows invalid; a negative threshold (rows of other classes
    compare as IoU 0 and are suppressed too), with max_keep; no row may
    suppress; NaN boxes (an IoU of NaN is not above the threshold);
    N at the kernel's 128-row chunk and one past it."""
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    boxes, valid, ids = _nms_case(dev, 2, 100)
    none = torch.zeros_like(valid)
    assert not bn.box_nms_keep(boxes, none, ids).any()
    assert not bn.box_nms_keep(boxes, none, ids, max_keep=5).any()
    for thresh, n_sup in ((-0.5, None), (0.3, 0)):
        _nms_matches(bn, boxes, valid, ids, thresh, n_sup,
                     max_keeps=(None, 0, 1, 5, "N"))
    assert bn.box_nms_keep(boxes, valid, ids, -0.5)[:, 1:].sum() == 0
    nan = boxes.clone()
    nan[:, 5::7, 2] = float("nan")
    nan[:, 0, 1] = float("nan")
    for with_ids in (True, False):
        for thresh in (0.3, -0.5):
            _nms_matches(bn, nan, valid, ids if with_ids else None, thresh,
                         max_keeps=(None, 1, 5, "N"))
    for N in (128, 129):
        b, v, i = _nms_case(dev, 3, N, seed=N)
        for with_ids in (True, False):
            _nms_matches(bn, b, v, i if with_ids else None, 0.45,
                         max_keeps=(None, 1, 100, 128, "N"))
    with pytest.raises(ValueError):
        bn.box_nms_keep(boxes.half(), valid, ids)
    with pytest.raises(ValueError):
        bn.box_nms_keep(boxes, valid.float(), ids)
    with pytest.raises(ValueError):
        bn.box_nms_keep(boxes, valid, ids, max_keep=-1)


def test_box_nms_kernel_kept_list_past_shared_memory(dev):
    """More kept rows than the kernel's shared-memory kept list holds
    (2,048): 3,000 disjoint unit squares kept, then 3,000 exact repeats
    (IoU 1) that only rows past the shared-memory list suppress; with
    ids, a quarter of the repeats are of another class and survive."""
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    rng = np.random.RandomState(7)
    half = 3000
    cell = np.arange(half)
    sq = np.stack([cell % 60 * 2.0, cell // 60 * 2.0], -1)
    sq = np.concatenate([sq, sq + 1.0], -1)
    order = rng.permutation(half)
    boxes = np.concatenate([sq, sq[order]])[None].repeat(2, 0)
    ids = rng.randint(0, 3, half)
    ids = np.concatenate([ids, ids[order]])[None].repeat(2, 0)
    ids[:, half:][:, rng.rand(half) < 0.25] += 1
    b = torch.tensor(boxes, dtype=torch.float32, device=dev)
    i = torch.tensor(ids, dtype=torch.float32, device=dev)
    v = torch.ones((2, 2 * half), dtype=torch.bool, device=dev)
    v[1, -100:] = False
    for with_ids in (True, False):
        want = _nms_matches(bn, b, v, i if with_ids else None, 0.5,
                            max_keeps=(None, 2047, 2048, 2500, "N"))
        assert int(want[0, :half].sum()) == half
        assert int(want[0, half:].sum()) == (
            int((i[0, half:] != i[0, order]).sum()) if with_ids else 0)


def test_detection_ops_on_card_match_cpu(dev):
    """box_nms, multibox_detection and SSD's non_max_suppression on CUDA
    tensors launch the kernel once a call and equal the CPU run."""
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import detection_ops as do
    rng = np.random.RandomState(1)
    anchors = do.multibox_prior(torch.zeros(1, 3, 10, 10), sizes=(0.3, 0.15),
                                ratios=(1.0, 2.0, 0.5))
    A = anchors.shape[1]
    logits = torch.tensor(rng.randn(2, 5, A), dtype=torch.float32)
    loc = torch.tensor(rng.randn(2, A * 4) * 0.3, dtype=torch.float32)
    for kw in ({}, {"force_suppress": True, "nms_topk": 20}):
        args = (logits.softmax(1), loc, anchors)
        want = do.multibox_detection(*args, threshold=0.1, **kw)
        n0 = bn.launches
        got = do.multibox_detection(*[a.to(dev) for a in args],
                                    threshold=0.1, **kw)
        assert bn.launches == n0 + 1
        # ids and scores are selections; the boxes pass through exp,
        # whose last bit differs between the card and the CPU
        assert torch.equal(got[..., :2].cpu(), want[..., :2])
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    boxes = anchors[0, :200]
    scores = torch.tensor(rng.rand(200), dtype=torch.float32)
    want = ssd.non_max_suppression(boxes, scores, 0.3, 50)
    got = ssd.non_max_suppression(boxes.to(dev), scores.to(dev), 0.3, 50)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
@pytest.mark.parametrize("varlen", [False, True])
def test_rnn_op_on_card_matches_cpu(dev, mode, varlen):
    """The fused RNN op (ATen's cuDNN RNN, one layer a call; packed
    sequences for variable lengths, a length 0 among them) at 2
    bidirectional layers: outputs, final states and the gradients of x,
    the packed parameters and h0 within 1e-5 of each tensor's largest
    |value| on the CPU run (TF32 off; the weight gradients sum T·N
    products in cuDNN's order: 1.4e-5 apart at magnitudes near 10)."""
    from mxnet_tpu_torch.ops import rnn_ops
    T, N, I, H = 7, 4, 5, 8
    rng = np.random.RandomState(0)
    n = rnn_ops.rnn_param_size(mode, 2, I, H, True)
    arrs = [rng.randn(T, N, I), rng.uniform(-0.3, 0.3, n),
            rng.randn(4, N, H), rng.randn(4, N, H)]
    lens = torch.tensor([1, T, 0, 3]) if varlen else None
    runs = []
    for where in ("cpu", dev):
        x, p, h0, c0 = (torch.tensor(a, dtype=torch.float32, device=where,
                                     requires_grad=True) for a in arrs)
        out = rnn_ops.rnn(x, p, h0, c0 if mode == "lstm" else None, lens,
                          state_size=H, num_layers=2, mode=mode,
                          bidirectional=True, state_outputs=True,
                          use_sequence_length=varlen, _training=False)
        torch.autograd.backward(list(out), [torch.ones_like(o) for o in out])
        runs.append([o.detach().cpu() for o in out]
                    + [t.grad.cpu() for t in (x, p, h0)])
    for got, want in zip(runs[1], runs[0]):
        scale = max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def test_ctc_loss_on_card_matches_cpu(dev):
    """ATen's CUDA CTC against the CPU run: losses (the infeasible label's
    1e30 included) within 1e-5 relative, gradients within 1e-5 (the CUDA
    backward sums with atomics in any order)."""
    from mxnet_tpu_torch.ops import misc_ops
    rng = np.random.RandomState(0)
    x = rng.randn(12, 6, 7).astype(np.float32)
    lab = rng.randint(1, 7, (6, 5)).astype(np.int32)
    lab[0] = [3, 3, 3, 3, 3]                   # 9 frames needed, 4 given
    dlen = np.array([4, 12, 10, 12, 8, 12], np.int32)
    llen = np.array([5, 5, 2, 0, 3, 4], np.int32)
    runs = []
    for where in ("cpu", dev):
        xt = torch.tensor(x, device=where, requires_grad=True)
        loss = misc_ops.ctc_loss(xt, torch.tensor(lab, device=where),
                                 torch.tensor(dlen, device=where),
                                 torch.tensor(llen, device=where),
                                 use_data_lengths=True,
                                 use_label_lengths=True)
        loss.sum().backward()
        runs.append((loss.detach().cpu(), xt.grad.cpu()))
    (lc, gc), (lg, gg) = runs
    assert lc[0].item() == lg[0].item() == np.float32(1e30)
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=0)
    torch.testing.assert_close(gg, gc, rtol=1e-5, atol=1e-5)


def test_deepar_and_crnn_training_on_card_match_cpu(dev):
    """chip_smoke's phase 25: a small float32 DeepAR (eager loop) and CRNN
    (ShardedTrainer, the example's loss_fn) take 3 Adam steps on the card
    and on the CPU: losses and parameters within TOL_TRAIN, one Adam
    launch per weight dtype a step, CRNN decodes equal."""
    import chip_smoke
    chip_smoke.rnn_parity_phase(dev)


def test_speculative_beam_and_ladder_on_card_match_cpu(dev):
    """chip_smoke's phase 30: float32 gpt_tiny and its 1-layer drafter on
    the card and on the CPU: speculative tokens and draft counts equal
    (and equal to plain greedy), beam tokens equal with scores within
    1e-5, the ladder's verdicts equal at capacities from each side's own
    accounting."""
    import chip_smoke
    chip_smoke.serve_parity_phase(dev)


def test_tiny_lifecycle_on_card(dev):
    """Deadline expiry and cancellation on the card's paged server return
    every page; one transient OSError on a dispatch is retried and the
    tokens equal an undisturbed run's."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch import resilience, serve
    from mxnet_tpu_torch.models import gpt

    model = gpt.GPTForCausalLM(gpt.gpt_tiny_config())
    model.initialize(generator=mxrandom.seed(0))
    prompts = [np.random.RandomState(k).randint(0, 128, (k,)).astype(np.int32)
               for k in (9, 6, 7)]
    kw = dict(slots=4, pages="on", page_size=4, prefill_chunk=4)

    def run(**extra):
        clk = {"t": 0.0}
        srv = serve.Server(model, clock=lambda: clk["t"], **kw, **extra)
        reqs = [srv.submit(p, max_new_tokens=20) for p in prompts]
        return srv, reqs, clk

    srv, ref, _ = run()
    srv.drain()
    srv.stop()
    calls = {"n": 0}
    real = model.decode_paged_chunk

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 5:
            raise OSError("transient")
        return real(*args, **kwargs)

    model.decode_paged_chunk = flaky
    try:
        srv, reqs, _ = run(retry=resilience.RetryPolicy(backoff_s=0.001))
        srv.drain()
    finally:
        del model.decode_paged_chunk
    assert srv.stats()["retries"] == 1
    assert [r.tokens for r in reqs] == [r.tokens for r in ref]
    srv.stop()
    srv, reqs, clk = run()
    total = srv._pool.data_pages
    late = srv.submit(prompts[0], max_new_tokens=20, deadline_ms=50)
    for _ in range(6):
        srv.step()
    clk["t"] = 1.0
    srv.cancel(reqs[1])
    srv.drain()
    st = srv.stats()
    assert late.state == serve.EXPIRED and reqs[1].state == serve.CANCELLED
    assert reqs[1].tokens == ref[1].tokens[:len(reqs[1].tokens)]
    assert st["pool_pages_free"] == total - st["tree_nodes"]
    srv.stop()
    assert srv._pool.free_pages() == total


def test_exec_peak_and_capacity_on_card(dev):
    """On the card the budget's capacity is the device's memory and each
    bucket's execution peak is measured (> 0; the heaviest paged chunk
    with a drafter is the full-logits verify); a CPU model has neither."""
    from mxnet_tpu_torch import memsafe, serve
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import gpt

    model = gpt.GPTForCausalLM(gpt.gpt_tiny_config())
    model.initialize(generator=mxrandom.seed(0))
    assert memsafe.capacity_bytes(dev) == torch.cuda.mem_get_info(dev)[1]
    assert memsafe.capacity_bytes("cpu") is None
    dense = serve.Server(model, slots=2)
    paged = serve.Server(model, slots=2, pages="on", page_size=4)
    spec = serve.Server(model, slots=2, pages="on", page_size=4,
                        drafter=model, spec_k=3)
    for srv in (dense, paged, spec):
        assert srv._exec_peak(32) > 0 and srv._exec_peak(64) > 0
    assert (32, 4, True) in spec._peaks and (32, 8, False) in paged._peaks
    hints = paged.admission_hints()
    assert 0 < hints["headroom_bytes"] < memsafe.capacity_bytes(dev)
    cpu = gpt.GPTForCausalLM(gpt.gpt_tiny_config(), device="cpu")
    assert serve.Server(cpu, slots=2)._exec_peak(32) is None


@pytest.mark.parametrize("R", [1, 9, 4097])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_bf16_moment_route_matches_plain(dev, R, bias_correction):
    """Both LAMB passes with bf16 moments against their plain versions:
    the stored moments within 1 bf16 ulp (the kernel rounds the EMA
    operation by operation, as the plain version does), the row sums and
    W at the LAMB tolerance; one launch of each pass."""
    import chip_smoke
    gen = torch.Generator(device=dev)
    gen.manual_seed(R)

    def rows(scale):
        return torch.randn((R, 512), generator=gen, device=dev) * scale

    W, G = rows(0.05), rows(1e-3)
    m = rows(1e-4).bfloat16()
    v = rows(1e-4).square().bfloat16()
    wd = torch.where(torch.arange(R, device=dev) % 3 > 0, 0.01, 0.0)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=bias_correction)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    m2, v2 = m.clone(), v.clone()
    n = (fu.launches_pass1, fu.launches_pass2)
    rw, ru = fu.lamb_pass1(W, G, m, v, wd, c1, c2, **kw)
    rrw, rru = fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)
    assert m.dtype == v.dtype == torch.bfloat16
    assert chip_smoke.bf16_ulp_err(m, m2) <= 1
    assert chip_smoke.bf16_ulp_err(v, v2) <= 1
    for a, b in ((rw, rrw), (ru, rru)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    trust = torch.rand(R, generator=gen, device=dev) + 0.5
    W2 = W.clone()
    fu.lamb_pass2(W, m, v, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                  bias_correction=bias_correction)
    fu.lamb_pass2_reference(W2, m, v, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                            bias_correction=bias_correction)
    torch.cuda.synchronize()
    torch.testing.assert_close(W, W2, rtol=1e-5, atol=1e-7)
    assert (fu.launches_pass1, fu.launches_pass2) == (n[0] + 1, n[1] + 1)
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        fu.lamb_pass1(W, G, m, v.float(), wd, c1, c2, **kw)


def test_remat_policies_bit_equal_on_card(dev):
    """chip_smoke's phase 32 check: a small float32 BERT and GPT, dropout
    0.1, under "dots_saveable", "layers" and "full": losses and
    gradients equal "none"'s bit for bit, the flash forward relaunched
    as each policy recomputes."""
    import chip_smoke
    chip_smoke.policy_bit_equal_phase(dev)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_resume_bit_for_bit_on_card(dev, tmp_path, moments):
    """A tiny BERT (dropout 0.1) trained 3 LAMB steps on the card, saved
    through `resilience.write_checkpoint`, restored into a trainer of
    other weights: its next two steps equal the uninterrupted run's bit
    for bit (the checkpoint carries the device and host streams)."""
    from mxnet_tpu_torch import config, parallel, resilience
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert

    def make(seed):
        cfg = bert.bert_tiny_config(dropout=0.1)
        m = bert.BERTForPretraining(cfg, device=dev)
        m.initialize(generator=mxrandom.seed(seed, dev))
        return parallel.ShardedTrainer(m, bert.bert_pretrain_loss, "lamb",
                                       {"learning_rate": 1e-3, "wd": 0.01},
                                       device=dev), cfg

    config.set("lamb_moments_dtype", moments)
    resilience.enable()
    try:
        tr, cfg = make(0)
        b = bert.make_synthetic_batch(cfg, 4, 32, 5, seed=1)
        x = [b[k] for k in ("input_ids", "token_types", "valid_length",
                            "masked_positions")]
        y = [b[k] for k in ("mlm_labels", "mlm_weights", "nsp_labels")]
        for _ in range(3):
            tr.step(x, y)
        tr.save_states(str(tmp_path / "ck"))
        cont = [float(tr.step(x, y)) for _ in range(2)]
        tr2, _ = make(5)
        tr2.load_states(str(tmp_path / "ck"))
        assert [float(tr2.step(x, y)) for _ in range(2)] == cont
        assert torch.equal(tr.params, tr2.params)
        assert all(a.dtype == getattr(torch, moments) and torch.equal(a, c)
                   for a, c in zip(tr.opt_state, tr2.opt_state))
    finally:
        resilience.disable()
        config.reset()


def test_durable_parity_on_card(dev):
    """chip_smoke's phase 35: bf16-moment LAMB card vs CPU (moments
    within 1 bf16 ulp on the same gradients; a tiny BERT within
    TOL_TRAIN), card-written `.params` and `save_states` files loaded on
    the CPU bit for bit, and the ladder's transitions equal on both."""
    import chip_smoke
    chip_smoke.durable_parity_phase(dev)


def test_zoo_families_on_card_match_cpu(dev):
    """chip_smoke's phase 38 for the vision zoo: each family of
    tests/test_torch_model_zoo.py (`ZOO_PARITY`: sizes, batches and
    frozen BatchNorms), float32, its evaluation logits, loss and every
    parameter after one SGD step of the example's loop within 1e-4 of the
    largest |value| against the CPU run from the same weights."""
    import chip_smoke
    for name, make, size, frozen, batch in chip_smoke.ZOO_PARITY:
        start, lc, losc, ac = chip_smoke.zoo_family_run(
            make, size, frozen, "cpu", batch=batch)
        _, lg, losg, ag = chip_smoke.zoo_family_run(make, size, frozen, dev,
                                                    start, batch)
        errs = [chip_smoke.rel_err(lg, lc), chip_smoke.rel_err(losg, losc)]
        errs += [chip_smoke.rel_err(ag[k], ac[k]) for k in ac]
        assert max(errs) <= chip_smoke.TOL_ZOO, (name, max(errs))


def test_forked_dataloader_after_cuda_init_matches(dev):
    """A DataLoader forked after CUDA is initialised gives exactly the
    batches of num_workers=0, pinned and copied to the card; a worker
    that resolves the card fails with the JAX package's message instead
    of touching CUDA."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import data as gdata
    torch.zeros(1, device=dev)
    assert torch.cuda.is_initialized()
    ds = gdata.vision.CIFAR10(train=True)
    runs = [[(x.asnumpy(), y.asnumpy()) for x, y in gdata.DataLoader(
        ds, batch_size=100, num_workers=w, pin_memory=True)]
        for w in (0, 2)]
    assert len(runs[0]) == len(runs[1]) == 11
    for (a, b), (c, d) in zip(*runs):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    bad = gdata.SimpleDataset(list(range(8))).transform(
        lambda i: nd.array([i]))
    with pytest.raises(RuntimeError, match="CUDA cannot run in a forked"):
        list(gdata.DataLoader(bad, batch_size=4, num_workers=2))


@pytest.mark.parametrize("name", ["reshape", "reshape_split", "transpose",
                                  "pad_reflect", "slice", "take", "pick",
                                  "gather_nd", "scatter_nd",
                                  "sequence_reverse", "boolean_mask"])
def test_shape_ops_on_card_equal_cpu(dev, name):
    import chip_smoke
    cases = {c[0]: c for c in chip_smoke.shape_op_cases(dev)}
    cpu = {c[0]: c for c in chip_smoke.shape_op_cases("cpu")}
    _, fn, args = cases[name]
    g, c = fn(*args), fn(*cpu[name][2])
    g = g if isinstance(g, tuple) else (g,)
    c = c if isinstance(c, tuple) else (c,)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(g, c))


def test_symbolic_executor_flash_path_on_card_matches_cpu(dev):
    """The executor's flash path: a 2-layer symbolic encoder (chip_smoke's
    `bert_symbol`, float32, dropout 0) bound on the card and on the CPU
    to the same weights: forward outputs and every gradient within 1e-4,
    and one forward + backward on the card launches exactly one flash
    forward, dq and dkv a layer."""
    import chip_smoke
    from mxnet_tpu_torch import nd
    tiny = dict(V=128, E=64, F=128, H=4, layers=2, max_len=64)
    _, loss = chip_smoke.bert_symbol(L=32, p=0.0, attn_p=0.0, **tiny)
    b = chip_smoke.sym_bert_batch(4, 32, 5, 128)
    rs = np.random.RandomState(0)
    shapes, _, _ = loss.infer_shape(**{k: b[k].shape for k in b})
    args = {n: (b[n] if n in b else rs.normal(0, 0.1, s).astype(np.float32))
            for n, s in zip(loss.list_arguments(), shapes)}
    res = {}
    for d in (dev, torch.device("cpu")):
        ex = loss.bind(ctx=d, args={n: nd.array(v, ctx=d)
                                    for n, v in args.items()},
                       args_grad={n: nd.zeros(v.shape, ctx=d)
                                  for n, v in args.items() if n not in b})
        chip_smoke.reset_counts()
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        res[d.type] = (out, {n: g.asnumpy() for n, g in ex.grad_dict.items()
                             if g is not None}, chip_smoke.read_counts())
    (o_c, g_c, counts), (o_h, g_h, _) = res["cuda"], res["cpu"]
    assert counts == chip_smoke.expect(flash_attention_fwd=2,
                                       flash_attention_dq=2,
                                       flash_attention_dkv=2)
    np.testing.assert_allclose(o_c, o_h, atol=1e-4)
    for n in g_h:
        np.testing.assert_allclose(g_c[n], g_h[n], atol=1e-4, err_msg=n)


def test_symbolic_module_fit_and_kernel_ops_on_card(dev):
    """chip_smoke's phases 42-43: Module.fit card vs CPU (an MLP with
    BatchNorm and a 2-layer encoder, each under SGD and under Adam:
    weights within TOL_TRAIN, exact launches a step), and the quantized
    dense and box_nms registry ops through `sym` equal to `nd` bit for
    bit, each launching its kernel."""
    import chip_smoke
    chip_smoke.sym_parity_phase(dev)
    chip_smoke.sym_kernel_ops_phase(dev)


def test_eager_lamb_trainer_on_card(dev):
    """chip_smoke's phase 44 parity: a 2-layer float32 BERT trained two
    eager steps with `gluon.Trainer(..., "lamb")` on the card (flash
    kernels, one launch of each LAMB pass a step) and on the CPU:
    losses and parameters within 1e-5."""
    import chip_smoke
    res = chip_smoke.eager_bert_parity_phase(dev, batch=4)
    assert res["launches"]["lamb_pass1"] == res["launches"]["lamb_pass2"] == 2


def test_optimizers_and_eager_lamb_route_on_card(dev, monkeypatch):
    """chip_smoke's phase 45: the 17 optimizers through NDArrays card vs
    CPU within 1e-5 (SGLD around its mode), `nd.adam_update` one launch
    equal to `Adam.update` bit for bit, and LAMB's eager kernel route
    against its plain version (rtol 1e-5) at a smaller embedding."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "EAGER_ROUTE_SHAPE", (4096, 768))
    rows, route = chip_smoke.eager_optimizers_phase(dev)
    assert rows["nd.adam_update"]["bit_equal_to_Adam_update"]
    assert route["max_abs_err"] <= chip_smoke.TOL_LAMB


def test_random_and_indexing_land_on_the_card(dev):
    """nd.random draws on the card from its device stream, seeded; an
    index and an assignment keep the card."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch import random as mxrandom
    mxrandom.seed(3)
    a = nd.random.normal(shape=(1000,))
    mxrandom.seed(3)
    b = nd.random.normal(shape=(1000,))
    assert a.context.device_type == "gpu"
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    x = nd.array(np.arange(12.0).reshape(3, 4))
    x[1] = 0.0
    assert x[1:].context.device_type == "gpu"
    assert x.asnumpy()[1].sum() == 0.0


def test_jax_unit_test_file_on_card(dev):
    """chip_smoke's phase 46 for one file: the JAX package's
    test_optimizer.py unchanged through `run_example --pytest` with the
    card as the default device passes all 20 tests."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.run_example", "--pytest",
         "tests/unittest/test_optimizer.py", "-p", "no:xdist"], cwd=root,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=root))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert (res["passed"], res["failed"]) == (20, 0), res
    assert res["launches"]["fused_update.launches_adam"] > 0


def test_observability_layer_on_card(dev, tmp_path):
    """chip_smoke's phase 47 at a tiny size: a 2-layer BERT (bf16, LAMB)
    two steps with telemetry, trace and diagnostics off and on: the
    losses and launch counts with the layer on equal the off run's, and
    the events, spans and histogram counts equal the same run's on the
    CPU."""
    import chip_smoke
    small = dict(batch=4, seq_len=64, masked=8, vocab_size=128, units=64,
                 hidden_size=128, num_layers=2, num_heads=4, max_length=64)
    off = chip_smoke.obs_bert_run(dev, 2, False, **small)
    on = chip_smoke.obs_bert_run(dev, 2, True, str(tmp_path / "card"),
                                 **small)
    assert on[0] == off[0] and on[1] == off[1]
    assert on[1]["flash_attention_fwd"] == 4 and on[1]["lamb_pass1"] == 2
    cpu = chip_smoke.obs_bert_run(torch.device("cpu"), 2, True,
                                  str(tmp_path / "cpu"), **small)
    for key in ("events", "step_seconds_count", "compile_total", "spans"):
        assert on[3][key] == cpu[3][key], key
    assert on[3]["spans"] == {1: ["step.compile"],
                              2: ["step.dispatch", "step.fence"]}


def test_squad_finetune_on_card(dev):
    """chip_smoke's phase 51 at a smaller size (BERT-base widths, 2
    layers, 4 x 128): `span.weight.grad()` equals torch's gradient, the
    loss falls, and each step launches 2 flash forwards, dq and dkv and
    one Adam update."""
    import chip_smoke
    res, counts = chip_smoke.squad_phase(dev, batch=4, seq_len=128,
                                         warmup=2, steps=3, num_layers=2)
    assert counts["flash_attention_fwd"] == counts["flash_attention_dq"] \
        == counts["flash_attention_dkv"] == 6
    assert counts["adam_update"] == 3
    assert res["span_grad_max_abs_err_vs_torch"] <= 1e-6


def test_finetune_heads_card_matches_cpu(dev):
    """chip_smoke's phase 52 at a smaller size: the QA and classifier
    heads (2 layers at BERT-base's widths) card against CPU within 1e-5,
    and a falling classifier loss."""
    import chip_smoke
    res = chip_smoke.finetune_parity_phase(dev, batch=2, seq_len=128,
                                           cls_batch=4, cls_len=64,
                                           num_layers=2)
    assert res["qa"]["max_grad_err"] <= 1e-5


def test_control_flow_and_accessors_on_card(dev):
    """chip_smoke's phase 53: nd.contrib and sym.contrib control flow
    (with gradients, `Module.fit` over a foreach graph) card against CPU
    within 1e-5, no kernel launched; `p.data()` and `p.grad()` on the
    card; `set_data` from numpy, a CPU NDArray and a card NDArray."""
    import chip_smoke
    res = chip_smoke.control_flow_phase(dev)
    assert res["accessors"]["data_context"] == "gpu(0)"


@pytest.mark.parametrize("n_pg", [8, 16, 32])
def test_paged_kernel_float32_at_the_fleet_replicas_layout(dev, n_pg):
    """Float32 paged attention at the layout of chip_smoke phase 54's GPT-2
    replicas (8 slots, 12 heads of 64, pages of 16, a pool of 512 data +
    8 scratch pages; tables of the 128-, 256- and 512-token buckets)
    against its plain version, one launch."""
    case = list(_paged_case(dev, torch.float32, B=8, H=12, D=64, ps=16,
                            n_pg=n_pg, P=520, seed=n_pg))
    n0 = pa.launches
    got = pa.paged_attention(*case)
    torch.cuda.synchronize()
    ref = pa.paged_attention_reference(*case)
    assert pa.launches == n0 + 1
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)


def test_two_replica_fleet_on_card_streams_solo_tokens(dev):
    """Two in-process gpt_tiny replicas on the card (float32, paged, each
    a Server behind a fleet.ReplicaEndpoint) behind one Router: every
    routed stream, greedy and sampled, equals a solo server's tokens on
    the same weights, both replicas serve, and the paged kernel ran."""
    from mxnet_tpu_torch import fleet, serve
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import gpt

    models = []
    for _ in range(3):
        m = gpt.GPTForCausalLM(gpt.gpt_tiny_config())
        m.initialize(generator=mxrandom.seed(0))
        models.append(m)
    kw = dict(slots=4, pages="on", page_size=4, prefill_chunk=4)
    rng = np.random.RandomState(3)
    specs = [(rng.randint(0, 128, (int(n),)).astype(np.int32),
              dict(max_new_tokens=12, seed=i,
                   temperature=0.8 if i % 3 == 2 else 0.0,
                   top_k=20 if i % 3 == 2 else 0))
             for i, n in enumerate(rng.randint(4, 40, 12))]
    solo = serve.Server(models[0], **kw)
    ref = [solo.submit(p, **k) for p, k in specs]
    solo.drain()
    solo.stop()
    servers = [serve.Server(m, **kw).start() for m in models[1:]]
    eps = [fleet.ReplicaEndpoint(s, replica=i)
           for i, s in enumerate(servers)]
    router = fleet.Router({i: ep.url for i, ep in enumerate(eps)},
                          stall_timeout_s=120.0)
    router.poll_once()
    pa.launches = 0
    try:
        reqs = [router.submit(p, **k) for p, k in specs]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        router.stop()
        for ep in eps:
            ep.stop()
        for s in servers:
            s.stop()
        fleet.disable()
    assert got == [list(r.tokens) for r in ref]
    assert all(r.state == serve.DONE for r in reqs)
    assert {r.replicas_tried[0] for r in reqs} == {0, 1}
    assert pa.launches > 0


def test_prefetched_batches_equal_plain_copies(dev):
    """Host batches staged by `prefetch_to_mesh` on its own stream equal
    `.to(dev)` copies, dtypes mapped as `nd.array` maps them; a leaf
    already on the card passes through."""
    from mxnet_tpu_torch import dataflow
    rng = np.random.RandomState(0)
    src = [([rng.randn(32, 512).astype(np.float32),
             rng.randint(0, 9, (32, 7)).astype(np.int64)],
            [torch.arange(32, device=dev)]) for _ in range(6)]
    with dataflow.prefetch_to_mesh(iter(src), [dev] * 3, depth=2) as pf:
        got = [(d, l) for d, l in pf]
    for (d, l), (sd, sl) in zip(got, src):
        assert d[0]._t.device.type == "cuda" and d[1]._t.dtype == torch.int32
        assert torch.equal(d[0]._t, torch.from_numpy(sd[0]).to(dev))
        assert torch.equal(d[1]._t, torch.from_numpy(sd[1]).to(dev).int())
        assert l[0]._t.data_ptr() == sl[0].data_ptr()


def test_prefetch_stress_no_stale_or_reused_block(dev):
    """200 host arrays of varied sizes staged two ahead while the
    consumer's stream is kept busy before it reads each one and frees it
    at once: every sum on the card equals the host's, so no batch was
    read half-copied and no freed block was handed back to the staging
    stream while the consumer still read it."""
    from mxnet_tpu_torch import dataflow
    rng = np.random.RandomState(1)
    arrays = [rng.randint(-1000, 1000, int(rng.randint(1, 1 << 21)))
              .astype(np.int32) for _ in range(200)]
    work = torch.randn(1024, 1024, device=dev)
    got = []
    with dataflow.prefetch_to_mesh(iter([[a] for a in arrays]), [dev],
                                   depth=2) as pf:
        for i, (t,) in enumerate(pf):
            for _ in range(1 + i % 4):
                work = torch.tanh(work @ work)
            got.append(t._t.long().sum())
            del t
    assert [int(g) for g in got] == [int(a.astype(np.int64).sum())
                                    for a in arrays]


def _card_bert_trainer(dev, dropout=0.1):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_tiny_config(dropout=dropout)
    model = bert.BERTForPretraining(cfg, device=dev)
    model.initialize(generator=mxrandom.seed(0, dev))
    tr = parallel.ShardedTrainer(model, bert.bert_pretrain_loss, "lamb",
                                 {"learning_rate": 1e-3, "wd": 0.01},
                                 device=dev)
    batches = []
    for s in range(4):
        b = bert.make_synthetic_batch(cfg, 8, 32, 6, seed=s)
        batches.append(([b[k] for k in ("input_ids", "token_types",
                                        "valid_length", "masked_positions")],
                        [b[k] for k in ("mlm_labels", "mlm_weights",
                                        "nsp_labels")]))
    return tr, batches


def test_step_async_through_prefetch_equals_step_on_card(dev):
    """Host batches through `prefetch_to_mesh` and `step_async` give the
    losses of `step` on the same host batches, bit for bit (dropout on,
    the random streams reset between the two runs)."""
    from mxnet_tpu_torch import dataflow
    from mxnet_tpu_torch import random as mxrandom
    runs = []
    for prefetch in (False, True):
        tr, batches = _card_bert_trainer(dev)
        mxrandom.seed(3, dev)
        if prefetch:
            with dataflow.prefetch_to_mesh(iter(batches), tr) as pf:
                runs.append([float(tr.step_async(d, l)) for d, l in pf])
        else:
            runs.append([float(tr.step(d, l)) for d, l in batches])
        assert int(tr._t_dev) == tr.num_update == 4
    assert runs[0] == runs[1]


def test_predict_step_bytes_leaves_state_and_streams_on_card(dev):
    """`predict_step_bytes` runs a measured forward and backward and
    leaves the LAMB master, the moments, `num_update` and the random
    streams bit equal; its peak rises with the batch."""
    from mxnet_tpu_torch import random as mxrandom
    tr, batches = _card_bert_trainer(dev)
    tr.step(*batches[0])
    before = [t.clone() for t in [tr.params, *tr.opt_state]]
    state = mxrandom.get_state()
    small = tr.predict_step_bytes(*batches[1])
    from mxnet_tpu_torch.models import bert
    b = bert.make_synthetic_batch(bert.bert_tiny_config(), 32, 64, 6, seed=9)
    big = tr.predict_step_bytes(
        [b[k] for k in ("input_ids", "token_types", "valid_length",
                        "masked_positions")],
        [b[k] for k in ("mlm_labels", "mlm_weights", "nsp_labels")])
    assert 0 < small["exec_peak_bytes"] < big["exec_peak_bytes"]
    assert small["capacity_bytes"] > 0 and small["fits"]
    assert all(torch.equal(a, b) for a, b in zip(
        before, [tr.params, *tr.opt_state]))
    assert tr.num_update == 1 and int(tr._t_dev) == 1
    after = mxrandom.get_state()
    assert after[0] == state[0] and torch.equal(after[1], state[1])
    assert all(torch.equal(after[2][k], v) for k, v in state[2].items())
