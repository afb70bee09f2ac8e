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
order) at 1e-6.
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
])
def test_flash_kernel_matches_plain(dev, dtype, Lq, Lk, D, causal, padded):
    B, H = 2, 3
    q, k, v = _qkv(dev, dtype, B, H, Lq, Lk, D)
    bias = torch.zeros((B, Lk), dtype=torch.float32, device=dev)
    if padded:
        bias[1, Lk * 2 // 3:] = -1e30
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
              (64, 192, 64, True, False), (65, 130, 40, False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("Lq,Lk,D,causal,padded", _BWD_CASES)
def test_flash_fwd_bwd_kernels_match_plain(dev, dtype, dropout, Lq, Lk, D,
                                           causal, padded):
    B, H = 2, 3
    q, k, v = _qkv(dev, dtype, B, H, Lq, Lk, D, seed=Lq + Lk)
    g = torch.tensor(np.random.RandomState(1).randn(B, H, Lq, D),
                     dtype=dtype, device=dev)
    bias = torch.zeros((B, Lk), dtype=torch.float32, device=dev)
    if padded:
        bias[1, Lk * 2 // 3:] = -1e30
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


def test_tiny_bert_training_on_card_matches_cpu(dev):
    """Three float32 LAMB steps of a tiny BERT on the card (flash and LAMB
    kernels) against the same steps on the CPU (plain versions)."""
    from mxnet_tpu_torch import parallel, random as mxrandom
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_tiny_config()
    b = bert.make_synthetic_batch(cfg, 4, 64, 6)
    b["valid_length"][1] = 40
    data = [b[k] for k in ("input_ids", "token_types", "valid_length",
                           "masked_positions")]
    labels = [b[k] for k in ("mlm_labels", "mlm_weights", "nsp_labels")]
    runs = {}
    for where in ("cpu", "cuda"):
        m = bert.BERTForPretraining(cfg, device="cpu")
        m.initialize(generator=mxrandom.seed(0, "cpu"))
        m.to(where)
        tr = parallel.ShardedTrainer(m, bert.bert_pretrain_loss, "lamb",
                                     {"learning_rate": 1e-3, "wd": 0.01},
                                     device=where)
        n = (fa.launches_dq, fu.launches_pass2)
        losses = [float(tr.step(data, labels)) for _ in range(3)]
        if where == "cuda":
            assert fa.launches_dq - n[0] == 3 * cfg["num_layers"]
            assert fu.launches_pass2 - n[1] == 3
        runs[where] = (losses, tr.params.cpu())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    torch.testing.assert_close(runs["cuda"][1], runs["cpu"][1], rtol=0,
                               atol=1e-4)


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


def _int8(dev, shape, seed):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randint(-127, 128, shape), dtype=torch.int8,
                        device=dev)


@pytest.mark.parametrize("M,K,O", [(1, 64, 96), (8, 768, 2304), (17, 96, 200),
                                   (64, 3072, 768), (130, 100, 37),
                                   (5, 48, 7), (300, 768, 3072)])
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
            assert fa.launches_dq - n[0] == 3 * cfg["num_layers"]
            assert fu.launches_adam - n[1] == 3 * len(tr.params)
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
    CPU: per step 2 dispatch, 3 combine and 6 Adam launches."""
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
        assert got == ((6, 9, 18) if where == "cuda" else (0, 0, 0))
        runs[where] = (losses, [p.cpu() for p in tr.params])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4)
    for a, c in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-4)
