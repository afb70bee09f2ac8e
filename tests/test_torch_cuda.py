"""Port kernels against their plain versions ON THE CARD.

Every test here needs an NVIDIA GPU and is marked `cuda`; without one
each skips with a reason. The file imports neither jax nor mxnet_tpu, so
it runs on a machine with PyTorch for CUDA alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: float32 2e-5 (paged) and 1e-4 (flash: a 64-key tile loop
sums in another order than the reference's one softmax); bfloat16 2e-2,
as the JAX package's own kernel tests use.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.cuda_ops import flash_attention as fa
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
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, k, v, dropout=0.1)


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
