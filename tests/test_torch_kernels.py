"""PyTorch port, kernel modules: the plain versions that CPU tensors
run, held against the JAX package's kernels and references.

The same numpy inputs (from a seed) go through both packages. The JAX
side runs its Pallas kernels in interpret mode
(MXNET_TPU_PALLAS_INTERPRET=1), as the JAX package's own kernel tests
do, and its plain references. Tolerances: paged attention rtol/atol
2e-6 (both sides are float32 reductions of the same expression), flash
attention atol 1e-5 (the Pallas kernel's 128-key tiles sum in another
order than one softmax). CPU tensors never launch a CUDA kernel.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu_torch.cuda_ops import flash_attention as fa_t
from mxnet_tpu_torch.cuda_ops import paged_attention as pa_t

fa_j = importlib.import_module("mxnet_tpu.pallas_ops.flash_attention")
pa_j = importlib.import_module("mxnet_tpu.pallas_ops.paged_attention")


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
    q, k, v, _ = _flash_case(8, 8, False)
    with pytest.raises(NotImplementedError, match="training slice"):
        fa_t.flash_attention(_t(q), _t(k), _t(v), dropout=0.1)


def test_cpu_tensors_never_launch_a_kernel():
    fa_t.launches = 0
    pa_t.launches = 0
    q, k, v, mask = _flash_case(40, 40, True)
    fa_t.flash_attention(_t(q), _t(k), _t(v), _t(mask), causal=True)
    fa_t.flash_fwd(_t(q), _t(k), _t(v), torch.zeros(2, 40))
    pa_t.paged_attention(*[_t(a) for a in _paged_case(**_PAGED["small"])])
    assert fa_t.launches == 0 and pa_t.launches == 0
