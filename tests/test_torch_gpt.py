"""PyTorch port, GPT model: the same weights and numpy inputs through
`mxnet_tpu.models.gpt` and `mxnet_tpu_torch.models.gpt` on the CPU.

Weights are carried across with `weights.load_named_arrays`, whose
names are the JAX package's `collect_params()` paths unchanged. Logits
agree within atol 2e-5 (float32; the two frameworks reduce in other
orders), greedy `generate` tokens are identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel
from mxnet_tpu.models import gpt as gpt_j
from mxnet_tpu.ndarray import NDArray

from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import gpt as gpt_t

_ATOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    parallel.make_mesh(dp=-1)
    cfg = gpt_j.gpt_tiny_config()
    jm = gpt_j.GPTForCausalLM(cfg)
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    return jm, tm, arrays


def _nd(a):
    return NDArray(jnp.asarray(a))


def _np(x):
    return np.asarray(x._data if isinstance(x, NDArray) else x)


def test_weight_names_are_the_jax_paths(pair):
    _, tm, arrays = pair
    assert set(tm.collect_params()) == set(arrays)
    assert "gpt.layers.0.attn.qkv.weight" in arrays
    assert "gpt.position_embed" in arrays
    for name, p in tm.collect_params().items():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[name])


@pytest.mark.parametrize("fault", ["missing", "renamed", "shape"])
def test_load_named_arrays_raises(pair, fault):
    _, _, arrays = pair
    bad = dict(arrays)
    if fault == "missing":
        del bad["gpt.ln_f.gamma"]
    elif fault == "renamed":
        bad["gpt.ln_f.scale"] = bad.pop("gpt.ln_f.gamma")
    else:
        bad["gpt.ln_f.gamma"] = np.zeros(3, np.float32)
    fresh = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    with pytest.raises((KeyError, ValueError)):
        weights.load_named_arrays(fresh, bad)


def test_model_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config())


@pytest.mark.parametrize("valid", [None, (12, 7, 1)])
def test_forward_logits_match(pair, valid):
    jm, tm, _ = pair
    toks = np.random.RandomState(1).randint(0, 128, (3, 12)).astype(np.int32)
    vl = None if valid is None else np.asarray(valid, np.int32)
    ref = _np(jm(_nd(toks), None if vl is None else _nd(vl)))
    got = tm(torch.from_numpy(toks),
             None if vl is None else torch.from_numpy(vl))
    np.testing.assert_allclose(got.numpy(), ref, atol=_ATOL, rtol=_ATOL)


def test_decode_step_slots_logits_match(pair):
    jm, tm, _ = pair
    B, L = 3, 32
    jk = [_nd(np.zeros(c.shape, np.float32)) for c in jm._alloc_caches(B, L)]
    tk = tm._alloc_caches(B, L)
    n_l = len(tk) // 2
    rng = np.random.RandomState(2)
    t = np.array([0, 3, 9], np.int32)
    for _ in range(6):
        tok = rng.randint(0, 128, (B,)).astype(np.int32)
        ref, nk, nv = jm.decode_step_slots(_nd(tok), _nd(t), jk[:n_l],
                                           jk[n_l:])
        jk = list(nk) + list(nv)
        got, _, _ = tm.decode_step_slots(torch.from_numpy(tok),
                                         torch.from_numpy(t), tk[:n_l],
                                         tk[n_l:])
        np.testing.assert_allclose(got.numpy(), _np(ref), atol=_ATOL,
                                   rtol=_ATOL)
        t = t + 1


def test_decode_paged_chunk_logits_match(pair):
    jm, tm, _ = pair
    B, ps, n_pg, P, C = 3, 4, 4, 16, 4
    H, D = 4, 16
    n_l = len(tm.gpt.layers)
    jflat = [_nd(np.zeros((P, H, ps, D), np.float32))
             for _ in range(2 * n_l)]
    tflat = [torch.zeros((P, H, ps, D)) for _ in range(2 * n_l)]
    # rows own disjoint real pages (0..B-1 are scratch); row 2 is idle
    tables = np.array([[3, 4, 5, 6], [7, 8, 9, 10], [0, 0, 0, 0]], np.int32)
    rng = np.random.RandomState(3)
    t0 = np.array([0, 0, 0], np.int32)
    for n in ([4, 3, 0], [2, 4, 0], [1, 1, 0]):
        n = np.asarray(n, np.int32)
        toks = rng.randint(0, 128, (B, C)).astype(np.int32)
        ref, jflat = jm.decode_paged_chunk(_nd(toks), _nd(t0), _nd(n),
                                           _nd(tables), jflat, ps)
        got, tflat = tm.decode_paged_chunk(
            torch.from_numpy(toks), torch.from_numpy(t0), torch.from_numpy(n),
            torch.from_numpy(tables), tflat, ps)
        live = n > 0
        np.testing.assert_allclose(got.numpy()[live], _np(ref)[live],
                                   atol=_ATOL, rtol=_ATOL)
        t0 = t0 + n
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a.numpy()[3:11], _np(b)[3:11], atol=_ATOL,
                                   rtol=_ATOL)


@pytest.mark.parametrize("B,Lp,new", [(1, 5, 8), (2, 17, 6), (3, 30, 10)])
def test_generate_greedy_tokens_match(pair, B, Lp, new):
    jm, tm, _ = pair
    prompt = np.random.RandomState(Lp).randint(0, 128, (B, Lp)) \
        .astype(np.int32)
    ref = jm.generate(prompt, max_new_tokens=new)
    got = tm.generate(prompt, max_new_tokens=new)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_generate_eos_trims_like_jax(pair):
    jm, tm, _ = pair
    prompt = np.random.RandomState(9).randint(0, 128, (2, 6)).astype(np.int32)
    free = tm.generate(prompt, max_new_tokens=8)
    eos = int(free[0, 2])
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=8, eos=eos),
        np.asarray(jm.generate(prompt, max_new_tokens=8, eos=eos)))


def test_generate_sampling_is_seeded(pair):
    _, tm, _ = pair
    prompt = np.random.RandomState(4).randint(0, 128, (2, 9)).astype(np.int32)
    kw = dict(max_new_tokens=12, temperature=0.8, top_k=20)
    a = tm.generate(prompt, seed=5, **kw)
    assert a.shape == (2, 12) and (a >= 0).all() and (a < 128).all()
    np.testing.assert_array_equal(a, tm.generate(prompt, seed=5, **kw))
