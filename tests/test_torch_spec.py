"""PyTorch port, speculative decoding and beam search against the JAX
package (CPU, float32, gpt_tiny and its 1-layer drafter from the same
weights): `decode_paged_chunk(full=True)` and `decode_paged_draft`
against the JAX model's; the speculative server, with the target as its
own drafter and with the weak drafter, emitting the JAX
`Server(drafter=...)`'s tokens, equal to plain greedy, with the same
draft counts; sampled rows riding a speculative round
(tests/unittest/test_pages.py); and `generate(num_beams=4,
return_scores=True)`: the same tokens, scores within 1e-5, the same
validation errors.
"""
import gc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import pages as pages_j
from mxnet_tpu import parallel
from mxnet_tpu import serve as serve_j
from mxnet_tpu.models import gpt as gpt_j
from mxnet_tpu.ndarray import NDArray

from mxnet_tpu_torch import pages as pages_t
from mxnet_tpu_torch import serve as serve_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import gpt as gpt_t

_VOCAB = 128
_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _clean():
    yield
    # drop this test's JAX servers now: a live one stays in
    # mxnet_tpu.serve's registry and shows in tests of other files
    # that share the worker (test_scope.py's /statusz)
    gc.collect()
    serve_j.disable()
    pages_j.disable()
    config_j.reset()


def _twin(cfg_kw, seed):
    cfg = gpt_j.gpt_tiny_config(**cfg_kw)
    jm = gpt_j.GPTForCausalLM(cfg)
    mx.random.seed(seed)
    jm.initialize()
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(**cfg_kw), device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target), (JAX drafter, port drafter): the
    drafter is test_pages.py's 1-layer gpt_tiny from seed 7."""
    parallel.make_mesh(dp=-1)
    return _twin({}, 0), _twin({"num_layers": 1}, 7)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


def _nd(a):
    return NDArray(jnp.asarray(a))


def _np(x):
    return np.asarray(x._data if isinstance(x, NDArray) else x)


# -- the model surface --------------------------------------------------------

def test_verify_chunk_and_draft_chain_match_jax(models):
    (jm, tm), _ = models
    B, ps, P, C = 3, 4, 16, 4
    H, D = 4, 16
    n_l = len(tm.gpt.layers)
    jflat = [_nd(np.zeros((P, H, ps, D), np.float32))
             for _ in range(2 * n_l)]
    tflat = [torch.zeros((P, H, ps, D)) for _ in range(2 * n_l)]
    tables = np.array([[3, 4, 5, 6], [7, 8, 9, 10], [0, 0, 0, 0]], np.int32)
    rng = np.random.RandomState(5)
    t0 = np.zeros(3, np.int32)
    # a prefill chunk, then a verify chunk with every step's logits
    for n, full in (([4, 3, 0], False), ([4, 4, 0], True)):
        n = np.asarray(n, np.int32)
        toks = rng.randint(0, 128, (B, C)).astype(np.int32)
        ref, jflat = jm.decode_paged_chunk(_nd(toks), _nd(t0), _nd(n),
                                           _nd(tables), jflat, ps, full=full)
        got, tflat = tm.decode_paged_chunk(
            torch.from_numpy(toks), torch.from_numpy(t0),
            torch.from_numpy(n), torch.from_numpy(tables), tflat, ps,
            full=full)
        live = n > 0
        assert got.dtype == torch.float32
        assert tuple(got.shape) == ((B, C, _VOCAB) if full else (B, _VOCAB))
        np.testing.assert_allclose(got.numpy()[live], _np(ref)[live],
                                   atol=_ATOL, rtol=_ATOL)
        t0 = t0 + n
    # the greedy draft chain: row 1 inactive (masked into scratch)
    tok0 = np.array([5, 9, 0], np.int32)
    act = np.array([True, False, False])
    ref, jflat = jm.decode_paged_draft(_nd(tok0), _nd(t0), _nd(act),
                                       _nd(tables), jflat, ps, 5)
    got, tflat = tm.decode_paged_draft(
        torch.from_numpy(tok0), torch.from_numpy(t0), torch.from_numpy(act),
        torch.from_numpy(tables), tflat, ps, 5)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 5)
    np.testing.assert_array_equal(got.numpy()[0], _np(ref)[0])
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a.numpy()[3:11], _np(b)[3:11],
                                   atol=_ATOL, rtol=_ATOL)


# -- speculative serving ------------------------------------------------------

_PAGED = dict(pages="on", page_size=4, prefill_chunk=4, spec_k=3)
_DRAFT_STATS = ("spec_rounds", "drafts_proposed", "drafts_accepted",
                "chunk_dispatches", "completed")


def _serve(mod, model, prompts, submit_kw, **kw):
    srv = mod.Server(model, **kw)
    reqs = [srv.submit(p, **k) for p, k in zip(prompts, submit_kw)]
    srv.drain()
    st = srv.stats()
    srv.stop()
    return [list(r.tokens) for r in reqs], [r.verdict for r in reqs], st


def _spec_case(models, drafter, prompts, submit_kw, slots):
    (jm, tm), (jd, td) = models
    plain, _, _ = _serve(serve_t, tm, prompts, submit_kw, slots=slots)
    jdr, tdr = (jm, tm) if drafter == "self" else (jd, td)
    ref, ref_v, ref_st = _serve(serve_j, jm, prompts, submit_kw,
                                slots=slots, drafter=jdr, **_PAGED)
    got, got_v, st = _serve(serve_t, tm, prompts, submit_kw, slots=slots,
                            drafter=tdr, **_PAGED)
    assert got == ref == plain
    assert got_v == ref_v == ["200 ok"] * len(prompts)
    assert {k: st[k] for k in _DRAFT_STATS} == \
        {k: ref_st[k] for k in _DRAFT_STATS}
    assert st["accepted_draft_rate"] == pytest.approx(
        ref_st["accepted_draft_rate"])
    return st


def test_self_drafter_bit_identical_to_plain_greedy(models):
    prompts = [_prompt(n, seed=n) for n in (5, 9, 17)]
    st = _spec_case(models, "self", prompts,
                    [dict(max_new_tokens=16)] * 3, slots=4)
    assert st["spec_rounds"] > 0 and st["accepted_draft_rate"] > 0.5


def test_weak_drafter_bit_identical_to_plain_greedy(models):
    prompts = [_prompt(n, seed=100 + n) for n in (6, 11)]
    st = _spec_case(models, "weak", prompts,
                    [dict(max_new_tokens=10)] * 2, slots=2)
    # a drafter of other weights and depth mostly guesses wrong — exact
    # acceptance makes that a speed question, never correctness
    assert st["spec_rounds"] > 0
    assert st["drafts_accepted"] < st["drafts_proposed"]


def test_spec_round_carries_sampled_rows(models):
    prompts = [_prompt(7, seed=21), _prompt(9, seed=22)]
    kw = [dict(max_new_tokens=8, temperature=0.8, top_k=8, seed=3),
          dict(max_new_tokens=8)]
    st = _spec_case(models, "self", prompts, kw, slots=4)
    assert st["spec_rounds"] > 0


def test_drafter_pool_stream_and_vocabulary(models):
    (_, tm), (_, td) = models
    srv = serve_t.Server(tm, slots=2, drafter=td, **_PAGED)
    tgt, dft = srv._pool.state["target"], srv._pool.state["draft"]
    assert len(tgt) == 2 * len(tm.gpt.layers)
    assert len(dft) == 2 * len(td.gpt.layers)
    assert tuple(dft[0].shape) == tuple(tgt[0].shape)
    one = tgt[0].numel() * tgt[0].element_size()
    assert srv._pool.pool_bytes() == one * (len(tgt) + len(dft))
    assert srv._params_bytes == sum(
        p.numel() * p.element_size()
        for m in (tm, td) for p in m.collect_params().values())
    srv.stop()
    other = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(vocab_size=96),
                                 device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        serve_t.Server(tm, pages="on", drafter=other)


def test_copy_page_copies_every_stream():
    specs = [(2, 8, torch.float32)] * 2
    pool = pages_t.PagePool(4, 6, 1, {"target": specs, "draft": specs},
                            device="cpu")
    (src,) = pool.alloc(1)
    for tag in ("target", "draft"):
        for i, a in enumerate(pool.state[tag]):
            a[src] = float(i + 1)
    dst = pool.copy_page(src)
    assert dst != src and pool.refcount[dst] == 1
    for tag in ("target", "draft"):
        for i, a in enumerate(pool.state[tag]):
            assert bool((a[dst] == float(i + 1)).all())
    assert pool.stats["cow_copies"] == 1


# -- beam search in generate --------------------------------------------------

@pytest.mark.parametrize("B,Lp,new,alpha", [(2, 7, 12, 0.6), (1, 20, 9, 1.0),
                                            (3, 5, 16, 0.0)])
def test_beam_generate_matches_jax(models, B, Lp, new, alpha):
    (jm, tm), _ = models
    prompt = np.random.RandomState(Lp).randint(0, _VOCAB, (B, Lp)) \
        .astype(np.int32)
    # an eos the greedy continuation reaches, so some beams end on it
    eos = int(tm.generate(prompt[:1], max_new_tokens=3)[0, -1])
    kw = dict(max_new_tokens=new, eos=eos, num_beams=4, alpha=alpha,
              return_scores=True)
    ref, ref_s = jm.generate(prompt, **kw)
    got, got_s = tm.generate(prompt, **kw)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and got.shape[0] == B
    np.testing.assert_allclose(got_s, ref_s, atol=1e-5, rtol=0)
    assert np.isfinite(got_s).all()
    only = tm.generate(prompt, max_new_tokens=new, eos=eos, num_beams=4,
                       alpha=alpha)
    np.testing.assert_array_equal(only, got)


@pytest.mark.parametrize("kw", [dict(eos=None), dict(eos=3, temperature=0.5),
                                dict(eos=3, top_k=4)])
def test_beam_generate_validation_matches_jax(models, kw):
    (jm, tm), _ = models
    prompt = _prompt(6)[None]
    with pytest.raises(ValueError) as ej:
        jm.generate(prompt, max_new_tokens=4, num_beams=4, **kw)
    with pytest.raises(ValueError) as et:
        tm.generate(prompt, max_new_tokens=4, num_beams=4, **kw)
    assert str(et.value) == str(ej.value)
