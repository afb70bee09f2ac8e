"""PyTorch port, serving: `mxnet_tpu_torch.serve.Server` against the JAX
package's `serve.Server` on the same gpt_tiny weights (CPU, float32),
the port's pages="on" against its own pages="off", prefix reuse and
copy-on-write, and the PagePool / PrefixTree invariants of
`tests/unittest/test_pages.py` on the port's pool.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config, pages as pages_j, parallel, serve as serve_j
from mxnet_tpu.models import gpt as gpt_j

from mxnet_tpu_torch import pages, serve, weights
from mxnet_tpu_torch.models import gpt as gpt_t

_VOCAB = 128


@pytest.fixture(autouse=True)
def _clean():
    yield
    serve_j.disable()
    pages_j.disable()
    config.reset()


@pytest.fixture(scope="module")
def pair():
    parallel.make_mesh(dp=-1)
    cfg = gpt_j.gpt_tiny_config()
    jm = gpt_j.GPTForCausalLM(cfg)
    mx.random.seed(0)
    jm.initialize()
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    return jm, tm


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


def _serve(server_mod, model, prompts, max_new=8, submit_kw=None, **kw):
    srv = server_mod.Server(model, **kw)
    reqs = [srv.submit(p, max_new_tokens=max_new, **(submit_kw or {}))
            for p in prompts]
    srv.drain()
    out = [list(r.tokens) for r in reqs]
    verdicts = [r.verdict for r in reqs]
    st = srv.stats()
    srv.stop()
    return out, verdicts, st


_PAGED = dict(slots=4, pages="on", page_size=4, prefill_chunk=4)


def test_paged_server_matches_jax_server(pair):
    jm, tm = pair
    prompts = [_prompt(n, seed=n) for n in (5, 9, 14, 17)]
    ref, ref_v, _ = _serve(serve_j, jm, prompts, **_PAGED)
    got, got_v, st = _serve(serve, tm, prompts, **_PAGED)
    assert got == ref
    assert got_v == ref_v == ["200 ok"] * 4
    assert st["chunk_dispatches"] < sum(p.size for p in prompts)
    assert st["pages"] == "on" and st["pool_pages_total"] > 0


def test_sampled_requests_match_jax_server(pair):
    jm, tm = pair
    prompts = [_prompt(n, seed=n + 1) for n in (6, 11)]
    kw = dict(temperature=0.8, top_k=10, seed=3)
    ref, _, _ = _serve(serve_j, jm, prompts, submit_kw=kw, **_PAGED)
    got, _, _ = _serve(serve, tm, prompts, submit_kw=kw, **_PAGED)
    assert got == ref


def test_pages_on_equals_pages_off(pair):
    _, tm = pair
    prompts = [_prompt(n, seed=n) for n in (3, 8, 13, 21, 30)]
    dense, _, st_off = _serve(serve, tm, prompts, slots=4)
    paged, _, _ = _serve(serve, tm, prompts, **_PAGED)
    assert paged == dense
    assert "pages" not in st_off


def _serve_late_peer(server_mod, model):
    """A request that fills the 64-token context is decoding its last
    positions while a peer in the same bucket prefills, so the chunk
    round runs C=4 steps and the decoder's masked steps pass position 63."""
    srv = server_mod.Server(model, **_PAGED)
    a = srv.submit(_prompt(10, seed=7), max_new_tokens=54)
    while len(a.tokens) < 48:
        srv.step()
    b = srv.submit(_prompt(30, seed=8), max_new_tokens=4)
    srv.drain()
    srv.stop()
    return [list(a.tokens), list(b.tokens)], [a.verdict, b.verdict]


def test_context_filling_request_beside_prefilling_peer(pair):
    jm, tm = pair
    ref, ref_v = _serve_late_peer(serve_j, jm)
    got, got_v = _serve_late_peer(serve, tm)
    assert got == ref
    assert got_v == ref_v == ["200 ok"] * 2
    assert len(got[0]) == 54


def test_dense_server_matches_generate(pair):
    _, tm = pair
    p = _prompt(5)
    out, verdicts, _ = _serve(serve, tm, [p], slots=3)
    assert verdicts == ["200 ok"]
    assert out[0] == tm.generate(p[None], max_new_tokens=8)[0].tolist()


def test_prefix_reuse_skips_prefill(pair):
    jm, tm = pair
    rng = np.random.RandomState(3)
    shared = rng.randint(0, _VOCAB, (12,)).astype(np.int32)
    prompts = [np.concatenate([shared,
                               rng.randint(0, _VOCAB, (3,)).astype(np.int32)])
               for _ in range(4)]
    ref, _, _ = _serve(serve_j, jm, prompts, max_new=6, slots=4)
    srv = serve.Server(tm, slots=2, pages="on", page_size=4, prefill_chunk=4)
    out = []
    for p in prompts:                      # sequential: the tree is warm
        r = srv.submit(p, max_new_tokens=6)
        srv.drain()
        out.append(list(r.tokens))
    st = srv.stats()
    srv.stop()
    assert out == ref
    assert st["prefix_hits"] >= 3
    assert st["prefix_hit_rate"] > 0.4
    assert st["tree_nodes"] > 0


def test_cow_on_whole_prompt_match(pair):
    _, tm = pair
    p = _prompt(16, seed=5)                # a page multiple: full match
    ref, _, _ = _serve(serve, tm, [p], max_new=4, slots=2)
    srv = serve.Server(tm, slots=2, pages="on", page_size=4, prefill_chunk=4)
    r1 = srv.submit(p, max_new_tokens=4)
    srv.drain()
    r2 = srv.submit(p, max_new_tokens=4)
    srv.drain()
    st = srv.stats()
    srv.stop()                             # the tree drops its references
    assert r1.tokens == r2.tokens == ref[0]
    assert st["cow_copies"] == 1 and st["tree_nodes"] == 4
    assert srv.stats()["pool_pages_free"] == st["pool_pages_total"]


def test_submit_verdicts(pair):
    _, tm = pair
    srv = serve.Server(tm, slots=1, queue_depth=1, pages="on", page_size=4,
                       pool_pages=4)
    too_long = srv.submit(_prompt(60), max_new_tokens=8)
    too_big = srv.submit(_prompt(12), max_new_tokens=8)    # 5 pages > 4
    first = srv.submit(_prompt(4), max_new_tokens=2)
    shed = srv.submit(_prompt(4, seed=1), max_new_tokens=2)
    assert too_long.verdict.startswith("413")
    assert too_big.verdict.startswith("429")
    assert shed.verdict.startswith("503")
    srv.drain()
    assert first.verdict == "200 ok" and len(first.tokens) == 2
    srv.stop()


def test_background_scheduler_streams(pair):
    _, tm = pair
    with serve.Server(tm, slots=2, pages="on", page_size=4) as srv:
        r = srv.submit(_prompt(7), max_new_tokens=5)
        toks = list(r.stream())
    assert toks == r.tokens and len(toks) == 5 and r.verdict == "200 ok"


def test_pool_waits_when_short_then_admits(pair):
    _, tm = pair
    srv = serve.Server(tm, slots=2, pages="on", page_size=4, pool_pages=5)
    a = srv.submit(_prompt(10), max_new_tokens=6)          # 4 pages
    b = srv.submit(_prompt(9, seed=2), max_new_tokens=3)   # 3 pages: waits
    srv.step()
    assert a.state == serve.RUNNING and b.state == serve.QUEUED
    srv.drain()
    srv.stop()
    assert a.verdict == b.verdict == "200 ok"


# -- PagePool / PrefixTree invariants (tests/unittest/test_pages.py) ---------

def _pool(ps=4, data=8, scratch=2):
    return pages.PagePool(ps, data, scratch,
                          {"target": [(2, 8, torch.float32)] * 2},
                          device="cpu")


def _alloc_free_refcount():
    pool = _pool(data=6, scratch=3)
    assert pool.data_pages == 6 and pool.free_pages() == 6
    got = pool.alloc(4)
    assert len(got) == 4 and min(got) >= pool.scratch
    assert pool.free_pages() == 2 and pool.used_pages() == 4
    pool.incref(got[0])
    pool.decref(got[0])
    assert pool.refcount[got[0]] == 1 and pool.free_pages() == 2
    for p in got:
        pool.decref(p)
    assert pool.free_pages() == 6 and pool.stats["peak_used"] == 4
    assert sorted(pool.alloc(6)) == list(range(3, 9))


def _exhaustion_atomic():
    pool = _pool(data=3)
    pool.alloc(2)
    with pytest.raises(pages.PagesExhausted) as ei:
        pool.alloc(2)
    assert ei.value.need == 2 and ei.value.free == 1
    assert pool.free_pages() == 1


def _refcount_errors():
    pool = _pool()
    (p,) = pool.alloc(1)
    pool.decref(p)
    with pytest.raises(RuntimeError):
        pool.decref(p)
    with pytest.raises(RuntimeError):
        pool.incref(p)


def _copy_page():
    pool = _pool(data=6, scratch=1)
    (src,) = pool.alloc(1)
    for i, a in enumerate(pool.state["target"]):
        a[src] = float(i + 1)
    dst = pool.copy_page(src)
    assert dst != src and pool.refcount[dst] == 1
    for i, a in enumerate(pool.state["target"]):
        assert bool((a[dst] == float(i + 1)).all())
    assert pool.stats["cow_copies"] == 1


def _tree_partial_tail():
    pool = _pool(ps=4, data=8)
    tree = pages.PrefixTree(pool)
    prompt = _prompt(11)
    own = pool.alloc(2)
    tree.insert(prompt, own)
    assert len(tree) == 2
    assert all(pool.refcount[p] == 2 for p in own)
    got, matched = tree.match(prompt)
    assert got == own and matched == 8
    other = prompt.copy()
    other[5] = (other[5] + 1) % _VOCAB
    assert tree.match(other) == (own[:1], 4)
    assert tree.stats["hits"] == 2


def _tree_collision(monkeypatch):
    pool = _pool(ps=4, data=8)
    tree = pages.PrefixTree(pool)
    monkeypatch.setattr(pages, "_block_digest",
                        lambda parent, block: b"same-digest")
    a, b = _prompt(4, seed=1), _prompt(4, seed=2)
    pa = pool.alloc(1)
    tree.insert(a, pa)
    assert tree.match(b) == ([], 0)
    tree.insert(b, pool.alloc(1))
    assert len(tree) == 1
    assert tree.match(a) == (pa, 4)


def _tree_evict_lru():
    pool = _pool(ps=4, data=4)
    tree = pages.PrefixTree(pool)
    first, second = _prompt(8, seed=1), _prompt(8, seed=2)
    for prompt in (first, second):
        own = pool.alloc(2)
        tree.insert(prompt, own)
        for p in own:
            pool.decref(p)
    assert pool.free_pages() == 0
    got, _ = tree.match(second)            # refresh: second is now MRU
    for p in got:
        pool.decref(p)
    assert tree.evict(2) == 2 and pool.free_pages() == 2
    assert tree.match(first) == ([], 0)
    assert tree.match(second)[1] == 8
    assert tree.stats["evicted_pages"] == 2


def _tree_clear():
    pool = _pool(ps=4, data=6)
    tree = pages.PrefixTree(pool)
    own = pool.alloc(3)
    tree.insert(_prompt(12), own)
    for p in own:
        pool.decref(p)
    assert tree.clear() == 3
    assert pool.free_pages() == 6 and len(tree) == 0


_INVARIANTS = {"alloc_free_refcount": _alloc_free_refcount,
               "exhaustion_atomic": _exhaustion_atomic,
               "refcount_errors": _refcount_errors,
               "copy_page": _copy_page,
               "tree_partial_tail": _tree_partial_tail,
               "tree_collision": _tree_collision,
               "tree_evict_lru": _tree_evict_lru,
               "tree_clear": _tree_clear}


@pytest.mark.parametrize("case", sorted(_INVARIANTS))
def test_pool_and_tree_invariants(case, monkeypatch):
    fn = _INVARIANTS[case]
    if case == "tree_collision":
        fn(monkeypatch)
    else:
        fn()
