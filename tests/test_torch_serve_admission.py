"""PyTorch port, admission control and the degradation ladder against
the JAX package (CPU, float32, gpt_tiny from the same weights): the 429
over the byte budget at submit (dense and paged), 413, the budget
check's record, the dense shrink rung, evict-and-requeue with its replay,
and the paged ladder under page exhaustion (the cases of
tests/unittest/test_serve.py and test_pages.py).

The port measures no execution peak on the CPU (`Server._exec_peak` is
None there; on the card it is measured), where the JAX package's XLA
gives one, so capacities are set from each side's own accounting.
"""
import gc

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import memsafe as memsafe_j
from mxnet_tpu import pages as pages_j
from mxnet_tpu import parallel
from mxnet_tpu import serve as serve_j
from mxnet_tpu.models import gpt as gpt_j

from mxnet_tpu_torch import config as config_t
from mxnet_tpu_torch import memsafe as memsafe_t
from mxnet_tpu_torch import serve as serve_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.models import gpt as gpt_t

_VOCAB = 128


@pytest.fixture(autouse=True)
def _clean():
    yield
    # drop this test's JAX servers now: a live one stays in
    # mxnet_tpu.serve's registry and shows in tests of other files
    # that share the worker (test_scope.py's /statusz)
    gc.collect()
    serve_j.disable()
    pages_j.disable()
    memsafe_j.reset()
    memsafe_j.disable()
    config_j.reset()
    memsafe_t.reset()
    config_t.reset()


@pytest.fixture(scope="module")
def sides():
    parallel.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
    mx.random.seed(0)
    jm.initialize()
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, {k: np.asarray(p.data()._data)
                                   for k, p in jm.collect_params().items()})
    return (dict(serve=serve_j, config=config_j, memsafe=memsafe_j,
                 model=jm),
            dict(serve=serve_t, config=config_t, memsafe=memsafe_t,
                 model=tm))


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


def _both(sides, scenario):
    ref, got = (scenario(s) for s in sides)
    assert got == ref
    return got


def _outcome(r):
    return r.state, r.verdict, list(r.tokens), r.degraded, r.requeues


def _solo_tokens(s, prompt, new, **kw):
    srv = s["serve"].Server(s["model"], **kw)
    r = srv.submit(prompt, max_new_tokens=new)
    srv.drain()
    srv.stop()
    return list(r.tokens)


_PAGED = dict(pages="on", page_size=4, prefill_chunk=4)


# -- 429 / 413 at submit -----------------------------------------------------

def _over_budget_dense(s):
    srv = s["serve"].Server(s["model"], slots=2)
    s["config"].set("device_bytes_limit",
                    srv._params_bytes + srv._cache_bytes(32) // 2)
    r = srv.submit(_prompt(8), max_new_tokens=16)
    srv.drain()                    # nothing dispatched, nothing raises
    return _outcome(r), srv.stats()["rejected"], srv._groups == {}


def _over_budget_paged(s):
    srv = s["serve"].Server(s["model"], slots=2, **_PAGED)
    s["config"].set("device_bytes_limit",
                    srv._params_bytes + srv._pool.pool_bytes() - 1)
    r = srv.submit(_prompt(8), max_new_tokens=16)
    srv.drain()
    srv.stop()
    return _outcome(r), srv.stats()["rejected"]


def _too_long(s):
    srv = s["serve"].Server(s["model"], slots=2)
    r = srv.submit(_prompt(60), max_new_tokens=10)   # 70 > max_length 64
    return _outcome(r)


_AT_SUBMIT = {"over_budget_dense": _over_budget_dense,
              "over_budget_paged": _over_budget_paged,
              "too_long_413": _too_long}


@pytest.mark.parametrize("case", sorted(_AT_SUBMIT))
def test_rejected_at_submit_like_jax(sides, case):
    got = _both(sides, _AT_SUBMIT[case])
    out = got if case == "too_long_413" else got[0]
    assert out[0] == serve_t.REJECTED
    assert out[1].startswith("413" if case == "too_long_413" else
                             "429 over capacity: smallest viable KV bucket")


def test_admission_budget_rides_memsafe(sides):
    """The admission check IS memsafe's check_budget: the accounting of
    an admitted request is left in memsafe.last_check."""
    def run(s):
        srv = s["serve"].Server(s["model"], slots=2)
        pred32 = srv._params_bytes + srv._cache_bytes(32) \
            + (srv._exec_peak(32) or 0)
        s["config"].set("device_bytes_limit", pred32 + 1)
        r = srv.submit(_prompt(4), max_new_tokens=4)
        srv.drain()
        chk = s["memsafe"].last_check()
        return _outcome(r), chk["executable"], chk["headroom_bytes"] >= 0

    out, executable, fits = _both(sides, run)
    assert out[0] == serve_t.DONE and fits
    assert executable == "serve.decode(bucket=32,slots=2)"


def test_admission_hints_match_jax(sides):
    """The JAX package's hints, and (paged) the port's one more key:
    `pool_pages_reclaimable`, the pages only the prefix tree holds (fault
    21; none on a fresh server)."""
    reclaimable = []

    def run(s):
        out = {}
        for kw in ({}, _PAGED):
            srv = s["serve"].Server(s["model"], slots=2, **kw)
            s["config"].set("device_bytes_limit", 1 << 30)
            hints = srv.admission_hints()
            if "pool_pages_reclaimable" in hints:
                reclaimable.append(hints.pop("pool_pages_reclaimable"))
            out[kw.get("pages", "off")] = hints
            s["config"].reset("device_bytes_limit")
            srv.stop()
        return out

    hints = _both(sides, run)
    assert hints["off"]["headroom_bytes"] > 0
    assert hints["on"]["pool_pages_free"] > 0
    assert reclaimable == [0]          # the port's paged server only


# -- the dense ladder ---------------------------------------------------------

def test_degrade_shrink_max_new_like_jax(sides):
    def run(s):
        srv = s["serve"].Server(s["model"], slots=2)
        pred32 = srv._params_bytes + srv._cache_bytes(32) \
            + (srv._exec_peak(32) or 0)
        pred64 = srv._params_bytes + srv._cache_bytes(64) \
            + (srv._exec_peak(64) or 0)
        s["config"].set("device_bytes_limit", (pred32 + pred64) // 2)
        r = srv.submit(_prompt(10), max_new_tokens=40)    # wants 64
        srv.drain()
        return _outcome(r), r.max_new_tokens, srv.stats()["degraded"]

    out, max_new, degraded = _both(sides, run)
    assert out[0] == serve_t.DONE and len(out[2]) == max_new == 22
    assert out[3] == "shrink_max_new:40->22" and degraded == 1


def test_degrade_evict_requeues_youngest_bit_exact_replay(sides):
    """Rung 2 in the port: a (bucket 64) runs alone at a capacity of one
    64-bucket; b (bucket 32) cannot shrink below the 32 floor, so the
    youngest running request, a, is evicted and requeued; b runs, then a
    replays to exactly its unloaded tokens (the JAX package's and the
    port's).

    The JAX counterpart (tests/unittest/test_serve.py, same name) fails
    at its `a.requeues == 1`: its capacity adds XLA's AOT execution peak
    of bucket 64, which on the CPU already covers bucket 32's caches and
    peak, so b fits beside a and rung 2 never runs — the test's own
    arithmetic, not the ladder. The port measures no execution peak on
    the CPU, so the same formula leaves no room for b and rung 2 must
    run."""
    jax_side, port = sides
    ref = _solo_tokens(jax_side, _prompt(4), 50, slots=1)
    assert _solo_tokens(port, _prompt(4), 50, slots=1) == ref
    srv = serve_t.Server(port["model"], slots=1)
    assert srv._exec_peak(64) is None
    config_t.set("device_bytes_limit", srv._params_bytes
                 + srv._cache_bytes(64) + 1000)
    a = srv.submit(_prompt(4), max_new_tokens=50)     # bucket 64
    while len(a.tokens) < 3:
        srv.step()
    assert a.state == serve_t.RUNNING
    b = srv.submit(_prompt(4), max_new_tokens=4)      # bucket 32: pressure
    srv.step()
    assert (a.state, b.state) == (serve_t.QUEUED, serve_t.RUNNING)
    assert a.tokens == [] and a._streamed == 3
    srv.drain()
    assert b.state == serve_t.DONE and b.verdict == "200 ok"
    assert a.state == serve_t.DONE and a.requeues == 1
    assert a.degraded is None          # requeued requests are never shrunk
    assert a.tokens == ref
    # the replay re-sends nothing already streamed: a's stream holds each
    # token once
    assert list(a.stream()) == ref
    st = srv.stats()
    assert st["requeues"] == 1 and st["degraded"] == 1


# -- the paged ladder (tests/unittest/test_pages.py) --------------------------

def _pressure_evicts_tree(s):
    # each request needs ceil(14/4) = 4 pages; a 5-page pool leaves no
    # room for the previous prompt's 2 tree-held blocks, so every later
    # distinct prompt must evict them to run
    srv = s["serve"].Server(s["model"], slots=1, pool_pages=5, **_PAGED)
    out = []
    for seed in (31, 32, 33):
        r = srv.submit(_prompt(10, seed), max_new_tokens=4)
        srv.drain()
        out.append(_outcome(r))
    tree = dict(srv._tree.stats)
    st = srv.stats()
    srv.stop()
    return out, tree["evicted_pages"] > 0, st["completed"]


def _exhaustion_rejects(s):
    # a pool smaller than one table: the request can never fit
    srv = s["serve"].Server(s["model"], slots=1, pool_pages=3, **_PAGED)
    r = srv.submit(_prompt(20, 41), max_new_tokens=8)
    srv.drain()
    srv.stop()
    return r.state, "page pool exhausted" in r.verdict, \
        srv.stats()["rejected"]


def _vacate_returns_pages(s):
    srv = s["serve"].Server(s["model"], slots=2, **_PAGED)
    total = srv._pool.free_pages()
    r = srv.submit(_prompt(9, 51), max_new_tokens=4)
    srv.drain()
    srv.stop()                             # clears the tree too
    return _outcome(r), srv._pool.free_pages() == total, \
        int(srv._pool.refcount.sum())


def _paged_shrink(s):
    # b wants bucket 32 (7 pages) with 4 of 8 free: rung 1 seats it in
    # bucket 16 with max_new_tokens 20 -> 10 (4 pages)
    srv = s["serve"].Server(s["model"], slots=2, pool_pages=8,
                            buckets=[16, 32], **_PAGED)
    a = srv.submit(_prompt(10, 61), max_new_tokens=6)      # 16: 4 pages
    srv.step()
    b = srv.submit(_prompt(6, 62), max_new_tokens=20)
    srv.drain()
    st = srv.stats()
    srv.stop()
    return _outcome(a), _outcome(b), st["degraded"], st["requeues"]


def _paged_evict(s):
    # no smaller bucket: the youngest running request is evicted and
    # requeued, and replays after the newcomer
    srv = s["serve"].Server(s["model"], slots=2, pool_pages=5, **_PAGED)
    a = srv.submit(_prompt(10), max_new_tokens=6)           # 4 pages
    srv.step()
    b = srv.submit(_prompt(9, 2), max_new_tokens=3)         # 3: short
    srv.drain()
    st = srv.stats()
    srv.stop()
    return _outcome(a), _outcome(b), st["degraded"], st["requeues"]


_PAGED_LADDER = {"pressure_evicts_tree": _pressure_evicts_tree,
                 "exhaustion_rejects": _exhaustion_rejects,
                 "vacate_returns_pages": _vacate_returns_pages,
                 "shrink": _paged_shrink, "evict_requeue": _paged_evict}


@pytest.mark.parametrize("case", sorted(_PAGED_LADDER))
def test_paged_ladder_matches_jax(sides, case):
    got = _both(sides, _PAGED_LADDER[case])
    if case == "pressure_evicts_tree":
        assert all(o[1] == "200 ok" for o in got[0]) and got[1:] == (True, 3)
    elif case == "exhaustion_rejects":
        assert got == (serve_t.REJECTED, True, 1)
    elif case == "vacate_returns_pages":
        assert got[0][1] == "200 ok" and got[1:] == (True, 0)
    elif case == "shrink":
        assert got[1][3] == "shrink_max_new:20->10" and len(got[1][2]) == 10
        assert got[2:] == (1, 0)
    else:
        a, b = got[0], got[1]
        assert a[4] == 1 and a[1] == b[1] == "200 ok"
        assert got[2:] == (1, 1)
        assert a[2] == _solo_tokens(sides[1], _prompt(10), 6, slots=2,
                                    **_PAGED)
