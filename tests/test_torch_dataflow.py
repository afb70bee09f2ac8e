"""PyTorch port, the input-to-device layer (`mxnet_tpu_torch.dataflow`
and the trainer's async half) against `mxnet_tpu.dataflow` on the CPU,
float32, inputs from numpy seeds.

  * `BucketPad` pads the same varlen batches to equal arrays, valid
    lengths and waste-ratio observations in both packages, bit for bit.
  * bert_tiny_config (2 layers, 64 units) trained 4 LAMB steps through
    `prefetch_to_mesh` and `step_async` in each package from the same
    weights: per-step losses within 1e-5 (absolute; the forward and
    backward reduce in other orders). The JAX trainers run on a mesh of
    one device. In the port, the prefetched loop
    and the plain `step` loop give bit-equal losses, with dropout on and
    the random streams reset between them.
  * `_t_dev` and `num_update` step together in both packages through a
    failed step and a `load_states`.
  * `autofit` under the same `device_bytes_limit` gives the JAX result's
    keys; the port's predictions rise with the batch, the chosen batch
    fits, `next_larger` does not, and the fitting buckets feed
    `bucket_pad()`. The chosen numbers may differ from XLA's: the port
    measures a pass where the JAX package analyses a compiled step.
  * Overlap, by events instead of a wall-clock ratio: with a slow
    source, batch i+1 is staged while step i runs.
  * No fallback: a CUDA target without a card raises at construction,
    and a failing transform or stage makes `next()` raise.
  * `trainer_async_fence_every` fences `step` (counted in `fences`),
    never `step_async`.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as config_j
from mxnet_tpu import dataflow as dataflow_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import parallel as parallel_j
from mxnet_tpu import telemetry as telemetry_j
from mxnet_tpu.gluon import loss as gloss_j
from mxnet_tpu.gluon import nn as nn_j
from mxnet_tpu.models import bert as bert_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import config as config_t
from mxnet_tpu_torch import dataflow as dataflow_t
from mxnet_tpu_torch import parallel as parallel_t
from mxnet_tpu_torch import random as random_t
from mxnet_tpu_torch import telemetry as telemetry_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.gluon import loss as gloss_t
from mxnet_tpu_torch.gluon import nn as nn_t
from mxnet_tpu_torch.models import bert as bert_t

_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")
_OPT = {"learning_rate": 1e-3, "wd": 0.01}


def _one_device_mesh():
    """A JAX mesh of one CPU device: no collectives to rendezvous under
    a loaded test run (the suite's 8-device mesh aborts an all-reduce
    that waits past XLA's 40 s)."""
    parallel_j.make_mesh(devices=jax.devices()[:1], dp=-1)


def _varlen_batches():
    rng = np.random.RandomState(3)
    return [([rng.randn(4, L, 3).astype(np.float32),
              rng.randint(0, 9, (4, L)).astype(np.int32)],
             [rng.randn(4, L).astype(np.float32)])
            for L in (3, 8, 11, 16, 29, 40)]


@pytest.mark.parametrize("axis_buckets", [None, {1: (8, 16, 32)}])
def test_bucketpad_equals_jax(axis_buckets):
    got = {}
    for name, df, tel in (("jax", dataflow_j, telemetry_j),
                          ("port", dataflow_t, telemetry_t)):
        tel.reset()
        tel.enable()
        try:
            bp = df.BucketPad(axis_buckets, pad_value=-1, label_pad_value=7)
            padded = [bp(b) for b in _varlen_batches()]
            h = tel.histogram("bucket_pad_waste_ratio")
            got[name] = (padded, h.count, h.sum)
        finally:
            tel.disable()
            tel.reset()
    (pj, nj, sj), (pt, nt, st) = got["jax"], got["port"]
    assert (nt, st) == (nj, sj)
    for (dj, lj), (dt, lt) in zip(pj, pt):
        assert len(dt) == len(dj) == 4      # each data array + its length
        for a, b in zip(dt + lt, dj + lj):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _bert_batches(cfg, n=4):
    out = []
    for i in range(n):
        b = bert_j.make_synthetic_batch(cfg, 8, 32, 6, seed=10 + i)
        b["valid_length"][::3] = 20
        out.append(([b[k] for k in _DATA], [b[k] for k in _LABELS]))
    return out


def _port_bert_trainer(cfg, arrays):
    tm = bert_t.BERTForPretraining(cfg, device="cpu")
    weights.load_named_arrays(tm, arrays)
    return parallel_t.ShardedTrainer(tm, bert_t.bert_pretrain_loss, "lamb",
                                     dict(_OPT), device="cpu")


def test_prefetched_bert_step_async_matches_jax():
    cfg = bert_j.bert_tiny_config()
    batches = _bert_batches(cfg)
    _one_device_mesh()
    jm = bert_j.BERTForPretraining(cfg)
    mx.random.seed(0)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    jt = parallel_j.ShardedTrainer(jm, bert_j.bert_pretrain_loss, "lamb",
                                   dict(_OPT))
    want = [float(jt.step_async(d, l).asscalar()) for d, l in
            dataflow_j.prefetch_to_mesh(iter(batches), jt, depth=2)]
    parallel_j.set_mesh(None)

    tt = _port_bert_trainer(bert_t.bert_tiny_config(), arrays)
    got = [float(tt.step_async(d, l).asscalar()) for d, l in
           dataflow_t.prefetch_to_mesh(iter(batches), tt, depth=2)]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tt.num_update == 4 and int(tt._t_dev) == 4


def test_prefetched_loop_bit_equals_plain_loop_with_dropout():
    cfg = bert_t.bert_tiny_config(dropout=0.1)
    batches = _bert_batches(cfg)
    with mxt.cpu():
        tm = bert_t.BERTForPretraining(cfg, device="cpu")
        random_t.seed(0, "cpu")
        tm.initialize()
    arrays = {k: p.detach().numpy().copy()
              for k, p in tm.collect_params().items()}
    runs = []
    for prefetch in (False, True):
        tt = _port_bert_trainer(cfg, arrays)
        random_t.seed(5, "cpu")
        if prefetch:
            runs.append([float(tt.step_async(d, l).asscalar()) for d, l in
                         dataflow_t.prefetch_to_mesh(iter(batches), tt)])
        else:
            runs.append([float(tt.step(d, l).asscalar())
                         for d, l in batches])
    assert runs[0] == runs[1]
    assert len(set(runs[0])) == 4


def _dense_trainer(pkg, seed=4):
    if pkg == "jax":
        _one_device_mesh()
        mx.random.seed(seed)
        net = nn_j.Dense(4, in_units=8)
        net.initialize()
        lfn = gloss_j.L2Loss()
        return parallel_j.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                         {"learning_rate": 0.1})
    with mxt.cpu():
        net = nn_t.Dense(4, in_units=8)
        random_t.seed(seed, "cpu")
        net.initialize()
    lfn = gloss_t.L2Loss()
    return parallel_t.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                     {"learning_rate": 0.1}, device="cpu")


def _xy(width=8):
    rng = np.random.RandomState(0)
    return (rng.randn(8, width).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def test_device_counter_through_a_failed_step_and_a_restore(tmp_path):
    """The same (num_update, _t_dev) trail in both packages: a completed
    step advances both, a failed one neither, and `load_states`
    re-seeds the device counter from the restored count."""
    trails = {}
    for pkg, nd in (("jax", nd_j), ("port", None)):
        tr = _dense_trainer(pkg)
        x, y = _xy()
        bad, _ = _xy(width=5)
        wrap = (lambda a: nd.array(a)) if nd is not None \
            else (lambda a: a)
        trail = []

        def note():
            trail.append((tr.num_update, int(float(tr._t_dev))))
        tr.step([wrap(x)], [wrap(y)])
        note()
        with pytest.raises(Exception):
            tr.step([wrap(bad)], [wrap(y)])
        note()
        tr.step_async([wrap(x)], [wrap(y)])
        note()
        tr.save_states(str(tmp_path / pkg))
        tr.step([wrap(x)], [wrap(y)])
        note()
        tr.load_states(str(tmp_path / pkg))
        note()
        trails[pkg] = trail
        if pkg == "jax":
            parallel_j.set_mesh(None)
    assert trails["port"] == trails["jax"] == [(1, 1), (1, 1), (2, 2),
                                               (3, 3), (2, 2)]


def _seq_trainer(pkg):
    if pkg == "jax":
        _one_device_mesh()
        mx.random.seed(1)
        net = nn_j.Dense(16, in_units=8, flatten=False)
        net.initialize()
        lfn = gloss_j.L2Loss()
        return parallel_j.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                         {"learning_rate": 0.1})
    with mxt.cpu():
        net = nn_t.Dense(16, in_units=8, flatten=False)
        random_t.seed(1, "cpu")
        net.initialize()
    lfn = gloss_t.L2Loss()
    return parallel_t.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                     {"learning_rate": 0.1}, device="cpu")


def _make_seq_batch(b, seq_len=32):
    return ([np.zeros((b, seq_len, 8), np.float32)],
            [np.zeros((b, seq_len, 16), np.float32)])


def test_autofit_keys_as_jax_and_the_choice_fits():
    port = _seq_trainer("port")
    p_small = port.predict_step_bytes(*_make_seq_batch(8))["predicted_bytes"]
    p_big = port.predict_step_bytes(*_make_seq_batch(64))["predicted_bytes"]
    assert p_small < p_big
    cap = (p_small + p_big) // 2
    results = {}
    for pkg, cfg in (("jax", config_j), ("port", config_t)):
        cfg.set("device_bytes_limit", cap)
        try:
            tr = port if pkg == "port" else _seq_trainer("jax")
            results[pkg] = dataflow_t.autofit(
                tr, _make_seq_batch, max_batch=64, buckets=[8, 16, 32],
                verbose=False) if pkg == "port" else dataflow_j.autofit(
                tr, _make_seq_batch, max_batch=64, buckets=[8, 16, 32],
                verbose=False)
        finally:
            cfg.reset("device_bytes_limit")
            if pkg == "jax":
                parallel_j.set_mesh(None)
    rj, rt = results["jax"], results["port"]
    assert set(rt.as_dict()) == set(rj.as_dict())
    optional = {"analysis_error", "oom"}
    for pt, pj in zip(rt.probes, rj.probes):
        assert set(pt) - optional == set(pj) - optional
    # the port's own plan: monotone, the choice fits, the next does not
    by_batch = {}
    for p in rt.probes:
        if p["seq_len"] == 32:
            by_batch[p["batch_size"]] = p["predicted_bytes"]
    sizes = sorted(by_batch)
    assert all(by_batch[a] < by_batch[b] for a, b in zip(sizes, sizes[1:]))
    assert rt.predicted_bytes <= cap and rt.headroom_bytes >= 0
    assert rt.next_larger["batch_size"] > rt.batch_size
    assert rt.next_larger["predicted_bytes"] > cap
    assert port.num_update == 0         # no step was taken
    assert rt.buckets == [8, 16, 32]
    (data, _labels) = rt.bucket_pad(append_valid_length=False)(
        ([np.ones((2, 11, 8), np.float32)], [np.ones((2, 11, 16),
                                                     np.float32)]))
    assert data[0].shape == (2, 16, 8)


def test_predict_step_bytes_leaves_the_trainer_as_it_was():
    tr = _seq_trainer("port")
    tr.step(*_make_seq_batch(4))
    w = [p.clone() for p in tr.params]
    state = random_t.get_state()
    info = tr.predict_step_bytes(*_make_seq_batch(16))
    assert info["exec_peak_bytes"] > 0
    assert info["predicted_bytes"] == info["exec_peak_bytes"] \
        + info["resident_bytes"]
    assert info["capacity_bytes"] is None and info["fits"] is None
    assert tr.num_update == 1 and int(tr._t_dev) == 1
    assert all(torch.equal(a, b) for a, b in zip(w, tr.params))
    after = random_t.get_state()
    assert after[0] == state[0] and torch.equal(after[1], state[1])


def test_batch_i_plus_1_is_staged_while_step_i_runs():
    """Each step's loss waits (up to 30 s) for the event the transform
    sets when batch i+1 enters staging: a loop that did not overlap
    would run step i before batch i+1 existed and time out."""
    n = 5
    entered = [threading.Event() for _ in range(n + 1)]
    entered[n].set()                    # no batch after the last
    x, y = _xy()
    waited = []
    lfn = gloss_t.L2Loss()
    with mxt.cpu():
        net = nn_t.Dense(4, in_units=8)
        net.initialize()

    def loss_fn(out, label):
        i = len(waited)
        waited.append(entered[i + 1].wait(timeout=30))
        return lfn(out, label)
    tr = parallel_t.ShardedTrainer(net, loss_fn, "sgd",
                                   {"learning_rate": 0.1}, device="cpu")

    def transform(item):
        i, batch = item
        entered[i].set()
        return batch

    def source():
        for i in range(n):
            threading.Event().wait(0.01)     # a slow host
            yield i, ([x], [y])
    for d, l in dataflow_t.prefetch_to_mesh(source(), tr, depth=2,
                                            transform=transform):
        tr.step_async(d, l)
    assert waited == [True] * n


def test_cuda_target_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _xy()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        dataflow_t.prefetch_to_mesh(iter([([x], [y])]),
                                    [torch.device("cuda")] * 2)
    # the default device outside a CPU context is the card
    with pytest.raises(RuntimeError, match="CUDA"):
        dataflow_t.prefetch_to_mesh(iter([([x], [y])]), None)


def test_a_failing_transform_or_stage_raises_at_next(monkeypatch):
    x, y = _xy()

    def bad_transform(item):
        raise ValueError("bad batch")
    with mxt.cpu():
        pf = dataflow_t.prefetch_to_mesh(iter([([x], [y])] * 3), None,
                                         transform=bad_transform)
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)

    def broken(self, item):
        raise RuntimeError("stage failed")
    monkeypatch.setattr(dataflow_t._Stager, "__call__", broken)
    with mxt.cpu():
        got = []
        with pytest.raises(RuntimeError, match="stage failed"):
            for batch in dataflow_t.prefetch_to_mesh(
                    iter([([x], [y])] * 3), None):
                got.append(batch)
    assert got == []


def test_staged_batches_are_ndarrays_on_the_target():
    x, y = _xy()
    with mxt.cpu():
        src = [([x], [y]), ([torch.from_numpy(x)], [mxt.nd.array(y)])]
        out = list(dataflow_t.prefetch_to_mesh(iter(src), None, depth=1))
    for (d, l), (sd, sl) in zip(out, src):
        for a, b in zip(d + l, sd + sl):
            assert isinstance(a, mxt.nd.NDArray) and a.context == mxt.cpu()
            np.testing.assert_array_equal(
                a.asnumpy(), np.asarray(getattr(b, "asnumpy", lambda: b)()))
    # a staged host batch owns its memory: the source may reuse its array
    buf = np.ones((2, 3), np.float32)
    with mxt.cpu():
        pf = dataflow_t.prefetch_to_mesh(iter([[buf]]), None, depth=1)
        (staged,) = next(pf)
    buf[:] = 5
    assert staged.asnumpy().sum() == 6
    pf.close()


def test_fence_every_knob_fences_step_not_step_async():
    """The JAX package's fence test on the port's counter (the JAX test
    counts calls of a patched `jax.block_until_ready`): `step` fences
    every `trainer_async_fence_every`-th step, `step_async` never, the
    default 0 never, and diagnostics alone (which does not fence for
    itself) leaves the knob's fence in place."""
    from mxnet_tpu_torch import diagnostics
    tr = _dense_trainer("port")
    x, y = _xy()
    tr.step([x], [y])
    try:
        config_t.set("trainer_async_fence_every", 2)
        for _ in range(4):
            tr.step([x], [y])
        assert tr.fences == 2
        for _ in range(4):
            tr.step_async([x], [y])
        assert tr.fences == 2
        config_t.set("trainer_async_fence_every", 0)
        for _ in range(4):
            tr.step([x], [y])
        assert tr.fences == 2
        config_t.set("trainer_async_fence_every", 2)
        diagnostics.enable()
        try:
            for _ in range(4):
                tr.step([x], [y])
        finally:
            diagnostics.disable()
            diagnostics.reset()
        assert tr.fences == 4
    finally:
        config_t.reset("trainer_async_fence_every")
