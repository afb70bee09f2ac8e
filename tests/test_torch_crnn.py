"""PyTorch port, CRNN (`models/crnn.py`) against the JAX package's on the
CPU, float32: `CRNN(num_classes=6, img_height=8, channels=(8, 16),
hidden=16)` with the JAX package's weights from seed 0 carried by name,
on `make_glyph_batch` images.

Tolerances: the forward's logits within 1e-5 (two convolutions and a
BiLSTM sum in other orders); three `parallel.ShardedTrainer` Adam steps
(lr 3e-3, epsilon 1e-6) with `examples/ocr/train_crnn.py`'s `loss_fn`,
written for the JAX package and run unchanged on each package's `nd`
(`nd.ctc_loss(..., use_label_lengths=True, ...).mean()`), at batch 8,
which the JAX trainer's 8-device CPU mesh divides: losses within 1e-5
relative, every parameter within 1e-5, and the trained models' greedy
CTC decodes of held-out strings equal. Epsilon is 1e-6, not the
example's 1e-8: Adam divides each gradient by its own root mean square,
so at 1e-8 a weight whose gradient is float32 noise (|g| near 1e-9,
sums that cancel) steps by a sizeable part of lr in either package, and
two such weights parted by up to 5e-5. `ctc_greedy_decode` and
`make_glyph_batch` equal the JAX package's.
"""
import numpy as np
import pytest

import mxnet_tpu as mxj
from mxnet_tpu import nd as ndj
from mxnet_tpu import parallel as par_j
from mxnet_tpu.models import crnn as cj

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import nd, parallel, weights
from mxnet_tpu_torch.models import crnn as ct

CPU = mxt.cpu()
ARCH = dict(num_classes=6, img_height=8, channels=(8, 16), hidden=16)


def _loss_fn(nd_mod):
    """examples/ocr/train_crnn.py's loss_fn over `nd_mod`."""
    def loss_fn(logits, label, label_len):
        return nd_mod.ctc_loss(logits, label, use_label_lengths=True,
                               label_lengths=label_len).mean()
    return loss_fn


@pytest.fixture(scope="module")
def jax_model():
    mxj.random.seed(0)
    jm = cj.CRNN(**ARCH)
    jm.initialize()
    return jm, {k: np.asarray(p.data()._data)
                for k, p in jm.collect_params().items()}


def test_parameter_paths_equal_jax(jax_model):
    jm, arrays = jax_model
    tm = ct.CRNN(**ARCH, device="cpu")
    assert list(tm.collect_params()) == list(arrays)
    assert len(arrays) == 14
    for k, p in tm.collect_params().items():
        assert tuple(p.shape) == arrays[k].shape, k


def test_forward_matches_jax(jax_model):
    jm, arrays = jax_model
    tm = weights.load_named_arrays(ct.CRNN(**ARCH, device="cpu"), arrays)
    img = ct.make_glyph_batch(4, seed=3)["image"]
    want = jm(ndj.array(img)).asnumpy()
    got = tm(nd.array(img, ctx=CPU))
    assert isinstance(got, nd.NDArray) and got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-5)


def test_sharded_trainer_steps_match_jax(jax_model):
    _, arrays = jax_model
    batches = [ct.make_glyph_batch(8, seed=s) for s in range(3)]
    par_j.make_mesh(dp=-1)
    try:
        mxj.random.seed(0)
        jm = cj.CRNN(**ARCH)
        jm.initialize()
        for k, p in jm.collect_params().items():
            p.set_data(ndj.array(arrays[k]))
        jt = par_j.ShardedTrainer(jm, _loss_fn(ndj), "adam",
                                  {"learning_rate": 3e-3, "epsilon": 1e-6})
        jl = [float(jt.step([ndj.array(b["image"])],
                            [ndj.array(b["label"]),
                             ndj.array(b["label_len"])]).asscalar())
              for b in batches]
        jt.sync_to_block()
    finally:
        par_j.set_mesh(None)
    tm = weights.load_named_arrays(ct.CRNN(**ARCH, device="cpu"), arrays)
    tt = parallel.ShardedTrainer(tm, _loss_fn(nd), "adam",
                                 {"learning_rate": 3e-3, "epsilon": 1e-6},
                                 device="cpu")
    tl = []
    for b in batches:
        loss = tt.step([nd.array(b["image"], ctx=CPU)],
                       [nd.array(b["label"], ctx=CPU),
                        nd.array(b["label_len"], ctx=CPU)])
        assert isinstance(loss, nd.NDArray) and loss.shape == ()
        tl.append(float(loss.asscalar()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    tt.sync_to_block()
    pj = jm.collect_params()
    for k, p in tm.collect_params().items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(pj[k].data()._data),
                                   rtol=0, atol=1e-5, err_msg=k)
    held = ct.make_glyph_batch(16, seed=10_000_000)["image"]
    assert ct.ctc_greedy_decode(tm(nd.array(held, ctx=CPU)).asnumpy()) == \
        cj.ctc_greedy_decode(jm(ndj.array(held)).asnumpy())


def test_decode_and_glyph_batch_equal_jax():
    for seed in (0, 7):
        bt = ct.make_glyph_batch(16, seed=seed, num_glyphs=5)
        bj = cj.make_glyph_batch(16, seed=seed, num_glyphs=5)
        assert sorted(bt) == sorted(bj)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])
    logits = np.random.RandomState(2).randn(12, 5, 6).astype(np.float32)
    logits[3:6, 0] = 0.0
    logits[3:6, 0, 4] = 9.0                 # a repeat run collapses to one
    for blank in (0, 5):
        assert ct.ctc_greedy_decode(logits, blank) == \
            cj.ctc_greedy_decode(logits, blank)
