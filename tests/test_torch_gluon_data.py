"""PyTorch port, `gluon.data` against the JAX package's
`mxnet_tpu.gluon.data` on the CPU (`tests/unittest/test_gluon_data.py`
case by case, then the two packages side by side): datasets, samplers,
the DataLoader (num_workers 0, forked workers, the thread pool,
last_batch, pin_memory, ShardedSampler), the vision datasets' synthetic
fallbacks and the transforms.

Every comparison is exact (`assert_array_equal`): the samplers draw from
numpy's global generator in both packages, so after `np.random.seed(s)`
both give the same order; the synthetic datasets come from the same
seeds; the transforms are the same numpy code, and on an NDArray the
same float32 operations. The one tolerance is the JAX file's own: a
forked worker's numpy ToTensor against the parent's ToTensor on device
arrays, rtol 1e-6.

The port runs inside `with mx.cpu():`, as `run_example --device cpu`
runs an example. Each test that forks DataLoader workers runs its loop
under a deadline (`_within`, 120 s), so a worker that hangs fails the
test instead of the run.
"""
import os
import threading

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as nd_j
from mxnet_tpu.gluon import data as data_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import config, resilience
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch.gluon import data as data_t

DEADLINE = 120.0


@pytest.fixture(autouse=True)
def on_cpu():
    with mxt.cpu():
        yield


def _within(fn, seconds=DEADLINE):
    """fn() in a thread that must finish within `seconds`; its result,
    or its exception raised here."""
    out = {}

    def run():
        ctx = mxt.cpu()
        try:
            with ctx:
                out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"DataLoader loop still running after {seconds}s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(loader):
    return [tuple(_np(b) for b in (batch if isinstance(batch, tuple)
                                   else (batch,))) for batch in loader]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def _both(make, seed=0, deadline=False):
    """Batches of make(data module) from each package after
    np.random.seed(seed)."""
    out = []
    for data in (data_j, data_t):
        np.random.seed(seed)
        run = (lambda d=data: _batches(make(d)))
        out.append(_within(run) if deadline else run())
    return out


# -- the JAX file's cases ----------------------------------------------------

def test_array_dataset():
    X = np.random.normal(size=(10, 3)).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    for data in (data_j, data_t):
        ds = data.ArrayDataset(X, y)
        assert len(ds) == 10
        x0, y0 = ds[3]
        np.testing.assert_array_equal(x0, X[3])
        assert y0 == 3
    ds = data_t.ArrayDataset(nd_t.array(X), y)
    assert isinstance(ds[0][0], np.ndarray)


def test_transform_and_filter():
    for data in (data_j, data_t):
        ds = data.SimpleDataset(list(range(10)))
        assert ds.transform(lambda x: x * 2)[4] == 8
        assert ds.transform(lambda x: x * 2, lazy=False)[4] == 8
        assert len(ds.filter(lambda x: x % 2 == 0)) == 5
        assert len(ds.take(3)) == 3
        pairs = data.ArrayDataset(np.arange(4), np.arange(4) * 10)
        assert pairs.transform_first(lambda x: x + 1)[2] == (3, 20)


@pytest.mark.parametrize("last_batch,n", [("keep", 3), ("discard", 2),
                                          ("rollover", 2)])
def test_dataloader_batching(last_batch, n):
    X = np.random.normal(size=(10, 3)).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    j, t = _both(lambda d: d.DataLoader(d.ArrayDataset(X, y), batch_size=4,
                                        last_batch=last_batch))
    _same(t, j)
    assert len(t) == n and t[0][0].shape == (4, 3)
    loader = data_t.DataLoader(data_t.ArrayDataset(X, y), batch_size=4,
                               last_batch=last_batch)
    assert len(loader) == n
    if last_batch == "keep":
        assert t[2][0].shape == (2, 3)
    if last_batch == "rollover":
        # the 2 left over lead the next epoch: 12 samples, 3 batches
        assert len(list(loader)) == 2 and len(list(loader)) == 3


@pytest.mark.parametrize("workers,threads", [(0, False), (2, False),
                                             (2, True)])
def test_dataloader_shuffle_and_workers(workers, threads):
    X = np.arange(32).reshape(32, 1).astype(np.float32)
    j, t = _both(lambda d: d.DataLoader(
        d.ArrayDataset(X, X[:, 0]), batch_size=8, shuffle=True,
        num_workers=workers, thread_pool=threads), seed=3, deadline=True)
    _same(t, j)
    assert sorted(np.concatenate([b[1] for b in t]).tolist()) == \
        list(range(32))


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST", "CIFAR10",
                                 "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_datasets_are_bit_equal(cls, train, tmp_path):
    dj = getattr(data_j.vision, cls)(root=str(tmp_path), train=train)
    dt = getattr(data_t.vision, cls)(root=str(tmp_path), train=train)
    assert len(dt) == len(dj) == (1024 if train else 256)
    np.testing.assert_array_equal(dt._data, dj._data)
    np.testing.assert_array_equal(dt._label, dj._label)
    assert dt._data.dtype == np.uint8 and dt._label.dtype == np.int32
    img, label = dt[5]
    assert isinstance(img, nd_t.NDArray) and img.context.device_type == "cpu"
    np.testing.assert_array_equal(img.asnumpy(), dj[5][0].asnumpy())
    assert label == dj[5][1]


def test_mnist_synthetic_fallback():
    ds = data_t.vision.MNIST(root="/nonexistent/path", train=True)
    assert len(ds) > 0
    img, label = ds[0]
    assert img.shape == (28, 28, 1)
    assert 0 <= int(label) < 10


def test_synthetic_gratings_bit_equal():
    for train in (True, False):
        xj, yj = data_j.vision.SyntheticGratings(train=train).arrays
        xt, yt = data_t.vision.SyntheticGratings(train=train).arrays
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


def test_image_record_dataset_is_not_in_the_port():
    with pytest.raises(NotImplementedError, match="The facades"):
        data_t.vision.ImageRecordDataset("x.rec")


def test_totensor_normalize():
    for nd, data in ((nd_j, data_j), (nd_t, data_t)):
        t = data.vision.transforms.ToTensor()
        x = nd.array(np.full((4, 4, 3), 255, np.uint8))
        out = t(x)
        assert out.shape == (3, 4, 4)
        np.testing.assert_allclose(out.asnumpy(), 1.0)
        norm = data.vision.transforms.Normalize(mean=(0.5, 0.5, 0.5),
                                                std=(0.5, 0.5, 0.5))
        np.testing.assert_allclose(norm(out).asnumpy(), 1.0)


def _transform_cases(T):
    return [T.Cast("float16"), T.ToTensor(), T.Normalize(0.4, 0.3),
            T.Resize(12), T.Resize((10, 14)), T.CenterCrop(10),
            T.CenterCrop((6, 12)), T.RandomResizedCrop(9),
            T.RandomFlipLeftRight(), T.RandomFlipTopBottom(),
            T.Compose([T.RandomResizedCrop(16), T.RandomFlipLeftRight(),
                       T.ToTensor(), T.Normalize(mean=0.5, std=0.25)])]


@pytest.mark.parametrize("i,kind", [(i, k) for i in range(11)
                                    for k in ("numpy", "ndarray")]
                         + [(i, "batch") for i in (1, 3, 4, 5, 6)])
def test_transforms_equal_jax(i, kind):
    """Each transform on an HWC uint8 image (and a batch of two for
    ToTensor, the resizes and the crops), numpy in and NDArray in, from
    the same numpy seed: equal outputs of the same type."""
    img = np.random.RandomState(i).randint(0, 256, (20, 16, 3)) \
        .astype(np.uint8)
    if kind == "batch":
        img = np.stack([img, img[::-1]])
    if i == 2:
        img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
    outs = []
    for nd, data in ((nd_j, data_j), (nd_t, data_t)):
        tf = _transform_cases(data.vision.transforms)[i]
        x = nd.array(img, dtype=img.dtype) if kind == "ndarray" else img
        for draw in range(4):
            np.random.seed(draw)
            out = tf(x)
            assert isinstance(out, np.ndarray) == (kind != "ndarray")
            outs.append(_np(out))
    for got, ref in zip(outs[4:], outs[:4]):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


# -- forked workers ---------------------------------------------------------

def test_dataloader_process_workers_order_and_values():
    """Forked worker processes: iteration order and values equal
    num_workers=0's exactly, closures in transforms included (fork)."""
    X = np.arange(64, dtype=np.float32).reshape(16, 4)
    y = np.arange(16, dtype=np.float32)
    scale = 3.0
    ds = data_t.ArrayDataset(X, y).transform_first(lambda x: x * scale)
    ref = _batches(data_t.DataLoader(ds, batch_size=5, num_workers=0))
    got = _within(lambda: _batches(data_t.DataLoader(ds, batch_size=5,
                                                     num_workers=3)))
    assert len(ref) == len(got) == 4
    _same(got, ref)


def test_dataloader_process_worker_error_propagates():
    def bad(x):
        raise ValueError("boom in worker")

    ds = data_t.SimpleDataset(list(np.arange(8, dtype=np.float32))) \
        .transform(bad)
    with pytest.raises(RuntimeError, match="boom in worker"):
        _within(lambda: list(data_t.DataLoader(ds, batch_size=4,
                                               num_workers=2)))


def test_dataloader_process_workers_numpy_transform_chain():
    """The standard Compose (RandomResizedCrop, flip, ToTensor,
    Normalize) stays numpy, so it runs inside forked workers."""
    T = data_t.vision.transforms
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (12, 32, 32, 3)).astype(np.uint8)
    labels = np.arange(12, dtype=np.float32)
    tf = T.Compose([T.RandomResizedCrop(16), T.RandomFlipLeftRight(),
                    T.ToTensor(), T.Normalize(mean=0.5, std=0.25)])
    ds = data_t.ArrayDataset(imgs, labels).transform_first(tf)
    batches = _within(lambda: list(data_t.DataLoader(ds, batch_size=4,
                                                     num_workers=2)))
    assert len(batches) == 3
    x, y = batches[0]
    assert x.shape == (4, 3, 16, 16) and str(x.dtype) == "float32"
    got = np.concatenate([b[1].asnumpy() for b in batches])
    np.testing.assert_array_equal(np.sort(got), labels)


def test_dataloader_process_workers_builtin_vision_dataset():
    """Built-in vision datasets hand numpy to forked workers (in_worker()
    switches __getitem__ off the device path)."""
    T = data_t.vision.transforms
    ds = data_t.vision.SyntheticGratings(train=False) \
        .transform_first(T.Compose([T.ToTensor()]))
    batches = _within(lambda: list(data_t.DataLoader(ds, batch_size=32,
                                                     num_workers=2)))
    assert sum(b[0].shape[0] for b in batches) == len(ds)
    ref = list(data_t.DataLoader(ds, batch_size=32, num_workers=0))
    np.testing.assert_allclose(batches[0][0].asnumpy(),
                               ref[0][0].asnumpy(), rtol=1e-6)
    # the example's loader (unshuffled: with workers the loader draws
    # their seeds from numpy's generator before the sampler's order)
    cifar = data_t.vision.CIFAR10(train=True)
    for w in (0, 2):
        got = _within(lambda: _batches(data_t.DataLoader(
            cifar, batch_size=128, last_batch="discard", num_workers=w,
            pin_memory=True)))
        if w == 0:
            ref = got
    _same(got, ref)
    assert len(ref) == 8 and ref[0][0].dtype == np.uint8


def test_the_cifar_example_loader_equals_jax():
    """The loader of examples/image_classification/train_cifar10.py, in
    both packages from one seed: the same batches (device samples stacked
    on the device in the port, through the host in the JAX package)."""
    j, t = _both(lambda d: d.DataLoader(
        d.vision.CIFAR10(train=True), batch_size=128, shuffle=True,
        last_batch="discard"), seed=11)
    _same(t, j)
    assert len(t) == 8 and t[0][0].shape == (128, 32, 32, 3)


def test_worker_ndarray_fails_with_the_jax_message():
    """A worker whose batch holds an NDArray fails with the JAX package's
    message; in a worker without an entered CPU context, the card is
    refused before CUDA is touched."""
    X = np.arange(8, dtype=np.float32)
    ds = data_t.SimpleDataset(list(X)).transform(lambda x: nd_t.array([x]))
    with pytest.raises(RuntimeError, match="DataLoader worker produced an "
                                           "NDArray"):
        _within(lambda: list(data_t.DataLoader(ds, batch_size=4,
                                               num_workers=2)))

    def off_context():
        with mxt.gpu():       # a worker forked here resolves the card
            return list(data_t.DataLoader(ds, batch_size=4, num_workers=2))
    with pytest.raises(RuntimeError, match="CUDA cannot run in a forked "
                                           "worker"):
        _within(off_context)


class _DiesOnce(data_t.Dataset):
    """Sample 5 kills its worker once (a marker file records it)."""

    def __init__(self, marker):
        self._marker = marker

    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 5 and data_t.dataloader.in_worker() and \
                not os.path.exists(self._marker):
            open(self._marker, "w").close()
            os._exit(9)
        return np.float32(i)


def test_dead_worker_respawns_under_resilience(tmp_path):
    """A worker that dies is fatal; with resilience enabled (a retry
    budget of 3 tries) it is respawned and its batches sent again."""
    ds = _DiesOnce(str(tmp_path / "died"))
    resilience.disable()
    with pytest.raises(RuntimeError, match="died with exit code 9"):
        _within(lambda: list(data_t.DataLoader(ds, batch_size=3,
                                               num_workers=2)))
    os.remove(tmp_path / "died")
    config.set("retry_max_attempts", 3)
    config.set("fault_inject", "")
    resilience.enable()
    try:
        got = _within(lambda: _batches(data_t.DataLoader(
            ds, batch_size=3, num_workers=2)))
    finally:
        resilience.disable()
        config.reset("retry_max_attempts")
        config.reset("fault_inject")
    assert os.path.exists(tmp_path / "died")
    _same(got, _batches(data_t.DataLoader(ds, batch_size=3)))


# -- samplers ----------------------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_equal_jax(last_batch):
    out = []
    for data in (data_j, data_t):
        np.random.seed(2)
        bs = data.BatchSampler(data.RandomSampler(10), 3, last_batch)
        out.append([list(bs) for _ in range(3)] + [len(bs)])
        assert list(data.SequentialSampler(4, start=2)) == [2, 3, 4, 5]
    assert out[0] == out[1]


@pytest.mark.parametrize("parts", [1, 3, 4])
def test_sharded_sampler_equals_jax(parts):
    for shuffle in (False, True):
        shards = []
        for data in (data_j, data_t):
            np.random.seed(4)
            shards.append([list(data.ShardedSampler(10, parts, i, shuffle))
                           for i in range(parts)])
        assert shards[0] == shards[1]
        assert sorted(sum(shards[1], [])) == list(range(10))
    # no process group: this process is worker 0 of 1, as in the JAX package
    assert list(data_t.ShardedSampler(5, shuffle=False)) == \
        list(data_j.ShardedSampler(5, shuffle=False)) == list(range(5))
    with pytest.raises(ValueError, match="invalid partition"):
        data_t.ShardedSampler(10, 2, 2)


def test_sharded_sampler_through_a_loader():
    X = np.arange(20, dtype=np.float32)
    j, t = _both(lambda d: d.DataLoader(
        d.ArrayDataset(X), batch_size=4,
        sampler=d.ShardedSampler(len(X), 2, 1)), seed=6)
    _same(t, j)
    assert sorted(np.concatenate([b[0] for b in t]).tolist()) == \
        list(range(10, 20))


def test_batchify_defaults_and_pinning():
    """Default batchify: float64 to float32, int64 to int32, NDArray
    samples stacked on their device with their dtype; pin_memory changes
    nothing on the CPU."""
    dl = data_t.dataloader
    assert dl.default_batchify_fn([1.5, 2.5]).dtype == np.float32
    assert dl.default_batchify_fn([1, 2]).dtype == np.int32
    s = [nd_t.array(np.ones(2, np.float32), dtype="bfloat16")] * 3
    out = dl.default_batchify_fn(s)
    assert out._t.dtype == torch.bfloat16 and out.shape == (3, 2)
    X = np.arange(12, dtype=np.float64).reshape(6, 2)
    a = _batches(data_t.DataLoader(data_t.ArrayDataset(X), batch_size=4))
    b = _batches(data_t.DataLoader(data_t.ArrayDataset(X), batch_size=4,
                                   pin_memory=True))
    _same(a, b)
    assert a[0][0].dtype == np.float32
