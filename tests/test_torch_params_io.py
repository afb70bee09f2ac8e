"""PyTorch port, `.params` files: `nd.save` / `nd.load` (npz with
`__mx_meta__`, and the reference's binary container of `params_io`),
`Block.save_parameters` / `load_parameters` and `gluon.Trainer.
save_states` / `load_states`, against the JAX package on the CPU.

Every comparison is exact: the files each package writes for the same
arrays are equal byte for byte, each package reads the other's files to
the same bits, and parameters and optimizer states carried through a
file of either package equal their source bit for bit. The one
asymmetry: the JAX package writes a bf16 array into an npz file as
ml_dtypes' bfloat16 but cannot read such a file back (numpy returns a
2-byte void type, which jnp refuses); the port writes the same bytes and
reads them as bf16.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j
from mxnet_tpu import parallel
from mxnet_tpu.gluon import nn as nn_j
from mxnet_tpu.models import bert as bert_j
from mxnet_tpu.ndarray import params_io as pio_j

from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import weights
from mxnet_tpu_torch.gluon import nn as nn_t
from mxnet_tpu_torch.models import bert as bert_t
from mxnet_tpu_torch.ndarray import params_io as pio_t

_DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
           "int64"]


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float32),
            "ids": rng.randint(-5, 5, (2, 2, 3)).astype(np.int32),
            "s": np.float32(2.5).reshape(())}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _jnd(a):
    return nd_j.array(a, dtype=a.dtype)


def _tnd(a):
    return nd_t.array(a, ctx="cpu", dtype=a.dtype)


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("names", [True, False])
def test_params_container_bytes_equal(tmp_path, dtype, names):
    a = (np.arange(24).reshape(2, 3, 4) * 3 - 7).astype(dtype)
    arrays = [a, a[0], a.reshape(-1)[:1]]
    keys = ["a", "a0", "one"] if names else None
    pio_j.save_params(str(tmp_path / "j.params"), arrays, keys)
    pio_t.save_params(str(tmp_path / "t.params"), arrays, keys)
    assert _bytes(tmp_path / "j.params") == _bytes(tmp_path / "t.params")
    got, got_names = pio_t.load_params(str(tmp_path / "j.params"))
    assert got_names == (keys or [])
    for x, y in zip(got, arrays):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert pio_t.is_params_file(str(tmp_path / "j.params"))
    assert not pio_t.is_params_file(str(tmp_path / "missing"))


def test_params_container_reads_legacy_and_v3_records(tmp_path):
    """A V3 (int64 dims) record and a pre-magic V1 record, written by
    hand, read the same in both packages."""
    import struct
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    path = str(tmp_path / "legacy.params")
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", pio_t.LIST_MAGIC, 0, 2))
        # V3: magic, stype, ndim, int64 dims, context, type flag, data
        f.write(struct.pack("<IiI", pio_t.V3_MAGIC, 0, 2))
        f.write(struct.pack("<qq", 2, 3) + struct.pack("<iii", 1, 0, 0))
        f.write(a.tobytes())
        # pre-magic: ndim first, uint32 dims, context, type flag, data
        f.write(struct.pack("<III", 2, 2, 3) + struct.pack("<iii", 1, 0, 0))
        f.write(a.tobytes())
        f.write(struct.pack("<Q", 0))
    got_t, _ = pio_t.load_params(path)
    got_j, _ = pio_j.load_params(path)
    for x, y in zip(got_t, got_j):
        assert np.array_equal(x, a) and np.array_equal(y, a)


@pytest.mark.parametrize("fmt", ["npz", "params"])
@pytest.mark.parametrize("kind", ["dict", "list", "single"])
def test_nd_save_bytes_equal_and_cross_load(tmp_path, fmt, kind):
    arrays = _arrays()
    if kind == "dict":
        data_j = {k: _jnd(a) for k, a in arrays.items()}
        data_t = {k: _tnd(a) for k, a in arrays.items()}
    elif kind == "list":
        data_j = [_jnd(a) for a in arrays.values()]
        data_t = [_tnd(a) for a in arrays.values()]
    else:
        data_j, data_t = _jnd(arrays["w"]), _tnd(arrays["w"])
    pj, pt = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    nd_j.save(pj, data_j, format=fmt)
    nd_t.save(pt, data_t, format=fmt)
    assert _bytes(pj) == _bytes(pt)
    for reader, path, unwrap in ((nd_t.load, pj, lambda x: x.asnumpy()),
                                 (nd_j.load, pt, lambda x: x.asnumpy())):
        got = reader(path, ctx="cpu") if reader is nd_t.load \
            else reader(path)
        if kind == "dict":
            assert set(got) == set(arrays)
            pairs = [(got[k], arrays[k]) for k in arrays]
        elif kind == "list":
            pairs = list(zip(got, arrays.values()))
        else:
            pairs = [(got, arrays["w"])]
        for x, want in pairs:
            x = unwrap(x)
            if fmt == "params" and want.ndim == 0:
                # the container writes a 0-d array as 1-d
                # (np.ascontiguousarray), in both packages
                want = want.reshape(1)
            assert x.dtype == want.dtype and x.shape == want.shape
            assert np.array_equal(x, want)


def test_nd_save_bf16(tmp_path):
    """bf16: the npz bytes equal the JAX package's (ml_dtypes' bfloat16)
    and the port reads them back as bf16; the params container up-casts
    to float32 in both packages."""
    a = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    j = nd_j.array(a).astype("bfloat16")
    t = nd_t.array(a, ctx="cpu").astype("bfloat16")
    for fmt in ("npz", "params"):
        pj, pt = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
        nd_j.save(pj, {"x": j}, format=fmt)
        nd_t.save(pt, {"x": t}, format=fmt)
        assert _bytes(pj) == _bytes(pt), fmt
    back = nd_t.load(str(tmp_path / "j.npz"), ctx="cpu")["x"]
    assert back._t.dtype == torch.bfloat16 and torch.equal(back._t, t._t)
    up = nd_j.load(str(tmp_path / "t.params"))["x"]
    assert up.dtype == np.float32
    assert np.array_equal(up.asnumpy(), np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)))
    assert nd_t.load(str(tmp_path / "t.params"), ctx="cpu")["x"].dtype \
        == np.float32


def test_nd_load_finds_the_npz_suffix(tmp_path):
    """`nd.save` keeps the exact file name; a file another writer saved
    with numpy's ".npz" suffix loads by its bare name, as in the JAX
    package."""
    a = _arrays()["w"]
    nd_t.save(str(tmp_path / "x-0001.params"), _tnd(a))
    assert os.listdir(tmp_path) == ["x-0001.params"]
    np.savez(str(tmp_path / "y"), __mx_meta__="single", arr_0=a)
    assert np.array_equal(nd_t.load(str(tmp_path / "y"),
                                    ctx="cpu").asnumpy(), a)


_TINY = dict(vocab_size=128, units=64, hidden_size=128, num_layers=2,
             num_heads=4, max_length=64)


@pytest.fixture(scope="module")
def bert_pair():
    parallel.make_mesh(dp=-1)
    jm = bert_j.BERTForPretraining(bert_j.bert_tiny_config(**_TINY))
    mx.random.seed(3)
    jm.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in jm.collect_params().items()}
    yield jm, arrays
    parallel.set_mesh(None)


def _port_bert(arrays=None, seed=9):
    tm = bert_t.BERTForPretraining(bert_t.bert_tiny_config(**_TINY),
                                   device="cpu")
    if arrays is None:
        tm.initialize(generator=torch.Generator().manual_seed(seed))
    else:
        weights.load_named_arrays(tm, arrays)
    return tm


def test_save_parameters_cross_load(tmp_path, bert_pair):
    jm, arrays = bert_pair
    pj, pt = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jm.save_parameters(pj)
    tm = _port_bert(arrays)
    tm.save_parameters(pt)
    assert _bytes(pj) == _bytes(pt)
    fresh = _port_bert(seed=4)
    fresh.load_parameters(pj)
    for k, p in fresh.collect_params().items():
        assert np.array_equal(p.detach().numpy(), arrays[k]), k
        assert p.mx_initialized
    # the other way: a port file into a JAX model
    tm2 = _port_bert(seed=5)
    tm2.save_parameters(pt)
    jm2 = bert_j.BERTForPretraining(bert_j.bert_tiny_config(**_TINY))
    mx.random.seed(6)
    jm2.initialize()
    jm2.load_parameters(pt)
    for k, p in tm2.collect_params().items():
        assert np.array_equal(np.asarray(jm2.collect_params()[k].data()
                                         ._data), p.detach().numpy()), k


def test_parameter_dict_prefixes_and_strictness(tmp_path, bert_pair):
    jm, arrays = bert_pair
    tm = _port_bert(arrays)
    pj, pt = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jm.collect_params().save(pj, strip_prefix="bert.")
    tm.collect_params().save(pt, strip_prefix="bert.")
    assert _bytes(pj) == _bytes(pt)
    fresh = _port_bert(seed=2)
    sub = fresh.bert.collect_params()
    sub.load(pj, ignore_extra=True)           # the heads' names are extra
    for k, p in sub.items():
        assert np.array_equal(p.detach().numpy(), arrays["bert." + k]), k
    with pytest.raises(KeyError, match="extra parameters"):
        fresh.bert.collect_params().load(pj)
    fresh.collect_params().load(pj, restore_prefix="bert.",
                                allow_missing=True, ignore_extra=True)
    with pytest.raises(KeyError, match="missing"):
        fresh.collect_params().load(pj, restore_prefix="bert.",
                                    ignore_extra=True)
    # a file of another shape raises instead of replacing the tensor
    bad = {k: (v[:1] if v.ndim else v) for k, v in arrays.items()}
    nd_t.save(str(tmp_path / "bad.params"),
              {k: torch.from_numpy(v.copy()) for k, v in bad.items()})
    with pytest.raises(ValueError, match="shape"):
        fresh.load_parameters(str(tmp_path / "bad.params"))


def test_load_parameters_fills_deferred_shapes_and_casts(tmp_path):
    """A deferred Dense takes its shape from the file; a bf16 block takes
    a float32 file cast to bf16 (the JAX package's set_data casts)."""
    w = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    b = np.arange(4, dtype=np.float32)
    nd_t.save(str(tmp_path / "d.params"), {"weight": torch.from_numpy(w),
                                           "bias": torch.from_numpy(b)})
    with torch.device("cpu"):
        net = nn_t.Dense(4)
    net.load_parameters(str(tmp_path / "d.params"))
    assert tuple(net.weight.shape) == (4, 3) and not net.weight.mx_deferred
    assert np.array_equal(net.weight.detach().numpy(), w)
    with torch.device("cpu"):
        net16 = nn_t.Dense(4, in_units=3).cast("bfloat16")
    net16.load_parameters(str(tmp_path / "d.params"))
    assert net16.weight.dtype == torch.bfloat16
    assert torch.equal(net16.weight.detach(),
                       torch.from_numpy(w).bfloat16())


def _nets(seed=0):
    """The same two-Dense net in each package, the same weights."""
    rng = np.random.RandomState(seed)
    ws = {"0.weight": rng.randn(6, 4), "0.bias": rng.randn(6),
          "1.weight": rng.randn(3, 6), "1.bias": rng.randn(3)}
    ws = {k: v.astype(np.float32) for k, v in ws.items()}
    jn = nn_j.HybridSequential()
    jn.add(nn_j.Dense(6, in_units=4), nn_j.Dense(3, in_units=6))
    jn.initialize()
    for k, p in jn.collect_params().items():
        p.set_data(nd_j.array(ws[k]))
    with torch.device("cpu"):
        tn = nn_t.HybridSequential()
        tn.add(nn_t.Dense(6, in_units=4), nn_t.Dense(3, in_units=6))
    weights.load_named_arrays(tn, {k: ws[k] for k in
                                   tn.collect_params()})
    return jn, tn


_OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
         ("sgd", {"learning_rate": 0.1}),
         ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
         ("adam", {"learning_rate": 1e-3}),
         ("adamw", {"learning_rate": 1e-3, "wd": 0.01})]


def _state_arrays(states):
    """{"i" or "i.j": numpy} of a trainer's states (either package)."""
    out = {}
    for i, st in enumerate(states):
        if st is None:
            continue
        parts = st if isinstance(st, tuple) else (st,)
        for j, t in enumerate(parts):
            if t is None:
                continue
            key = f"{i}.{j}" if isinstance(st, tuple) else f"{i}"
            out[key] = np.asarray(t._data if hasattr(t, "_data")
                                  else t.numpy())
    return out


@pytest.mark.parametrize("opt,kw", _OPTS,
                         ids=[f"{o}-{'mom' if 'momentum' in k else 'plain'}"
                              for o, k in _OPTS])
def test_trainer_states_cross_load(tmp_path, opt, kw):
    jn, tn = _nets()
    assert list(jn.collect_params()) == list(tn.collect_params())
    jt = gluon_j.Trainer(jn.collect_params(), opt, dict(kw))
    tt = gluon_t.Trainer(tn.collect_params(), opt, dict(kw))
    jt._create_states()
    tt._create_states()
    rng = np.random.RandomState(1)
    # JAX states -> file -> port
    for st in jt._states:
        for t in (st if isinstance(st, tuple) else (st,)):
            if t is not None:
                t._data = jnp.asarray(rng.randn(*t.shape).astype(np.float32))
    jt.save_states(str(tmp_path / "j.states"))
    tt.load_states(str(tmp_path / "j.states"))
    want = _state_arrays(jt._states)
    got = _state_arrays(tt._states)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # port states -> file -> JAX; and the two files of equal states are
    # equal byte for byte
    tt.save_states(str(tmp_path / "t.states"))
    assert _bytes(tmp_path / "j.states") == _bytes(tmp_path / "t.states")
    with torch.no_grad():
        for st in tt._states:
            for t in (st if isinstance(st, tuple) else (st,)):
                if t is not None:
                    t.copy_(torch.from_numpy(
                        rng.randn(*t.shape).astype(np.float32)))
    tt.save_states(str(tmp_path / "t2.states"))
    jt.load_states(str(tmp_path / "t2.states"))
    want = _state_arrays(tt._states)
    got = _state_arrays(jt._states)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if not want:
        # plain SGD keeps no state: both files are empty dicts
        assert nd_t.load(str(tmp_path / "t2.states"), ctx="cpu") == {}


def test_trainer_load_states_refuses_a_wrong_shape(tmp_path):
    _, tn = _nets()
    tt = gluon_t.Trainer(tn.collect_params(), "adam")
    nd_t.save(str(tmp_path / "s"), {"0.0": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        tt.load_states(str(tmp_path / "s"))
    nd_t.save(str(tmp_path / "l"), [torch.zeros(2)])
    with pytest.raises(ValueError, match="not optimizer states"):
        tt.load_states(str(tmp_path / "l"))
