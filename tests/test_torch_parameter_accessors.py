"""PyTorch port, Parameter's MXNet accessors against the JAX package's
`Parameter` on the CPU, and torch's own surface of the same parameter.

* A bare `gluon.Parameter(name, shape)`: `initialize`, `data()` (and its
  `grad` before any backward: a zeroed buffer in both), `set_data` from
  an NDArray, a tensor and numpy, `grad()` after a recorded product,
  writes through `data()[...]` and `grad()[...]`, `zero_grad`,
  `list_data`, `list_grad`, `list_ctx` and `cast`: equal values (within
  1e-6, float32) in both packages.
* A deferred parameter's `shape` setter (known shape: only itself;
  unknown: takes it, and draws the initializer asked for before), and
  `ParameterDict.initialize` / `zero_grad` over a block's parameters.
* torch's view of the same objects: `p.data` and `p.grad` are tensors
  (`p.grad is None` before the first recorded forward, so a served model
  holds no gradient buffer), `nn.Module.to`, `load_state_dict`,
  `torch.save` / `torch.load(weights_only=True)` of a state dict and of
  `p.data`, `copy.deepcopy` and pickling.
* A `ShardedTrainer` step and a serving round give bit-equal losses,
  parameters and tokens with the port's parameters and with plain
  `torch.nn.Parameter`s carrying the same attributes (the representation
  before the accessors).
"""
import copy
import io
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as ag_j
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import nd as nd_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as ag_t
from mxnet_tpu_torch import gluon as gluon_t
from mxnet_tpu_torch import nd as nd_t
from mxnet_tpu_torch import parallel, serve
from mxnet_tpu_torch.models import gpt as gpt_t

CPU = mxt.cpu()
W = np.random.RandomState(0).randn(4, 3).astype(np.float32)
X = np.random.RandomState(1).randn(2, 4).astype(np.float32)


def _accessor_run(gluon, nd, ag, make):
    """The accessors of a bare parameter, in order; the values seen."""
    seen = {}
    p = gluon.Parameter("weight", shape=(4, 3))
    p.initialize(init="ones")
    seen["init"] = p.data().asnumpy()
    seen["grad_before"] = p.data().grad.asnumpy()
    p.set_data(make(W))
    seen["set"] = p.data().asnumpy()
    x = nd.array(X, **({"ctx": CPU} if nd is nd_t else {}))
    with ag.record():
        y = nd.dot(x, p.data()).sum()
    y.backward()
    seen["grad"] = p.grad().asnumpy()
    seen["list_data"] = [a.asnumpy() for a in p.list_data()]
    seen["list_grad"] = [a.asnumpy() for a in p.list_grad()]
    seen["list_ctx"] = [str(c) for c in p.list_ctx()]
    p.zero_grad()
    seen["zeroed"] = p.grad().asnumpy()
    p.cast("float16")
    seen["cast"] = (str(p.data().dtype), str(p.grad().dtype),
                    p.data().asnumpy())
    return p, seen


@pytest.mark.parametrize("source", ["ndarray", "tensor", "numpy"])
def test_bare_parameter_accessors_match_jax(source):
    makes = {"ndarray": (nd_j.array, lambda a: nd_t.array(a, ctx=CPU)),
             "tensor": (nd_j.array, torch.tensor),
             "numpy": (np.asarray, np.asarray)}[source]
    _, want = _accessor_run(gluon_j, nd_j, ag_j, makes[0])
    with CPU:
        p, got = _accessor_run(gluon_t, nd_t, ag_t, makes[1])
    assert set(got) == set(want)
    for k in want:
        if k in ("list_ctx", "cast"):
            assert got[k][:2] == want[k][:2], k
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["cast"][2], want["cast"][2], atol=1e-3)
    assert isinstance(p.data, torch.Tensor) and p.data.dtype == torch.float16


def test_data_and_grad_share_storage_with_the_parameter():
    with CPU:
        p = gluon_t.Parameter("w", shape=(2, 3))
        p.initialize(init="zeros")
        d = p.data()
        d[:] = 2.0
        assert (p.detach() == 2).all()
        d += 1
        assert (p.detach() == 3).all()
        with ag_t.record():
            (d * 2).sum().backward()
        g = p.grad()
        assert (g.asnumpy() == 2).all()
        g[:] = 0.5
        assert (p.grad == 0.5).all()
        g._data = np.full((2, 3), 7.0, np.float32)
        assert (p.grad == 7).all()
        with ag_t.record():
            (d * 3).sum().backward()        # 'write': a new gradient tensor
        assert (g.asnumpy() == 3).all()     # the NDArray follows it
        assert p.data().context == CPU


def test_deferred_shape_setter_as_jax():
    out = {}
    for pkg, gluon in (("jax", gluon_j), ("port", gluon_t)):
        with CPU:
            p = gluon.Parameter("w", shape=None, allow_deferred_init=True)
            p.initialize(init="ones")
            with pytest.raises(Exception):
                p.data()
            p.shape = (4, 3)
            if pkg == "jax":    # its setter does not draw: ask again
                p.initialize(init="ones", force_reinit=True)
            out[pkg] = p.data().asnumpy()
            with pytest.raises(ValueError):
                p.shape = (5, 3)
            p.shape = (4, 3)
    np.testing.assert_array_equal(out["port"], out["jax"])
    with CPU:
        q = gluon_t.Parameter("q", shape=(0, 3))
        with pytest.raises(ValueError):
            q.shape = (4, 5)
        q.shape = (4, 3)
        assert tuple(q.shape) == (4, 3) and not q.mx_deferred
        r = gluon_t.Parameter("r", shape=None)
        with pytest.raises(gluon_t.DeferredInitializationError):
            r.initialize()


def test_parameter_dict_initialize_and_zero_grad_as_jax():
    out = {}
    for pkg, gluon, nd, ag in (("jax", gluon_j, nd_j, ag_j),
                               ("port", gluon_t, nd_t, ag_t)):
        with CPU:
            net = gluon.nn.Dense(3, in_units=4)
            params = net.collect_params()
            params.initialize(init="ones")
            grads0 = {k.split(".")[-1]: p.grad().asnumpy()
                      for k, p in params.items()}
            x = nd.array(X, **({"ctx": CPU} if pkg == "port" else {}))
            with ag.record():
                net(x).sum().backward()
            grads = {k.split(".")[-1]: p.grad().asnumpy()
                     for k, p in params.items()}
            params.zero_grad()
            zeroed = {k.split(".")[-1]: p.grad().asnumpy()
                      for k, p in params.items()}
            data = {k.split(".")[-1]: p.data().asnumpy()
                    for k, p in params.items()}
            out[pkg] = grads0, grads, zeroed, data
    for got, want in zip(out["port"], out["jax"]):
        assert set(got) == set(want) == {"weight", "bias"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_torch_sees_tensors_and_none():
    with CPU:
        net = gluon_t.nn.Dense(3, in_units=4)
        net.initialize()
        w = net.weight
        assert isinstance(w, torch.nn.Parameter)
        assert isinstance(w, gluon_t.Parameter)
        assert w.grad is None               # no recorded forward yet
        assert isinstance(w.data, torch.Tensor)
        w.data.copy_(torch.ones(3, 4))
        assert (w.detach() == 1).all()
        assert type(w.data * 2) is torch.Tensor
        net.to(torch.float64)
        assert net.weight is w and w.dtype == torch.float64
        net.to(torch.float32)
        sd = net.state_dict()
        buf = io.BytesIO()
        torch.save({"sd": sd, "w": w.data, "g": torch.zeros(1)}, buf)
        buf.seek(0)
        back = torch.load(buf, weights_only=True)
        assert type(back["w"]) is torch.Tensor
        net2 = gluon_t.nn.Dense(3, in_units=4)
        net2.initialize()
        net2.load_state_dict(back["sd"])
        assert torch.equal(net2.weight.detach(), w.detach())
        with ag_t.record():
            net(nd_t.ones((2, 4), ctx=CPU)).sum().backward()
        assert isinstance(w.grad, torch.Tensor) and w.grad is w.grad
        net.to(torch.float64)
        assert w.grad.dtype == torch.float64
        clone = copy.deepcopy(net)
        assert type(clone.weight) is gluon_t.Parameter
        assert clone.weight.mx_name == "weight"
        assert torch.equal(clone.weight.detach(), w.detach())
        q = pickle.loads(pickle.dumps(w))
        assert type(q) is gluon_t.Parameter and q.grad_req == "write"


def _plain(block):
    """Replace every parameter of `block` with a plain torch.nn.Parameter
    holding a copy of its values and its attributes."""
    for mod in block.modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            q = torch.nn.Parameter(p.detach().clone(),
                                   requires_grad=p.requires_grad)
            q.__dict__.update(p.__dict__)
            mod._parameters[name] = q
    return block


def _gpt(plain):
    torch.manual_seed(0)
    mxt.random.seed(0, "cpu")
    m = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    m.initialize()
    return _plain(m) if plain else m


def test_serving_round_unchanged_by_the_parameter_type():
    toks = {}
    for plain in (False, True):
        m = _gpt(plain)
        srv = serve.Server(m, slots=2)
        rs = [srv.submit(list(range(3 + i, 9 + 2 * i)), max_new_tokens=6)
              for i in range(3)]
        srv.drain()
        toks[plain] = [list(r.tokens) for r in rs]
        assert all(p.grad is None for p in m.parameters())
    assert toks[False] == toks[True] and all(toks[False])


def test_sharded_trainer_step_unchanged_by_the_parameter_type():
    rs = np.random.RandomState(2)
    x = rs.randint(0, 64, (2, 8)).astype(np.int32)
    y = rs.randint(0, 64, (2, 8)).astype(np.int32)
    w = np.ones((2, 8), np.float32)
    runs = {}
    for plain in (False, True):
        m = _gpt(plain)
        tr = parallel.ShardedTrainer(
            m, lambda logits, lbl, wt: gpt_t.gpt_lm_loss(logits, lbl, wt),
            "adam", {"learning_rate": 1e-3}, device="cpu")
        losses = [float(tr.step([nd_t.array(x, ctx=CPU)],
                                [nd_t.array(y, ctx=CPU),
                                 nd_t.array(w, ctx=CPU)]).asscalar())
                  for _ in range(2)]
        runs[plain] = losses, [t.detach().clone() for t in tr.params]
    assert runs[False][0] == runs[True][0]
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.equal(a, b)
