"""PyTorch port, the fused RNN op (`ops/rnn_ops.py`), `gluon.rnn` and the
activation types, against the JAX package on the CPU, float32, from the
same seeded numpy inputs and weights (carried by name with
`weights.load_named_arrays`).

The op: every mode (lstm, gru, gru with linear_before_reset=False,
rnn_tanh, rnn_relu) x uni/bidirectional x 1-2 layers x fixed or
variable lengths (1, full and 0) against `mxnet_tpu.ops.rnn_ops.rnn`
with state outputs; each case runs the port in layout TNC and NTC
(the JAX op's NTC swaps the axes around the same computation), and with
`state_outputs` off. Outputs and final states within 1e-5; gradients
with respect to the input, the initial states and the packed parameters
(`jax.vjp` against torch autograd, the same random cotangents) within
1e-5 for each mode at 2 bidirectional varlen layers and at 1 plain
layer. The JAX references come from one `jax.jit` per kind (forward,
gradient), which keeps the file's compile time to a few seconds.

Layers and cells: parameter paths and shapes equal the JAX
`collect_params()`; a bidirectional 2-layer LSTM layer and one step of
each cell equal the JAX ones within 1e-5; the cases of
`tests/unittest/test_gluon_rnn.py` run on the port; `unroll` of a cell
(and of a BidirectionalCell) equals the fused layer on the same
weights within 1e-5. Activations: every act type of the JAX op within
5e-7.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mxj
from mxnet_tpu import gluon as gj
from mxnet_tpu import nd as ndj
from mxnet_tpu.ops import nn_ops as nn_ops_j
from mxnet_tpu.ops import rnn_ops as rnn_j

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import autograd as agt
from mxnet_tpu_torch import gluon as gt
from mxnet_tpu_torch import nd, weights
from mxnet_tpu_torch.ops import nn_ops as nn_ops_t
from mxnet_tpu_torch.ops import rnn_ops as rnn_t

CPU = mxt.cpu()
T, N, I, H = 5, 3, 4, 6
LENS = np.array([1, T, 0], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)

# (mode, linear_before_reset, bidirectional, layers, varlen)
CASES = [(mode, lbr, bid, layers, varlen)
         for mode, lbr in (("lstm", True), ("gru", True), ("gru", False),
                           ("rnn_tanh", True), ("rnn_relu", True))
         for bid in (False, True) for layers in (1, 2)
         for varlen in (False, True)]
GRAD_CASES = [c for c in CASES
              if (c[2], c[3], c[4]) in ((True, 2, True), (False, 1, False))]


def _case_id(c):
    mode, lbr, bid, layers, varlen = c
    return (f"{mode}{'' if lbr else '_resetfirst'}-{'bi' if bid else 'uni'}"
            f"-{layers}l-{'varlen' if varlen else 'full'}")


def _inputs(case):
    """x, flat parameters, h0, c0 and cotangents for the case, seeded by
    its place in CASES."""
    mode, _, bid, layers, _ = case
    rng = np.random.RandomState(CASES.index(case))
    dirs = 2 if bid else 1
    n = rnn_j.rnn_param_size(mode, layers, I, H, bid)
    arrs = {"x": rng.randn(T, N, I), "p": rng.uniform(-0.4, 0.4, n),
            "h0": 0.5 * rng.randn(layers * dirs, N, H),
            "c0": 0.5 * rng.randn(layers * dirs, N, H),
            "g_out": rng.randn(T, N, dirs * H),
            "g_h": rng.randn(layers * dirs, N, H),
            "g_c": rng.randn(layers * dirs, N, H)}
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _kw(case):
    mode, lbr, bid, layers, varlen = case
    return dict(state_size=H, num_layers=layers, mode=mode,
                bidirectional=bid, state_outputs=True,
                use_sequence_length=varlen, linear_before_reset=lbr,
                _training=False)


def _jax_fn(case):
    mode, varlen = case[0], case[4]

    def f(x, p, h0, c0):
        return rnn_j.rnn(x, p, h0, c0 if mode == "lstm" else None,
                         jnp.asarray(LENS) if varlen else None, **_kw(case))
    return f


@pytest.fixture(scope="module")
def jax_forward():
    """{case: JAX outputs} for every case, from one jit."""
    args = [tuple(jnp.asarray(_inputs(c)[k]) for k in ("x", "p", "h0", "c0"))
            for c in CASES]
    outs = jax.jit(lambda a: [_jax_fn(c)(*x) for c, x in zip(CASES, a)])(
        args)
    return {c: [np.asarray(o) for o in out] for c, out in zip(CASES, outs)}


@pytest.fixture(scope="module")
def jax_grads():
    """{case: gradients wrt x, p, h0 (and c0)} from one jit of vjps."""
    def all_grads(a):
        res = []
        for c, (x, p, h0, c0, g_out, g_h, g_c) in zip(GRAD_CASES, a):
            out, vjp = jax.vjp(_jax_fn(c), x, p, h0, c0)
            res.append(vjp((g_out, g_h, g_c)[:len(out)]))
        return res
    keys = ("x", "p", "h0", "c0", "g_out", "g_h", "g_c")
    args = [tuple(jnp.asarray(_inputs(c)[k]) for k in keys)
            for c in GRAD_CASES]
    return {c: [np.asarray(g) for g in gs]
            for c, gs in zip(GRAD_CASES, jax.jit(all_grads)(args))}


def _port(case, arrs, layout="TNC", state_outputs=True, grad=False):
    mode, varlen = case[0], case[4]
    t = {k: torch.tensor(v, requires_grad=grad) for k, v in arrs.items()
         if k in ("x", "p", "h0", "c0")}
    x = t["x"] if layout == "TNC" else t["x"].transpose(0, 1)
    kw = dict(_kw(case), layout=layout, state_outputs=state_outputs)
    out = rnn_t.rnn(x, t["p"], t["h0"], t["c0"] if mode == "lstm" else None,
                    torch.tensor(LENS) if varlen else None, **kw)
    return out, t


@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_rnn_op_matches_jax(case, layout, jax_forward):
    arrs = _inputs(case)
    out, _ = _port(case, arrs, layout)
    ref = jax_forward[case]
    assert len(out) == len(ref) == (3 if case[0] == "lstm" else 2)
    y = out[0] if layout == "TNC" else out[0].transpose(0, 1)
    np.testing.assert_allclose(y.detach().numpy(), ref[0], **TOL)
    for got, want in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    if case[4]:
        assert np.all(ref[0][:, 2] == 0) and np.all(ref[0][1:, 0] == 0)
        assert np.all(y.detach().numpy()[:, 2] == 0)
        np.testing.assert_array_equal(out[1].detach().numpy()[:, 2],
                                      arrs["h0"][:, 2])
    alone, _ = _port(case, arrs, layout, state_outputs=False)
    assert torch.equal(alone, out[0])


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
def test_rnn_op_gradients_match_jax(case, jax_grads):
    arrs = _inputs(case)
    out, t = _port(case, arrs, grad=True)
    cot = [torch.tensor(arrs[k]) for k in ("g_out", "g_h", "g_c")]
    torch.autograd.backward(list(out), cot[:len(out)])
    ref = jax_grads[case]
    names = ("x", "p", "h0", "c0")[:len(ref) if case[0] == "lstm" else 3]
    for name, want in zip(names, ref):
        np.testing.assert_allclose(t[name].grad.numpy(), want, err_msg=name,
                                   **TOL)


def test_unpack_rnn_params_is_cudnn_order():
    p = np.arange(rnn_j.rnn_param_size("gru", 2, I, H, True),
                  dtype=np.float32)
    ref = rnn_j.unpack_rnn_params(jnp.asarray(p), "gru", 2, I, H, True)
    got = rnn_t.unpack_rnn_params(torch.tensor(p), "gru", 2, I, H, True)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        for k in ("wi", "wh", "bi", "bh"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
    assert rnn_t.rnn_param_size("lstm", 2, I, H, True) == \
        rnn_j.rnn_param_size("lstm", 2, I, H, True)


def test_rnn_op_takes_lengths_in_the_state_cell_slot():
    """A non-LSTM op given its lengths positionally in the state_cell
    slot (as a symbol graph binds them) reads them as the lengths."""
    case = ("gru", True, True, 1, True)
    arrs = _inputs(case)
    want, _ = _port(case, arrs)
    got = rnn_t.rnn(torch.tensor(arrs["x"]), torch.tensor(arrs["p"]),
                    torch.tensor(arrs["h0"]), torch.tensor(LENS),
                    **_kw(case))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="sequence_length"):
        rnn_t.rnn(torch.tensor(arrs["x"]), torch.tensor(arrs["p"]),
                  torch.tensor(arrs["h0"]), **_kw(case))


def test_inter_layer_dropout_draws_the_port_stream():
    """p > 0 in training: dropout between the layers (x / keep where
    kept), drawn from `random`'s device stream, so a reseeded run
    repeats; outside training it is the identity."""
    case = ("lstm", True, False, 2, False)
    arrs = _inputs(case)
    kw = dict(_kw(case), p=0.5)
    args = [torch.tensor(arrs[k]) for k in ("x", "p", "h0", "c0")]
    runs = []
    for _ in range(2):
        mxt.random.seed(3, "cpu")
        runs.append(rnn_t.rnn(*args, **dict(kw, _training=True))[0])
    assert torch.equal(runs[0], runs[1])
    off = rnn_t.rnn(*args, **kw)[0]
    assert not torch.equal(runs[0], off)
    assert torch.equal(off, rnn_t.rnn(*args, **dict(kw, p=0.0))[0])


# -- layers and cells ---------------------------------------------------------

def _pair(make_j, make_t):
    """A JAX block initialised from seed 0 and shaped by one forward, and
    the port's with its weights carried by name."""
    mxj.random.seed(0)
    bj = make_j()
    bj.initialize()
    arrays = {k: np.asarray(p.data()._data)
              for k, p in bj.collect_params().items()}
    return bj, weights.load_named_arrays(make_t(), arrays), arrays


def _blocks(ns):
    return {
        "lstm": lambda: ns.rnn.LSTM(H, num_layers=2, bidirectional=True,
                                    input_size=I),
        "gru_ntc": lambda: ns.rnn.GRU(H, layout="NTC", input_size=I),
        "rnn_tanh": lambda: ns.rnn.RNN(H, activation="tanh", input_size=I),
        "sequential": lambda: _seq(ns),
        "bidirectional_cell": lambda: ns.rnn.BidirectionalCell(
            ns.rnn.LSTMCell(H, input_size=I), ns.rnn.LSTMCell(H,
                                                              input_size=I)),
        "residual_zoneout": lambda: ns.rnn.ResidualCell(
            ns.rnn.ZoneoutCell(ns.rnn.GRUCell(I, input_size=I), 0.5)),
    }


def _seq(ns):
    seq = ns.rnn.SequentialRNNCell()
    seq.add(ns.rnn.LSTMCell(8, input_size=I))
    seq.add(ns.rnn.DropoutCell(0.5))
    seq.add(ns.rnn.GRUCell(H, input_size=8))
    return seq


@pytest.mark.parametrize("name", list(_blocks(gj)))
def test_parameter_paths_equal_jax(name):
    bj, bt = _blocks(gj)[name](), _blocks(gt)[name]()
    pj, pt = bj.collect_params(), bt.collect_params()
    assert list(pt) == list(pj)
    for k in pj:
        assert tuple(pt[k].shape) == tuple(pj[k].shape), k


def test_lstm_layer_matches_jax():
    bj, bt, _ = _pair(lambda: gj.rnn.LSTM(H, num_layers=2, layout="NTC",
                                          bidirectional=True, input_size=I),
                      lambda: gt.rnn.LSTM(H, num_layers=2, layout="NTC",
                                          bidirectional=True, input_size=I))
    rng = np.random.RandomState(1)
    x = rng.randn(N, T, I).astype(np.float32)
    s = [rng.randn(4, N, H).astype(np.float32) for _ in range(2)]
    oj, sj = bj(ndj.array(x), [ndj.array(v) for v in s])
    ot, st = bt(nd.array(x, ctx=CPU), [nd.array(v, ctx=CPU) for v in s])
    assert isinstance(ot, nd.NDArray) and len(st) == 2
    np.testing.assert_allclose(ot.asnumpy(), oj.asnumpy(), **TOL)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


@pytest.mark.parametrize("kind", ["RNNCell", "LSTMCell", "GRUCell"])
def test_cell_step_matches_jax(kind):
    args = dict(activation="softsign") if kind == "RNNCell" else {}
    cj, ct, _ = _pair(lambda: getattr(gj.rnn, kind)(H, input_size=I, **args),
                      lambda: getattr(gt.rnn, kind)(H, input_size=I, **args))
    rng = np.random.RandomState(2)
    x = rng.randn(N, I).astype(np.float32)
    s = [rng.randn(N, H).astype(np.float32) for _ in cj.state_info()]
    oj, sj = cj(ndj.array(x), [ndj.array(v) for v in s])
    ot, st = ct(nd.array(x, ctx=CPU), [nd.array(v, ctx=CPU) for v in s])
    np.testing.assert_allclose(ot.asnumpy(), oj.asnumpy(), **TOL)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)


# the cases of tests/unittest/test_gluon_rnn.py, on the port

def _x(*shape, seed=0):
    return nd.array(np.random.RandomState(seed).normal(size=shape)
                    .astype(np.float32), ctx=CPU)


def _init(block):
    block.initialize()
    return block


def test_lstm_layer_shapes():
    lstm = _init(gt.rnn.LSTM(16, num_layers=2))
    x = _x(5, 3, 8)
    assert lstm(x).shape == (5, 3, 16)
    out, new_states = lstm(x, lstm.begin_state(3, ctx=CPU))
    assert out.shape == (5, 3, 16)
    assert [s.shape for s in new_states] == [(2, 3, 16), (2, 3, 16)]


def test_gru_rnn_layers():
    for layer, hidden in [(gt.rnn.GRU(12), 12), (gt.rnn.RNN(10), 10)]:
        assert _init(layer)(_x(4, 2, 6)).shape == (4, 2, hidden)


def test_bidirectional_lstm():
    lstm = _init(gt.rnn.LSTM(8, num_layers=1, bidirectional=True))
    assert lstm(_x(4, 2, 5)).shape == (4, 2, 16)


def test_ntc_layout():
    assert _init(gt.rnn.LSTM(8, layout="NTC"))(_x(2, 4, 5)).shape == \
        (2, 4, 8)


def test_lstm_gradient_flows():
    lstm = _init(gt.rnn.LSTM(4))
    x = _x(3, 2, 5)
    x.attach_grad()
    with agt.record():
        y = lstm(x).sum()
    y.backward()
    assert np.abs(x.grad.asnumpy()).sum() > 0
    for k, p in lstm.collect_params().items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k


def _layer_from_cell(cell, layout, bidirectional=False, r_cell=None):
    layer = gt.rnn.LSTM(H, input_size=I, layout=layout,
                        bidirectional=bidirectional)
    arrays = {f"l0_{k}": p.detach().numpy()
              for k, p in cell.collect_params().items()}
    if bidirectional:
        arrays.update({f"r0_{k}": p.detach().numpy()
                       for k, p in r_cell.collect_params().items()})
    return weights.load_named_arrays(layer, arrays)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_lstm_cell_unroll_matches_layer(layout):
    cell = _init(gt.rnn.LSTMCell(H, input_size=I))
    x = _x(*((N, T, I) if layout == "NTC" else (T, N, I)))
    out_cell, states = cell.unroll(T, x, layout=layout)
    layer = _layer_from_cell(cell, layout)
    out_layer, layer_states = layer(x, layer.begin_state(N, ctx=CPU))
    np.testing.assert_allclose(out_cell.asnumpy(), out_layer.asnumpy(), **TOL)
    for a, b in zip(states, layer_states):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy()[0], **TOL)
    listed, _ = cell.unroll(T, x, layout=layout, merge_outputs=False)
    assert len(listed) == T


def test_bidirectional_cell_unroll_matches_layer():
    l_cell = _init(gt.rnn.LSTMCell(H, input_size=I))
    r_cell = _init(gt.rnn.LSTMCell(H, input_size=I))
    l_cell.initialize(force_reinit=True)
    bi = gt.rnn.BidirectionalCell(l_cell, r_cell)
    x = _x(N, T, I)
    out, _ = bi.unroll(T, x, layout="NTC")
    want = _layer_from_cell(l_cell, "NTC", True, r_cell)(x)
    np.testing.assert_allclose(out.asnumpy(), want.asnumpy(), **TOL)


def test_cells():
    for cell, nstates in [(gt.rnn.RNNCell(8, input_size=4), 1),
                          (gt.rnn.LSTMCell(8, input_size=4), 2),
                          (gt.rnn.GRUCell(8, input_size=4), 1)]:
        _init(cell)
        out, states = cell(nd.ones((2, 4), ctx=CPU),
                           cell.begin_state(2, ctx=CPU))
        assert out.shape == (2, 8)
        assert len(states) == nstates


def test_sequential_rnn_cell():
    seq = gt.rnn.SequentialRNNCell()
    seq.add(gt.rnn.LSTMCell(8, input_size=4))
    seq.add(gt.rnn.GRUCell(6, input_size=8))
    _init(seq)
    out, states = seq(nd.ones((2, 4), ctx=CPU), seq.begin_state(2, ctx=CPU))
    assert out.shape == (2, 6)
    assert len(states) == 3


def test_rnn_varlen_matches_per_sample():
    """use_sequence_length: each padded sequence gives exactly the
    outputs and final state of running it alone unpadded; the reverse
    direction of a bidirectional layer starts at its own end."""
    lens = np.array([4, 6, 2], np.int32)
    x = np.random.RandomState(0).randn(6, 3, 4).astype(np.float32)
    for mode in ("lstm", "gru", "rnn_tanh"):
        case = (mode, True, True, 1, False)
        p = torch.tensor(np.random.RandomState(3).uniform(
            -0.2, 0.2, rnn_t.rnn_param_size(mode, 1, 4, 5, True))
            .astype(np.float32))

        def run(xs, lengths=None):
            n = xs.shape[1]
            z = torch.zeros(2, n, 5)
            return rnn_t.rnn(torch.tensor(xs), p, z, z, lengths,
                             **dict(_kw(case), state_size=5,
                                    use_sequence_length=lengths is not None))
        out = run(x, torch.tensor(lens))
        for n in range(3):
            L = int(lens[n])
            solo = run(x[:L, n:n + 1])
            for a, b in zip(out, solo):
                if a.shape[0] == 6:
                    np.testing.assert_allclose(a[:L, n].numpy(),
                                               b[:, 0].numpy(), rtol=1e-5,
                                               atol=1e-6)
                    assert torch.all(a[L:, n] == 0)
                else:
                    np.testing.assert_allclose(a[:, n].numpy(),
                                               b[:, 0].numpy(), rtol=1e-5,
                                               atol=1e-6)


def test_gru_linear_before_reset_false():
    """linear_before_reset=False is the ONNX-default GRU update: checked
    against a numpy transcription of the ONNX equations."""
    n = rnn_t.rnn_param_size("gru", 1, 3, 5, False)
    rng = np.random.RandomState(1)
    x = rng.randn(4, 2, 3).astype(np.float32)
    p = rng.uniform(-0.4, 0.4, n).astype(np.float32)
    out = nd.RNN(nd.array(x, ctx=CPU), nd.array(p, ctx=CPU),
                 nd.zeros((1, 2, 5), ctx=CPU), state_size=5, num_layers=1,
                 mode="gru", linear_before_reset=False).asnumpy()
    ent = rnn_t.unpack_rnn_params(torch.tensor(p), "gru", 1, 3, 5)[0]
    wi, wh, bi, bh = (ent[k].numpy() for k in ("wi", "wh", "bi", "bh"))

    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    h = np.zeros((2, 5), np.float32)
    for t in range(4):
        ri, ui, ni = np.split(x[t] @ wi.T + bi, 3, -1)
        rh, uh, _ = np.split(h @ wh.T + bh, 3, -1)
        r, u = sig(ri + rh), sig(ui + uh)
        n_ = np.tanh(ni + (r * h) @ wh[10:].T + bh[10:])
        h = (1 - u) * n_ + u * h
        np.testing.assert_allclose(out[t], h, rtol=1e-5, atol=1e-6)


def test_gluon_layer_use_sequence_length():
    lens = np.array([4, 6, 2], np.int32)
    x = np.random.RandomState(7).randn(6, 3, 4).astype(np.float32)
    layer = _init(gt.rnn.LSTM(5, input_size=4, bidirectional=True,
                              use_sequence_length=True))
    out, states = layer(nd.array(x, ctx=CPU), layer.begin_state(3, ctx=CPU),
                        nd.array(lens, ctx=CPU))
    y = out.asnumpy()
    for n in range(3):
        L = int(lens[n])
        o2, s2 = layer(nd.array(x[:L, n:n + 1], ctx=CPU),
                       layer.begin_state(1, ctx=CPU),
                       nd.array(lens[n:n + 1], ctx=CPU))
        np.testing.assert_allclose(y[:L, n], o2.asnumpy()[:, 0], rtol=1e-5,
                                   atol=1e-6)
        assert np.all(y[L:, n] == 0)
        np.testing.assert_allclose(states[0].asnumpy()[:, n],
                                   s2[0].asnumpy()[:, 0], rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="use_sequence_length"):
        layer(nd.array(x, ctx=CPU), layer.begin_state(3, ctx=CPU))


def test_layer_defers_its_input_size_and_takes_state_funcs():
    """`input_size` 0: the first layer's i2h weights take their shape at
    the first forward; `begin_state(func=...)`."""
    layer = gt.rnn.GRU(H, num_layers=2, bidirectional=True)
    assert tuple(layer.l0_i2h_weight.shape) == (3 * H, 0)
    layer.initialize()
    layer(_x(T, N, I))
    assert tuple(layer.l0_i2h_weight.shape) == (3 * H, I)
    assert tuple(layer.r0_i2h_weight.shape) == (3 * H, I)
    ones = layer.begin_state(N, func=nd.ones, ctx=CPU)
    assert [s.shape for s in ones] == [(4, N, H)]
    assert float(ones[0].asnumpy().min()) == 1.0


def test_dropout_residual_and_zoneout_cells():
    x = nd.ones((64, 32), ctx=CPU)
    drop = gt.rnn.DropoutCell(0.5)
    assert drop(x, [])[0].asnumpy().min() == 1.0        # not training
    with agt.train_mode():
        kept = drop(x, [])[0].asnumpy()
    assert set(np.unique(kept)) == {0.0, 2.0}
    assert 0.4 < float((kept > 0).mean()) < 0.6
    res = _init(gt.rnn.ResidualCell(gt.rnn.GRUCell(32, input_size=32)))
    s = res.begin_state(64, ctx=CPU)
    out, _ = res(x, s)
    base, _ = res.base_cell(x, s)
    np.testing.assert_allclose(out.asnumpy(), base.asnumpy() + 1.0,
                               rtol=1e-6)
    zo = _init(gt.rnn.ZoneoutCell(gt.rnn.GRUCell(32, input_size=32),
                                  zoneout_outputs=1.0, zoneout_states=1.0))
    with agt.train_mode():
        out, states = zo(x, s)
    assert float(np.abs(out.asnumpy()).max()) == 0.0    # the previous: 0
    assert float(np.abs(states[0].asnumpy()).max()) == 0.0
    zo.reset()
    out, _ = zo(x, s)                                    # not training
    assert float(np.abs(out.asnumpy()).max()) > 0


# -- activations -------------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "relu6", "sigmoid", "tanh",
                                 "softrelu", "softsign", "gelu", "silu"])
def test_activation_matches_jax(act):
    x = (np.random.RandomState(0).randn(4, 257) * 3).astype(np.float32)
    want = np.asarray(nn_ops_j.activation(jnp.asarray(x), act))
    got = nn_ops_t.activation(torch.tensor(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    block = gt.nn.Activation(act)
    np.testing.assert_array_equal(block(nd.array(x, ctx=CPU)).asnumpy(), got)
