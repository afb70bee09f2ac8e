"""PyTorch port, int8 quantization: `contrib.quantization` against
`mxnet_tpu.contrib.quantization` on the CPU, from the same float weights
(carried by name with `weights.load_named_arrays`) and the same numpy
inputs.

Weight quantization runs in numpy in both packages, so `weight_q` and
`weight_scale` are compared bit for bit; calibrated activation scales
are the max |x| of float32 activations, which the two forwards round
differently (rtol 1e-6). `QuantizedDense` outputs: in
float32 the activation quantization is the same float32 arithmetic on
both sides and the int32 product is exact, so only the final rescale
and bias add may round differently (rtol/atol 1e-6); in bfloat16 the
outputs are rounded to bf16 on both sides and may differ by one bf16
ulp (rtol 2**-7). Served greedy tokens are compared for equality: the
int8 server against the JAX server on the JAX quantized twin, and, with
pages off, against the port's own `simulate=True` twin (the JAX
package's serving gate). CPU tensors run the plain version of the int8 kernel, so its
launch counter stays 0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as gluon_j
from mxnet_tpu import pages as pages_j, parallel, serve as serve_j
from mxnet_tpu.contrib import quantization as quant_j
from mxnet_tpu.models import gpt as gpt_j
from mxnet_tpu.ndarray import NDArray

from mxnet_tpu_torch import serve, weights
from mxnet_tpu_torch.contrib import quantization as quant_t
from mxnet_tpu_torch.cuda_ops import int8_matmul as im_t
from mxnet_tpu_torch.gluon import nn as nn_t
from mxnet_tpu_torch.gluon.parameter import Constant, dtype_of
from mxnet_tpu_torch.models import gpt as gpt_t

_VOCAB = 128


@pytest.fixture(autouse=True)
def _clean():
    yield
    serve_j.disable()
    pages_j.disable()


def _arrays(jm):
    return {k: np.asarray(p.data()._data)
            for k, p in jm.collect_params().items()}


def _jax_gpt(seed=0):
    parallel.make_mesh(dp=-1)
    jm = gpt_j.GPTForCausalLM(gpt_j.gpt_tiny_config())
    mx.random.seed(seed)
    jm.initialize()
    return jm


def _port_gpt(arrays):
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    weights.load_named_arrays(tm, arrays)
    return tm


def _calib(n=2, L=12, seed=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, _VOCAB, (2, L)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_block_is_bit_identical(calibrated):
    jm = _jax_gpt()
    tm = _port_gpt(_arrays(jm))
    calib = _calib() if calibrated else None
    quant_j.quantize_block(
        jm, calib_data=None if calib is None
        else [NDArray(jnp.asarray(c)) for c in calib])
    quant_t.quantize_block(tm, calib_data=calib)
    ja, tp = _arrays(jm), tm.collect_params()
    assert set(tp) == set(ja)
    assert "gpt.layers.0.attn.qkv.weight_q" in tp
    assert "gpt.layers.1.ffn_out.weight_scale" in tp
    assert "gpt.layers.0.attn.qkv.weight" not in tp
    for name, p in tp.items():
        got = p.detach().numpy()
        assert got.dtype == ja[name].dtype, name
        np.testing.assert_array_equal(got, ja[name], err_msg=name)
    n_dense = 0
    for path, m in tm.named_modules():
        if isinstance(m, quant_t.QuantizedDense):
            n_dense += 1
            jq = jm
            for part in path.split("."):
                jq = jq[int(part)] if part.isdigit() else getattr(jq, part)
            assert (m._act_scale is None) == (not calibrated)
            if calibrated:
                # max |x| of activations that the two forwards compute in
                # float32: equal up to float32 rounding
                np.testing.assert_allclose(m._act_scale, jq._act_scale,
                                           rtol=1e-6, err_msg=path)
            assert m.weight_q.grad_req == "null"
            # the int8 weight is stored pre-transposed, (K, O)
            assert m.weight_q.shape[1] == m.weight_scale.shape[0]
    assert n_dense == 4 * 2
    assert not any(isinstance(m, nn_t.Dense) for m in tm.modules())


def test_quantize_params_and_calibration_scales_match():
    rng = np.random.RandomState(0)
    w = rng.randn(7, 13).astype(np.float32)
    for mode in ("naive", "entropy"):
        qj, sj = quant_j.quantize_params(w, mode)
        qt, st = quant_t.quantize_params(torch.from_numpy(w), mode)
        np.testing.assert_array_equal(qt, qj)
        assert st == sj
        np.testing.assert_array_equal(quant_t._per_channel_scales(w, mode),
                                      quant_j._per_channel_scales(w, mode))
    cj, ct = quant_j.CalibrationCollector(), quant_t.CalibrationCollector()
    for i in range(3):
        x = rng.randn(4, 5).astype(np.float32) * (i + 1)
        cj.collect("a", x)
        ct.collect("a", torch.from_numpy(x))
    assert ct.scale("a") == cj.scale("a") and ct.scale("b") is None


def _dense_pair(dtype, relu, K=48, O=40, seed=0):
    jd = gluon_j.nn.Dense(O, in_units=K, flatten=False, dtype=dtype,
                          activation="relu" if relu else None)
    mx.random.seed(seed)
    jd.initialize()
    rng = np.random.RandomState(seed)
    jd.bias.set_data(NDArray(jnp.asarray(rng.randn(O).astype(np.float32)
                                         * 0.1).astype(dtype)))
    td = nn_t.Dense(O, in_units=K, flatten=False, dtype=dtype,
                    activation="relu" if relu else None)
    weights.load_named_arrays(td, _arrays(jd))
    return jd, td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_quantized_dense_matches_jax(dtype, static, relu):
    jd, td = _dense_pair(dtype, relu)
    x = np.random.RandomState(1).randn(2, 5, 48).astype(np.float32) * 3
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(dtype_of(dtype))
    act = 8.5 / 127.0 if static else None
    qj = quant_j.QuantizedDense(jd, act_scale=act)
    qt = quant_t.QuantizedDense(td, act_scale=act)
    ref = np.asarray(qj(xj).astype(jnp.float32))
    n0 = im_t.launches
    got = qt(xt)
    assert im_t.launches == n0
    assert got.dtype == xt.dtype and got.shape == (2, 5, 40)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol, atol=tol)
    if relu:
        assert float(got.min()) >= 0.0
    # simulate: the same int8 weights, dequantized, float product
    sj = quant_j.QuantizedDense(jd, act_scale=act, simulate=True)
    st = quant_t.QuantizedDense(td, act_scale=act, simulate=True)
    np.testing.assert_allclose(
        st(xt).float().numpy(), np.asarray(sj(xj).astype(jnp.float32)),
        rtol=max(tol, 2e-6), atol=max(tol, 2e-6))


def test_quantized_dense_refuses_other_activations():
    td = nn_t.Dense(8, in_units=4, activation="tanh")
    with pytest.raises(NotImplementedError, match="relu only"):
        quant_t.QuantizedDense(td)


def test_constant_keeps_its_value_through_initialize():
    tm = gpt_t.GPTForCausalLM(gpt_t.gpt_tiny_config(), device="cpu")
    tm.initialize(generator=torch.Generator().manual_seed(0))
    quant_t.quantize_block(tm)
    wq = tm.gpt.layers[0].attn.qkv.weight_q
    before = wq.detach().clone()
    assert wq.dtype == torch.int8 and not wq.requires_grad
    tm.initialize(generator=torch.Generator().manual_seed(1))
    assert torch.equal(wq, before)
    c = Constant("c", np.arange(6, dtype=np.int8).reshape(2, 3))
    assert c.dtype == torch.int8 and c.grad_req == "null"


def _kmajor_layers(model):
    return [(path, m) for path, m in model.named_modules()
            if isinstance(m, quant_t.QuantizedDense)]


def test_kmajor_weight_follows_weight_q():
    """The (O, K) K-major copy the card's wgmma route reads equals
    weight_q.T after quantize_block and again after load_named_arrays
    writes new int8 weights in place; it is a non-persistent buffer, so
    the parameter names and shapes stay the JAX QuantizedDense's."""
    jm = _jax_gpt()
    tm = _port_gpt(_arrays(jm))
    quant_j.quantize_block(jm)
    quant_t.quantize_block(tm)
    layers = _kmajor_layers(tm)
    assert len(layers) == 4 * 2
    for path, m in layers:
        wk = m.kmajor_weight()
        assert wk.dtype == torch.int8 and wk.is_contiguous()
        assert torch.equal(wk, m.weight_q.t()), path
        assert wk.data_ptr() == m.weight_q_k.data_ptr()
    params = tm.collect_params()
    assert not any("weight_q_k" in k for k in params)
    assert not any("weight_q_k" in k for k in tm.state_dict())
    ja = _arrays(jm)
    assert {k: tuple(p.shape) for k, p in params.items()} == \
        {k: a.shape for k, a in ja.items()}
    # new int8 weights written in place, by name
    rng = np.random.RandomState(4)
    new = {k: (rng.randint(-127, 128, a.shape).astype(np.int8)
               if k.endswith("weight_q") else a) for k, a in ja.items()}
    weights.load_named_arrays(tm, new)
    for path, m in layers:
        assert torch.equal(m.kmajor_weight(), m.weight_q.t()), path
        np.testing.assert_array_equal(
            m.kmajor_weight().numpy(), new[f"{path}.weight_q"].T)
    # the forward reads the new weights on the CPU too
    ids = np.random.RandomState(5).randint(0, _VOCAB, (2, 6)).astype(
        np.int32)
    for k, a in new.items():
        jm.collect_params()[k].set_data(NDArray(jnp.asarray(a)))
    np.testing.assert_allclose(
        tm(torch.from_numpy(ids)).detach().float().numpy(),
        np.asarray(jm(NDArray(jnp.asarray(ids)))._data).astype(np.float32),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_int8_matmul_plain_matches_jax_with_bf16_dynamic_scale(relu, bias):
    """The port's int8_matmul on the CPU (its plain version) against the
    JAX package's int8_matmul_reference with a bf16 0-d dynamic
    activation scale, as a bf16 model's QuantizedDense passes it: equal
    bit for bit (the bf16 scale widens exactly to float32 on both
    sides)."""
    from mxnet_tpu.pallas_ops.int8_matmul import int8_matmul_reference
    rng = np.random.RandomState(7)
    x = rng.randint(-127, 128, (5, 40)).astype(np.int8)
    w = rng.randint(-127, 128, (40, 24)).astype(np.int8)
    ws = (rng.rand(24) * 1e-2 + 1e-4).astype(np.float32)
    b = rng.randn(24).astype(np.float32) if bias else None
    xs_j = jnp.asarray(np.float32(0.0371)).astype(jnp.bfloat16)
    xs_t = torch.tensor(0.0371, dtype=torch.bfloat16)
    ref = np.asarray(int8_matmul_reference(
        jnp.asarray(x), jnp.asarray(w), xs_j, jnp.asarray(ws),
        bias=None if b is None else jnp.asarray(b), relu=relu))
    n0 = im_t.launches
    got = im_t.int8_matmul(
        torch.from_numpy(x), torch.from_numpy(w), xs_t, torch.from_numpy(ws),
        bias=None if b is None else torch.from_numpy(b), relu=relu,
        w_q_k=torch.from_numpy(np.ascontiguousarray(w.T)))
    assert im_t.launches == n0
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, _VOCAB, (n,)) \
        .astype(np.int32)


_PROMPTS = [(5, 3), (9, 4), (3, 5), (14, 6)]


def _serve(server_mod, model, **kw):
    srv = server_mod.Server(model, **kw)
    reqs = [srv.submit(_prompt(n, s), max_new_tokens=6) for n, s in _PROMPTS]
    srv.drain()
    out = [list(r.tokens) for r in reqs]
    assert all(r.verdict == "200 ok" for r in reqs)
    srv.stop()
    return out


@pytest.fixture(scope="module")
def quantized():
    """The int8 model and its simulate twin of each package, all four
    from the same float weights."""
    jm = _jax_gpt()
    arrays = _arrays(jm)
    quant_j.quantize_block(jm)
    js = _jax_gpt()
    quant_j.quantize_block(js, simulate=True)
    tq = quant_t.quantize_block(_port_gpt(arrays))
    ts = quant_t.quantize_block(_port_gpt(arrays), simulate=True)
    return jm, js, tq, ts


@pytest.mark.parametrize("pages", ["off", "on"])
def test_int8_server_matches_jax_and_the_simulate_twin(quantized, pages):
    """Each port server serves the JAX server's tokens. With pages off the
    int8 tokens also equal the simulate twin's (the JAX package's gate,
    `tests/unittest/test_serve.py`). With pages on a chunk round's
    dynamic activation scale spans the rows that run masked, so the int8
    tokens may leave the simulate twin's: here they do at one step, in
    the JAX package's paged server as in the port's."""
    jm, js, tq, ts = quantized
    kw = dict(slots=2, pages=pages)
    if pages == "on":
        kw.update(page_size=4, prefill_chunk=4)
    ref = _serve(serve_j, jm, **kw)
    n0 = im_t.launches
    got = _serve(serve, tq, **kw)
    assert im_t.launches == n0
    assert got == ref
    sim = _serve(serve, ts, **kw)
    assert sim == _serve(serve_j, js, **kw)
    if pages == "off":
        assert sim == got


def test_int8_generate_matches_jax(quantized):
    jm, _, tq, _ = quantized
    prompts = np.random.RandomState(2).randint(0, _VOCAB, (2, 7)) \
        .astype(np.int32)
    ref = jm.generate(prompts, max_new_tokens=5)
    got = tq.generate(prompts, max_new_tokens=5)
    np.testing.assert_array_equal(got, np.asarray(ref))
